"""Behavioral parity of the port's build, retrieval, scoring and agent with
the reference, in one command.

    python -m hcrag_tpu_torch.tools.verify_parity [--data DIR --pickle PKL]
    python -m hcrag_tpu_torch.tools.verify_parity --device cpu

Counterpart of `tools/verify_parity.py`, with its sections and check lines:

  * retrieval: 32 index rows and 32 Gaussian queries (`default_rng(123)`),
    each through `query_batch(q, top_k=10)` of the default engine over the
    AdventureWorks build (kernel B4 on the card), against the stable
    float brute force: the same sets of 10;
  * ingestion: the CSV rows' texts byte-identical to the pickle's, the
    JSON and PDF texts byte-identical by id;
  * the graph schema's node counts and its 7 edge types;
  * the COMPOSITE and PARALLEL formulas of `batch_isRelevant` re-derived
    in numpy on the sample query and nodes; the thresholds and default
    weights;
  * the seeded agent (`agent_trace_fixture`): its traces hold the
    reference's invariants.

`--data` and `--pickle` take the place of the JAX tool's reference paths.
Without them the tool writes the seeded corpus and its pickle
(`testing.seeded_corpus`) into a temporary directory.  Two checks need the
reference export itself: that its 585 ids are covered, and that the traces
equal the committed `tools/agent_trace_fixture.json` (written from the
585-row index).  The tool makes them when the pickle holds the export's
585 rows; otherwise it says it skipped them, and checks in their place that
the traces equal a fixture it regenerates on the same device.  It exits 0
when every check passes, else 1, as JAX's.
"""

from __future__ import annotations

import argparse
import json
import pickle as pickle_mod
import sys
import tempfile

import numpy as np

from hcrag_tpu_torch.device import resolve_device

#: Rows of the reference export's index (the committed fixture's source).
REFERENCE_ROWS = 585


def check(name, ok, detail=""):
    print(f"  [{'PASS' if ok else 'FAIL'}] {name} {detail}")
    return bool(ok)


def skip(name, why):
    print(f"  [SKIP] {name} ({why})")


def run(data: str, pickle: str, device) -> bool:
    """Every section over `data` and `pickle` on `device`; True when every
    check passed."""
    from hcrag_tpu_torch import config as cfg
    from hcrag_tpu_torch.core.types import (
        PRIORITY_MATRIX, CompositeWeights, ScorerType, node_type_id,
    )
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks, process_corpus
    from hcrag_tpu_torch.pipeline.isrelevant import batch_isRelevant, overlap_fallback_scores
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.testing import create_sample_nodes, create_sample_query
    from hcrag_tpu_torch.tools import agent_trace_fixture as atf

    ok = True
    with open(pickle, "rb") as f:
        ref = pickle_mod.load(f)
    emb = np.asarray(ref["embeddings"], np.float32)
    reference = len(emb) == REFERENCE_ROWS

    print("== retrieval parity (vs reference brute-force cosine) ==")
    bundle = build_adventureworks(data, reference_pickle=pickle)
    engine = QueryEngine(bundle.index, bundle.graph, device=device)
    rng = np.random.default_rng(123)
    queries = np.concatenate(
        [emb[rng.integers(0, len(emb), 32)],
         rng.standard_normal((32, emb.shape[1])).astype(np.float32)]
    )
    en = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    exact = 0
    for q in queries:
        qn = q / np.linalg.norm(q)
        ref_top = set(np.argsort(-(en @ qn), kind="stable")[:10].tolist())
        got = set(engine.query_batch(q, top_k=10).top_indices[0].tolist())
        exact += got == ref_top
    ok &= check("recall@10 exact-set match", exact == len(queries),
                f"({exact}/{len(queries)} queries)")

    print("== ingestion parity (text representations) ==")
    texts, metadata = process_corpus(data)
    same = sum(
        t == rt
        for t, rt, m in zip(texts, ref["texts"], ref["metadata"])
        if m.get("type") == "database_table"
    )
    total = sum(1 for m in ref["metadata"] if m.get("type") == "database_table")
    ok &= check("CSV row texts byte-identical", same == total, f"({same}/{total})")
    # The pickle's row order of JSON and PDF rows follows a directory
    # listing; their ids do not, so compare by id.
    ref_by_id = {m["id"]: t for t, m in zip(ref["texts"], ref["metadata"])}
    for typ in ("json_table", "pdf_document"):
        rows = [(m["id"], t) for t, m in zip(texts, metadata) if m.get("type") == typ]
        n_same = sum(ref_by_id.get(i) == t for i, t in rows)
        n_total = sum(1 for m in ref["metadata"] if m.get("type") == typ)
        ok &= check(f"{typ} texts byte-identical (by id)",
                    n_same == n_total == len(rows), f"({n_same}/{n_total})")
    if reference:
        ok &= check("all 585 ids covered", {m["id"] for m in metadata} == set(ref_by_id),
                    f"({len(metadata)} rows)")
    else:
        skip("all 585 ids covered", f"the pickle holds {len(emb)} rows, not the reference export")

    print("== graph schema ==")
    stats = bundle.graph.statistics()
    ok &= check("node counts", stats["nodes"] == {
        "Product": 100, "Category": 41, "Document": 4, "Annotation": 9})
    ok &= check("all 7 edge types present",
                len(stats["relationships"]) == 7, str(stats["relationships"]))

    print("== scoring parity (reference formulas re-derived in NumPy) ==")
    q = create_sample_query()
    nodes = create_sample_nodes()
    sem = [((q.embeddings @ n_.embeddings)
            / (np.linalg.norm(q.embeddings) * np.linalg.norm(n_.embeddings)) + 1) / 2
           for n_ in nodes]
    qset = set(q.entities)
    ent = [(0.5 if not set(n_.entities) else 0.1) if not qset
           else len(qset & set(n_.entities)) / len(qset) for n_ in nodes]
    typ = [PRIORITY_MATRIX[q.intent.index, node_type_id(n_.node_type)] for n_ in nodes]
    llm = overlap_fallback_scores(q, nodes)
    w = CompositeWeights()
    expected = [
        w.semantic_similarity * s + w.llm_judge * l + w.entity_match * e
        + w.node_type_priority * t
        for s, l, e, t in zip(sem, llm, ent, typ)
    ]
    got = batch_isRelevant(q, nodes, ScorerType.COMPOSITE, device=device)
    ok &= check("COMPOSITE formula", np.allclose(got, expected, atol=1e-5))
    got_par = batch_isRelevant(q, nodes, ScorerType.PARALLEL, device=device)
    exp_par = [max(s, l, e, t) for s, l, e, t in zip(sem, llm, ent, typ)]
    ok &= check("PARALLEL formula", np.allclose(got_par, exp_par, atol=1e-5))

    print("== constants ==")
    ok &= check("thresholds", (cfg.SEMANTIC_GATE, cfg.HIGH_RELEVANCE, cfg.FINAL_TOP_K,
                               cfg.SAMPLE_LIMIT, cfg.MAX_CONNECTED_NODES)
                == (0.60, 0.7, 15, 20, 20))
    ok &= check("weights default",
                CompositeWeights().as_array().tolist()
                == [np.float32(0.3), np.float32(0.45), np.float32(0.15), np.float32(0.1)])

    print("== agent (seeded trace vs fixture) ==")
    traces = atf.run_traces(data, pickle, device)
    if reference:
        with open(atf.COMMITTED_FIXTURE) as f:
            fixture = json.load(f)
        name = "deterministic replay == fixture"
    else:
        skip("deterministic replay == fixture",
             "the committed fixture comes from the reference export's 585 rows")
        fixture = json.loads(json.dumps(atf.run_traces(data, pickle, device)))
        name = "deterministic replay == regenerated fixture"
    for q_ in atf.differing(traces, fixture):
        print(f"    differs: {q_!r}")
    ok &= check(name, traces == fixture,
                f"({len([k for k in fixture if not k.startswith('_')])} seeded questions)")
    problems = atf.check_invariants(traces)
    ok &= check("reference wiring/threshold invariants", not problems,
                "" if not problems else str(problems[:3]))
    return ok


def main(argv=None) -> int:
    """Run every section; returns the exit code (0: every check passed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None, help="the AdventureWorks export (CSV + documents)")
    ap.add_argument("--pickle", default=None, help="its embedding pickle")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from hcrag_tpu_torch.tools.agent_trace_fixture import sources

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        ok = run(*sources(args.data, args.pickle, tmp), dev)
    print("\nOVERALL:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
