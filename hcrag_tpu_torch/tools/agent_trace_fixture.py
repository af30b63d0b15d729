"""The seeded agent's traces: write them as a fixture, or check them against one.

    python -m hcrag_tpu_torch.tools.agent_trace_fixture [--data DIR --pickle PKL] [--out FILE]
    python -m hcrag_tpu_torch.tools.agent_trace_fixture --check --fixture FILE
    ... --device cpu

Counterpart of `tools/agent_trace_fixture.py`.  The evaluate/revise agent
(`pipeline/agent.py`) runs over the default engine of the AdventureWorks
build (`build_adventureworks(data, reference_pickle=pickle)`; kernel B4 on
the card) with `RuntimeConfig(random_seed=SEED)` and the offline LLM
client, on each of `QUESTIONS`, and each node's state is recorded: node
order, sampled nodes, the semantic gate's survivors and their scores,
expansion and final counts, final scores, decision, revisions; then the
final node keys and the answer's head.  `check_invariants` holds every
trace to the reference's wiring and thresholds.

`--data` and `--pickle` take the place of the JAX tool's reference paths.
Without them the tool writes the seeded corpus and its pickle
(`testing.seeded_corpus`) into a temporary directory.  The fixture that
`tools/agent_trace_fixture.json` commits comes from the reference export's
585-row index, so it matches only traces over that export.

Without `--check` the tool writes the traces to `--out` (by default under
the gitignored `hcrag_tpu_torch/_trained/`; never under `tools/`) once the
invariants hold; with `--check` it compares them with `--fixture`.  The
exit code is 0 or 1, as JAX's.  The rounded scores may differ from a
fixture written on another backend by its numerics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

from hcrag_tpu_torch.device import resolve_device

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The committed fixture of the JAX package, from the reference export.
COMMITTED_FIXTURE = os.path.join(os.path.dirname(PACKAGE), "tools", "agent_trace_fixture.json")
DEFAULT_OUT = os.path.join(PACKAGE, "_trained", "agent_trace_fixture.json")

#: Questions chosen to exercise both terminal decisions: a well-supported
#: product query (sufficient on the first pass) and an absurd one (drives
#: the revision loop into the >=2-revision guard).
QUESTIONS = [
    "What mountain bikes are available?",
    "Which documents describe the HL Road Frame?",
    "zzz quantum blockchain weather on mars",
]
SEED = 42


def run_traces(data: str, pickle: str, device=None) -> dict:
    """The seeded traces of `QUESTIONS` over the engine of the build of
    `data` with `pickle`'s vectors, on `device` (CUDA unless named), and
    the invariant constants."""
    from hcrag_tpu_torch import config as cfg
    from hcrag_tpu_torch.config import RuntimeConfig
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.pipeline.agent import RetrievalAgent
    from hcrag_tpu_torch.query.engine import QueryEngine

    bundle = build_adventureworks(data, reference_pickle=pickle)
    engine = QueryEngine(bundle.index, bundle.graph, device=resolve_device(device))
    traces = {}
    for q in QUESTIONS:
        agent = RetrievalAgent(engine, config=RuntimeConfig(random_seed=SEED))
        steps = []

        def on_step(node, state):
            steps.append({
                "node": node,
                "question": state["question"],
                "n_sampled": len(state.get("sampled_nodes", [])),
                "sampled": list(map(int, state.get("sampled_nodes", []))),
                "n_semantic": len(state.get("semantic_scored_nodes", [])),
                "semantic_scores": [
                    round(float(n.score), 6)
                    for n in state.get("semantic_scored_nodes", [])
                ],
                "n_expanded": len(state.get("expanded_nodes", [])),
                "n_final": len(state.get("final_relevant_nodes", [])),
                "final_scores": [
                    round(float(n.score), 6)
                    for n in state.get("final_relevant_nodes", [])
                ],
                "decision": state.get("decision", ""),
                "n_revisions": len(state.get("revision_history", [])),
            })

        result = agent.run(q, on_step=on_step)
        traces[q] = {
            "seed": SEED,
            "node_trace": result.node_trace,
            "steps": steps,
            "decision": result.decision,
            "revision_history": result.revision_history,
            "final_node_keys": [
                str(n.graph_relations.get("key", ""))
                for n in result.final_relevant_nodes
            ],
            "answer_head": result.final_answer[:160],
        }
    traces["_invariants"] = {
        "semantic_gate": cfg.SEMANTIC_GATE,
        "final_top_k": cfg.FINAL_TOP_K,
        "sample_limit": cfg.SAMPLE_LIMIT,
        "max_revisions": cfg.MAX_REVISIONS,
        "expansion_neighbor_limit": cfg.EXPANSION_NEIGHBOR_LIMIT,
        "reference_wiring": "neo4j_rag_langgraph.py:801-838",
    }
    return traces


def check_invariants(traces) -> List[str]:
    """Reference-semantics checks every trace must satisfy
    (neo4j_rag_langgraph.py:420,460,601,637)."""
    inv = traces["_invariants"]
    problems = []
    for q, t in traces.items():
        if q.startswith("_"):
            continue
        expected_prefix = [
            "analyze_query", "sample_nodes", "score_semantic_similarity",
            "expand_subgraph", "score_all_nodes_with_isrelevant",
            "evaluate_context",
        ]
        if t["node_trace"][:6] != expected_prefix:
            problems.append(f"{q}: wiring prefix {t['node_trace'][:6]}")
        if t["node_trace"][-1] != "generate_answer":
            problems.append(f"{q}: did not end in generate_answer")
        for s in t["steps"]:
            if s["n_sampled"] > inv["sample_limit"]:
                problems.append(f"{q}: sampled {s['n_sampled']} > limit")
            # the gate holds AT the semantic step; later steps overwrite
            # .score with isRelevant values
            if s["node"] == "score_semantic_similarity" and any(
                x < inv["semantic_gate"] for x in s["semantic_scores"]
            ):
                problems.append(f"{q}: semantic gate violated")
            if s["n_final"] > inv["final_top_k"]:
                problems.append(f"{q}: final {s['n_final']} > top-15")
            if s["final_scores"] != sorted(s["final_scores"], reverse=True):
                problems.append(f"{q}: final nodes not sorted desc")
            if s["n_revisions"] > inv["max_revisions"] + 1:
                problems.append(f"{q}: revision guard breached")
        if not t["answer_head"]:
            problems.append(f"{q}: empty answer")
    return problems


def differing(traces: dict, fixture: dict) -> List[str]:
    """The fixture's entries that `traces` does not reproduce."""
    return [q for q in fixture if traces.get(q) != fixture[q]]


def sources(data: Optional[str], pickle: Optional[str], tmp: str):
    """(data, pickle): the ones given, else the seeded corpus under `tmp`."""
    from hcrag_tpu_torch.testing import seeded_corpus

    if (data is None) != (pickle is None):
        raise ValueError("--data and --pickle go together")
    return (data, pickle) if data is not None else seeded_corpus(tmp)


def main(argv=None) -> int:
    """Write or check the traces; returns the exit code (0 or 1)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None, help="the AdventureWorks export (CSV + documents)")
    ap.add_argument("--pickle", default=None, help="its embedding pickle")
    ap.add_argument("--check", action="store_true", help="compare with --fixture")
    ap.add_argument("--fixture", default=COMMITTED_FIXTURE, help="the fixture --check reads")
    ap.add_argument("--out", default=DEFAULT_OUT, help="where the fixture is written")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        traces = run_traces(*sources(args.data, args.pickle, tmp), device=dev)
    problems = check_invariants(traces)
    if args.check:
        with open(args.fixture) as f:
            fixture = json.load(f)
        match = traces == fixture
        print(f"deterministic replay matches fixture: {match}")
        for q in differing(traces, fixture):
            print(f"  DIFFERS: {q}")
        print(f"invariant violations: {problems or 'none'}")
        return 0 if match and not problems else 1
    if problems:
        print("invariant violations:", problems)
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(traces, f, indent=1)
    print(f"wrote {args.out}: {len(QUESTIONS)} seeded traces, invariants ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
