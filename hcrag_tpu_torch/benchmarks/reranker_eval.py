"""NDCG@10 of the judge-aware distilled re-ranker on held-out queries.

    python -m hcrag_tpu_torch.benchmarks.reranker_eval [--data DIR --pickle PKL]
    python -m hcrag_tpu_torch.benchmarks.reranker_eval --device cpu

Counterpart of `benchmarks/reranker_eval.py`.  The re-ranker (an MLP over
the judge-free metric stack) is distilled from the judge-inclusive blend
`0.7 * composite(sem, judge, ent, typ) + 0.3 * cos`, whose judge is the
reference's word-overlap heuristic (`overlap_fallback_scores`), then
ranked against that teacher on held-out queries.  The split is the JAX
script's: a `default_rng(0)` permutation of the index rows gives 400
training and 100 test rows; each query is its row's vector plus noise of
sigma 0.6 / sqrt(D), renormalized, with half the row's words as its text
(`default_rng(1)` and `(2)`); top_m 20 candidates; the `Reranker(hidden=64,
learning_rate=3e-3, seed=0)` trained 60 epochs.  The engine is the
default f32 engine (kernel B4 on the card), the re-ranker trains and
scores on the same device.

`--data` and `--pickle` take the place of the JAX script's hard-coded
reference paths (the AdventureWorks export and its embedding pickle,
`build_adventureworks(data, reference_pickle=pickle)`).  Without them the
script writes the seeded AdventureWorks-shaped corpus
(`testing.write_adventureworks_corpus`, 589 rows) into a temporary
directory, and as its pickle (`testing.write_golden_pairs`) the corpus's
texts with the vectors the build gives them without one (the hashing
embedder fitted on the texts).  It prints one JSON line: the JAX script's
entry (`ndcg10_cosine_order`, `ndcg10_baseline_combined`,
`ndcg10_reranked`, the top-1 agreements, `final_train_loss`, ...) and its
summary keys (`ndcg10_baseline`, `ndcg10_reranked`, `lift`), unrounded.
Nothing is written but `--out` and the temporary directory.
"""

from __future__ import annotations

import sys
import tempfile
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import device_name, device_of, finish, log, parser
from hcrag_tpu_torch.testing import seeded_corpus

TRAIN, TEST, TOP_M, NOISE, EPOCHS = 400, 100, 20, 0.6, 60


def _prep(texts, emb: np.ndarray, rows, seed: int):
    from hcrag_tpu_torch.ingest.entities import extract_entities_from_content, infer_query_intent

    prng = np.random.default_rng(seed)
    out = []
    for i in rows:
        words = texts[i].split()
        keep = max(3, len(words) // 2)
        sel = sorted(prng.choice(len(words), size=min(keep, len(words)), replace=False))
        out.append(" ".join(words[j] for j in sel))
    q = emb[rows] + NOISE * prng.standard_normal(
        (len(rows), emb.shape[1])).astype(np.float32) / np.sqrt(emb.shape[1])
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    return (out, q, [infer_query_intent(t) for t in out],
            [extract_entities_from_content(t) for t in out])


def evaluate(data: str, pickle: str, dev: torch.device) -> Dict:
    """The JAX script's experiment over `data` + `pickle` on `dev`."""
    from hcrag_tpu_torch.core.types import CompositeWeights, NodeInput, QueryInput
    from hcrag_tpu_torch.ingest.adventureworks import build_adventureworks
    from hcrag_tpu_torch.models.reranker import (
        Reranker,
        distill_judge_aware,
        engine_candidate_features,
        ndcg_at_k,
    )
    from hcrag_tpu_torch.pipeline.isrelevant import overlap_fallback_scores
    from hcrag_tpu_torch.query.engine import QueryEngine

    bundle = build_adventureworks(data, reference_pickle=pickle)
    engine = QueryEngine(bundle.index, bundle.graph, device=dev)
    texts = bundle.index.texts
    emb = np.asarray(bundle.index.emb, np.float32)
    order = np.random.default_rng(0).permutation(len(texts))
    train_rows, test_rows = order[:TRAIN], order[TRAIN:TRAIN + TEST]

    t0 = time.time()
    tr_texts, tr_q, tr_int, tr_ent = _prep(texts, emb, train_rows, seed=1)
    reranker = Reranker(hidden=64, learning_rate=3e-3, seed=0, device=dev)
    out = distill_judge_aware(engine, reranker, tr_texts, tr_q, intents=tr_int,
                              entity_lists=tr_ent, top_m=TOP_M, epochs=EPOCHS, seed=0)
    log(f"distilled in {time.time() - t0:.1f}s, loss {out['losses'][0]:.4f} -> "
        f"{out['losses'][-1]:.4f}")

    te_texts, te_q, te_int, te_ent = _prep(texts, emb, test_rows, seed=2)
    res = engine.query_batch(te_q, top_k=TOP_M, intents=te_int, entity_lists=te_ent)
    feats = engine_candidate_features(engine, res, intents=te_int, entity_lists=te_ent)
    w = CompositeWeights()
    judge = np.stack([
        np.asarray(overlap_fallback_scores(
            QueryInput(te_texts[i], None, [], None),
            [NodeInput(texts[int(j)], None, {}, "unknown", []) for j in res.top_indices[i]]),
            np.float32)
        for i in range(len(te_texts))])
    sem, _, ent, typ, cos = np.moveaxis(feats, -1, 0)
    teacher = 0.7 * (w.semantic_similarity * sem + w.llm_judge * judge
                     + w.entity_match * ent + w.node_type_priority * typ) + 0.3 * cos

    baseline_order = np.argsort(-res.combined, axis=1, kind="stable")
    rerank_order = np.argsort(-reranker.score(feats), axis=1, kind="stable")
    cosine_order = np.argsort(-res.top_scores, axis=1, kind="stable")
    top1_teacher = np.argmax(teacher, axis=1)
    ndcg_base = ndcg_at_k(baseline_order, teacher, 10)
    ndcg_rerank = ndcg_at_k(rerank_order, teacher, 10)
    return {
        "teacher": "0.7*composite(sem, judge, ent, typ) + 0.3*cos, judge = "
                   "reference word-overlap heuristic (isRelevant.py:288-297)",
        "train_queries": len(train_rows),
        "test_queries": len(test_rows),
        "candidates_per_query": TOP_M,
        "ndcg10_cosine_order": ndcg_at_k(cosine_order, teacher, 10),
        "ndcg10_baseline_combined": ndcg_base,
        "ndcg10_reranked": ndcg_rerank,
        "top1_agreement_baseline": float(np.mean(baseline_order[:, 0] == top1_teacher)),
        "top1_agreement_reranked": float(np.mean(rerank_order[:, 0] == top1_teacher)),
        "final_train_loss": float(out["losses"][-1]),
        "note": "judge-aware distillation: ordering approximates the judge-inclusive blend "
                "with zero query-time LLM calls",
        "ndcg10_baseline": ndcg_base,
        "lift": ndcg_rerank - ndcg_base,
        "rows": len(texts),
    }


def run(device: Union[str, torch.device, None] = "cuda", data: Optional[str] = None,
        pickle: Optional[str] = None) -> Dict:
    """The experiment over `data` + `pickle`, or over the seeded corpus
    written to a temporary directory when `data` is None."""
    dev = device_of(device)
    if data is None:
        if pickle is not None:
            raise ValueError("--pickle needs --data")
        with tempfile.TemporaryDirectory() as tmp:
            res = evaluate(*seeded_corpus(tmp), dev)
    else:
        if pickle is None:
            raise ValueError("--data needs --pickle (the index's embeddings)")
        res = evaluate(data, pickle, dev)
    res["device"] = device_name(dev)
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--data", default=None, help="the AdventureWorks export (reference layout)")
    p.add_argument("--pickle", default=None, help="its embedding pickle")
    args = p.parse_args(argv)
    finish(run(args.device, args.data, args.pickle), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
