"""The PyTorch port's QueryEngine against the JAX QueryEngine, both in the
int8-select + f32-rescore mode, on the same seeded synthetic index and
graph (n=4096, d=128, B=8, top_k=10, depth 1, graph degree 4).

Tolerances: indices and expansion are exact; scores agree to atol 1e-5
because the f32 dot products and metric sums are taken in another order."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.core.types import ScorerType as JaxScorer
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.core.types import QueryIntent, ScorerType
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D, B, K = 4096, 128, 8, 10
MODE = dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True,
            ell_max_degree=8)


@pytest.fixture(scope="module")
def engines():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    je = JaxEngine(jidx, jg, pallas_interpret=True, **MODE)
    te = QueryEngine(tidx, tg, device="cpu", select_lane_t=1, **MODE)
    return je, te, np.asarray(tidx.emb, np.float32)


def _queries(seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ents = [[f"e{x}" for x in rng.integers(0, 128, size=3)] + ["not_in_vocab"]
            for _ in range(B)]
    ents[0] = []  # empty entity set: the 0.5 / 0.1 rule
    dyn = rng.random((4, 5, 6)).astype(np.float32)
    return q, ents, dyn


def _case(name):
    q, ents, dyn = _queries()
    if name == "plain":
        return q, {}, {}
    if name == "entities_intents":
        return (
            q,
            dict(entity_lists=ents, intents=[list(JaxIntent)[i % 5] for i in range(B)]),
            dict(entity_lists=ents, intents=[list(QueryIntent)[i % 5] for i in range(B)]),
        )
    if name == "dynamic_weights":
        return (
            q,
            dict(entity_lists=ents, dynamic_weight_tensor=dyn),
            dict(entity_lists=ents, dynamic_weight_tensor=dyn),
        )
    if name == "parallel_scorer":
        return q, dict(scorer_type=JaxScorer.PARALLEL), dict(scorer_type=ScorerType.PARALLEL)
    raise KeyError(name)


@pytest.mark.parametrize(
    "case", ["plain", "entities_intents", "dynamic_weights", "parallel_scorer"]
)
def test_step_matches_jax_engine(engines, case):
    je, te, emb = engines
    q, jkw, tkw = _case(case)
    rj = je.query_batch(q, top_k=K, expansion_depth=1, **jkw)
    rt = te.query_batch(q, top_k=K, expansion_depth=1, **tkw)
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    for field in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(
            getattr(rt, field), getattr(rj, field), atol=1e-5, rtol=0, err_msg=field
        )
    # The retrieved set is the f32 brute-force top-k.
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    for b in range(B):
        brute = np.argsort(-(emb @ qn[b]), kind="stable")[:K]
        assert set(rt.top_indices[b].tolist()) == set(brute.tolist())


def test_device_tensor_input_matches_host_input(engines):
    _, te, _ = engines
    q, _, _ = _queries(seed=8)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    host = te.query_batch(q, top_k=K)
    dev = te.query_batch_device(torch.from_numpy(qn), top_k=K)
    np.testing.assert_array_equal(dev[1].numpy(), host.top_indices)
    np.testing.assert_array_equal(dev[0].numpy(), host.top_scores)


def test_resolved_kernel_config(engines):
    _, te, _ = engines
    c = te.resolved_kernel_config(batch=B, top_k=K)
    # 2 tiles x 10 < 32: each tile picks 16, and the 32-candidate pool is
    # merged by the stable sort.
    assert c["tile_k"] == 16 and c["merge"] == "stable_sort"
    assert c["kernel"] == "int8_tile_topk_plain" and c["rescore_bank"] == "f32"
    assert c["merge_k"] == 32 and c["tile_n"] == 2048 and c["lane_t"] == 0


@pytest.mark.parametrize("lane_t", [2, 4])
def test_select_lane_t_other_than_exact_raises(lane_t):
    """B1 selects every tile exactly: only lane depths 0 and 1 mean that."""
    index, graph = synthetic_setup(256, 64)
    with pytest.raises(ValueError, match="select_lane_t"):
        QueryEngine(index, graph, device="cpu", select_lane_t=lane_t, **MODE)


def test_category_filter_with_fillers_matches_jax(engines):
    """A filter that leaves 9 rows for top_k=10: the last slot is a filler
    (index -1, score -1e30) on both sides; its gathers read the last row,
    as the JAX step's negative-index wrap does."""
    je, te, _ = engines
    q, ents, _ = _queries(seed=9)
    originals = [(e.index, [dict(m) for m in e.index.metadata]) for e in (je, te)]
    try:
        for e in (je, te):
            for r, m in enumerate(e.index.metadata):
                m["type"] = "json_table" if r % 500 == 0 else "database_table"
        rj = je.query_batch(q, top_k=K, category_filter="json_table", entity_lists=ents)
        rt = te.query_batch(q, top_k=K, category_filter="json_table", entity_lists=ents)
    finally:
        for index, meta in originals:
            index.metadata = meta
    assert (rt.top_indices[:, -1] == -1).all() and (rt.top_indices[:, :-1] % 500 == 0).all()
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    real = rt.top_indices >= 0
    for field in ("top_scores", "relevance", "combined"):
        a, b = getattr(rt, field), getattr(rj, field)
        np.testing.assert_allclose(a[real], b[real], atol=1e-5, rtol=0, err_msg=field)
        assert (a[~real] < -1e29).all() and (b[~real] < -1e29).all(), field
    np.testing.assert_allclose(rt.expanded_relevance, rj.expanded_relevance,
                               atol=1e-5, rtol=0)
