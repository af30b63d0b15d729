"""The engine's JAX-only keywords and the serving harness's ENGINE=bf16.

`QueryEngine(use_pallas=..., pallas_tile_n=..., pallas_interpret=...)`, as
JAX's constructor takes them (`bench.py` passes `use_pallas`), constructs at
the values the port runs and refuses any other with a named reason.
ENGINE=bf16 of `benchmarks/serving_openloop.py` (the JAX harness's default:
a bfloat16 host index, whose `exact_rescore=32` the JAX engine drops) serves
through the port's `BatchedExecutor` equal to the JAX engine's
`query_batch` over the same bf16-rounded rows: indices exact, scores within
1e-5 (f32 sums in another order)."""

import ml_dtypes
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.benchmarks import serving_openloop
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.query.executor import BatchedExecutor
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

WAIT = 120  # seconds any one served request may take


@pytest.fixture(scope="module")
def small():
    return synthetic_setup(3000, 128, graph_degree=4)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=None), dict(use_pallas=True), dict(pallas_tile_n=2048),
    dict(pallas_interpret=True), dict(pallas_interpret=False),
    dict(use_pallas=True, pallas_tile_n=2048, pallas_interpret=True),
])
def test_jax_keywords_accepted_at_the_ports_values(small, kw):
    index, graph = small
    q = np.asarray(index.emb[:4], np.float32)
    want = QueryEngine(index, graph, device="cpu").query_batch(q, top_k=5)
    got = QueryEngine(index, graph, device="cpu", **kw).query_batch(q, top_k=5)
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_array_equal(got.top_scores, want.top_scores)


@pytest.mark.parametrize("kw,reason", [
    (dict(use_pallas=False), "kernels always"),
    (dict(pallas_tile_n=1024), "tile is fixed at 2048"),
    (dict(pallas_tile_n=4096, use_pallas=True), "tile is fixed at 2048"),
    (dict(bank_dtype="float16"), "bank_dtype"),
])
def test_other_values_refused_with_reason(small, kw, reason):
    index, graph = small
    with pytest.raises(ValueError, match=reason):
        QueryEngine(index, graph, device="cpu", **kw)


def test_bf16_bank_drops_the_rescore(small):
    index, graph = small
    eng = QueryEngine(index, graph, device="cpu", **serving_openloop.ENGINE_OPTIONS["bf16"])
    assert eng.d_emb.dtype == torch.bfloat16 and eng.exact_rescore == 0
    assert eng.d_emb_f32 is None
    cfg = eng.resolved_kernel_config(64, 10)
    assert cfg["select_bank"] == "bfloat16" and cfg["rescore_bank"] == ""


def test_harness_refuses_an_unknown_engine(monkeypatch):
    monkeypatch.setenv("ENGINE", "fp8")
    with pytest.raises(SystemExit, match="ENGINE must be one of"):
        serving_openloop.main(["--device", "cpu"])


def test_bf16_engine_serves_equal_to_jax():
    """20,000 x 384 with a degree-4 graph (the harness's CPU size), the
    harness's executor settings, 256 requests."""
    n, d = 20_000, 384
    tidx, tg = synthetic_setup(n, d, graph_degree=4)
    jidx, jg = _synthetic_setup(n, d, graph_degree=4)
    jidx.emb = np.asarray(jidx.emb, np.float32).astype(ml_dtypes.bfloat16)
    je = JaxEngine(jidx, jg, ell_max_degree=8, exact_rescore=32)
    te = QueryEngine(tidx, tg, ell_max_degree=8, device="cpu",
                     **serving_openloop.ENGINE_OPTIONS["bf16"])
    rng = np.random.default_rng(7)
    q = rng.standard_normal((256, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ex = BatchedExecutor(te, batch_size=1024, top_k=10, mode="retrieval",
                         batch_sizes=(128, 256, 1024), pipeline_depth=3, max_wait_ms=2.0)
    try:
        served = [f.result(timeout=WAIT) for f in ex.submit_many(q)]
    finally:
        ex.shutdown()
    want = je.query_batch(q, top_k=10)
    got_s = np.stack([s for s, _ in served])
    got_i = np.stack([i for _, i in served])
    np.testing.assert_array_equal(got_i, np.asarray(want.top_indices))
    np.testing.assert_allclose(got_s, np.asarray(want.top_scores), atol=1e-5, rtol=0)
