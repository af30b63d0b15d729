"""The selection route without a kernel, which answers top_k above 128,
against the JAX package on the CPU.

  * `ops/similarity.py` (`cosine_scores`, `normalized_cosine`,
    `fast_top_k`, `chunked_top_k`, `dense_top_k`, `threshold_mask`,
    `masked_top_k`, `streaming_masked_top_k`) and
    `ops/quantize.streaming_quantized_top_k` against their JAX
    counterparts on numpy-seeded inputs: indices equal, values within 1e-6
    (the port sums its dots in float64, JAX in float32).  The streaming
    variants run with small chunks, so several chunks and a ragged last one
    are merged.
  * The port's QueryEngine against the JAX engine on its CPU route
    (`masked_top_k` after the dense product; n=600, d=64, B=4, depth 1) at
    top_k 129, 300 and n, in the f32 default, `exact_rescore=32` and
    `quantize_int8=True, int8_rescore=32`, each with and without a category
    filter that leaves 200 rows: scores, relevance and combined within 1e-5
    and fill slots equal (-inf in the f32 mode, -1e30 after a rescore).
    Indices are equal, except that two rows whose JAX scores lie within
    1e-6 of each other may trade places: the rescore's f32 sums are taken
    in another order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.ops import quantize as jq
from hcrag_tpu.ops import similarity as js
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.ops import quantize as tq
from hcrag_tpu_torch.ops import similarity as ts
from hcrag_tpu_torch.ops import topk_cuda
from hcrag_tpu_torch.query import engine as engine_mod
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup

N, D, B = 600, 64, 4


def _rows(rng, n, d, dtype=np.float32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x


def _t(a):
    """A torch tensor of a numpy array (bfloat16 through its bits)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_top_equal(got, want, atol=1e-6):
    (gv, gi), (wv, wi) = got, want
    gv, gi = gv.numpy(), gi.numpy()
    wv, wi = np.asarray(wv), np.asarray(wi)
    assert gi.dtype == np.int32
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], atol=atol, rtol=0)
    np.testing.assert_array_equal(gv[~fin], wv[~fin])


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_scores_matches_jax(normalized, dtype):
    rng = np.random.default_rng(1)
    e = _rows(rng, 300, D, np.float32 if dtype == "float32" else jnp.bfloat16)
    if not normalized:
        e = (e.astype(np.float32) * 3.0).astype(e.dtype)
    q = rng.standard_normal((B, D)).astype(np.float32) * 2.0
    want = np.asarray(js.cosine_scores(jnp.asarray(q), jnp.asarray(e),
                                       index_normalized=normalized))
    got = ts.cosine_scores(_t(q), _t(e), index_normalized=normalized)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.normalized_cosine(got).numpy(),
                               np.asarray(js.normalized_cosine(jnp.asarray(want))),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts.threshold_mask(_t(want), 0.1).numpy(),
                                  np.asarray(js.threshold_mask(jnp.asarray(want), 0.1)))


def _tied_scores(seed, b, n):
    """Scores on a grid of 1/8 with many ties, and a few -inf."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-8, 8, size=(b, n)).astype(np.float32) / 8
    s[rng.random((b, n)) < 0.1] = -np.inf
    return s


@pytest.mark.parametrize("k", [1, 129, 300])
def test_fast_top_k_ties_to_lowest_index(k):
    s = _tied_scores(2, B, 1000)
    _assert_top_equal(ts.fast_top_k(_t(s), k), js.fast_top_k(jnp.asarray(s), k), atol=0)


@pytest.mark.parametrize("n, k, chunk", [(1000, 20, 64), (1000, 150, 256), (5000, 129, 512),
                                         (300, 129, 64), (1000, 200, 16384)])
def test_chunked_top_k_matches_jax(n, k, chunk):
    s = _tied_scores(3, B, n)
    _assert_top_equal(ts.chunked_top_k(_t(s), k, chunk),
                      js.chunked_top_k(jnp.asarray(s), k, chunk), atol=0)


@pytest.mark.parametrize("k", [10, 129, 300])
def test_dense_top_k_matches_jax(k):
    rng = np.random.default_rng(4)
    e = _rows(rng, 500, D)
    q = rng.standard_normal((B, D)).astype(np.float32)
    _assert_top_equal(ts.dense_top_k(_t(q), _t(e), k),
                      js.dense_top_k(jnp.asarray(q), jnp.asarray(e), k))


@pytest.mark.parametrize("valid_share", [1.0, 0.5, 0.1])
def test_masked_top_k_matches_jax(valid_share):
    """With 10% of 1000 rows valid, k=300 ends in -inf slots that hold the
    lowest filtered rows, as `lax.top_k` orders them."""
    s = _tied_scores(5, B, 1000)
    mask = np.random.default_rng(6).random(1000) < valid_share
    _assert_top_equal(ts.masked_top_k(_t(s), _t(mask), 300),
                      js.masked_top_k(jnp.asarray(s), jnp.asarray(mask), 300), atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n, k, chunk_rows", [(1000, 150, 192), (1000, 129, 1000),
                                              (700, 200, 256), (300, 129, 130)])
def test_streaming_masked_top_k_matches_jax(dtype, n, k, chunk_rows):
    rng = np.random.default_rng(7)
    e = _rows(rng, n, D, np.float32 if dtype == "float32" else jnp.bfloat16)
    q = _rows(rng, B, D)
    mask = rng.random(n) < 0.6
    want = js.streaming_masked_top_k(jnp.asarray(q), jnp.asarray(e), jnp.asarray(mask), k,
                                     chunk_rows=chunk_rows)
    got = ts.streaming_masked_top_k(_t(q), _t(e), _t(mask), k, chunk_rows=chunk_rows)
    _assert_top_equal(got, want)


@pytest.mark.parametrize("n, k, chunk_rows", [(1000, 150, 192), (700, 200, 256),
                                              (300, 129, 130)])
def test_streaming_quantized_top_k_matches_jax(n, k, chunk_rows):
    """Under jit, as the JAX engine runs it: the query scale is then
    absmax * (1/127) (`quantize.INV_127`)."""
    rng = np.random.default_rng(8)
    e = _rows(rng, n, D)
    e8, es = jq.quantize_rows(e)
    q = _rows(rng, B, D)
    mask = rng.random(n) < 0.6
    fn = jax.jit(jq.streaming_quantized_top_k, static_argnames=("k", "chunk_rows"))
    want = fn(jnp.asarray(q), jnp.asarray(e8), jnp.asarray(es), jnp.asarray(mask),
              k=k, chunk_rows=chunk_rows)
    got = tq.streaming_quantized_top_k(_t(q), _t(e8), _t(es), _t(mask), k,
                                       chunk_rows=chunk_rows)
    _assert_top_equal(got, want)


def test_streaming_equals_dense_route():
    """One chunk or many, the streaming route returns the dense route's
    answer: the chunks merge position-stably."""
    rng = np.random.default_rng(9)
    e = _rows(rng, 1000, D)
    q = _rows(rng, B, D)
    mask = _t(rng.random(1000) < 0.3)
    dense = ts.masked_top_k(ts.dots(_t(q), _t(e)), mask, 400)
    for chunk_rows in (64, 333, 1000):  # chunks smaller than k too
        v, i = ts.streaming_masked_top_k(_t(q), _t(e), mask, 400, chunk_rows=chunk_rows)
        assert torch.equal(i, dense[1]) and torch.equal(v, dense[0])


def test_per_tile_limit_names_top_k():
    with pytest.raises(ValueError, match=r"top_k=300: .* at most 128"):
        topk_cuda.cosine_top_k(torch.zeros(1, D), torch.zeros(2048, D),
                               torch.ones(2048, dtype=torch.bool), 300)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
MODES = {
    "f32": dict(),
    "rescore": dict(exact_rescore=32),
    "int8": dict(quantize_int8=True, int8_rescore=32),
}


def _filtered(index):
    meta = [dict(m, type="json_table" if r % 3 == 0 else "database_table")
            for r, m in enumerate(index.metadata)]
    return dataclasses.replace(index, metadata=meta)


@pytest.fixture(scope="module")
def engines():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    jidx, tidx = _filtered(jidx), _filtered(tidx)
    return {mode: (JaxEngine(jidx, jg, ell_max_degree=8, **opts),
                   QueryEngine(tidx, tg, device="cpu", ell_max_degree=8, **opts))
            for mode, opts in MODES.items()}


def _engine_queries():
    """Row 0 of the index (the query of the fault's report) and three
    seeded normal queries."""
    jidx, _ = _synthetic_setup(N, D, graph_degree=4)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q[0] = np.asarray(jidx.emb[0], np.float32)
    return q


def _jax_row_scores(te, q, mode):
    """The f32 score of every row [B, N] as the engine's last stage ranks
    it: the dot with the f32 rows, or with their bf16 copy, which the int8
    mode rescores from."""
    emb = np.asarray(te.index.emb, np.float32)
    if mode == "int8":
        emb = np.asarray(jnp.asarray(emb).astype(jnp.bfloat16), np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)) @ emb.T


def assert_large_k_equal(rt, rj, row_scores=None):
    """Scores within 1e-5 and fill slots equal; indices equal, or else a
    trade of places between rows whose scores (`row_scores` [B, N], the
    exact f32 dots) lie within 1e-6 of each other."""
    real = rj.top_scores > -1e29
    np.testing.assert_array_equal(rt.top_scores > -1e29, real)
    np.testing.assert_array_equal(rt.top_scores[~real], rj.top_scores[~real])
    np.testing.assert_array_equal(rt.top_indices[~real], rj.top_indices[~real])
    for field in ("top_scores", "relevance", "combined"):
        a, b = getattr(rt, field), getattr(rj, field)
        np.testing.assert_allclose(a[real], b[real], atol=1e-5, rtol=0, err_msg=field)
    moved = rt.top_indices != rj.top_indices
    if moved.any():
        assert row_scores is not None, np.argwhere(moved)
        rows = np.nonzero(moved)[0]
        got = row_scores[rows, rt.top_indices[moved]]
        want = row_scores[rows, rj.top_indices[moved]]
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        for field in ("expanded_nodes", "expanded_counts"):
            np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field))
        np.testing.assert_allclose(rt.expanded_relevance, rj.expanded_relevance,
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("top_k", [129, 300, N])
@pytest.mark.parametrize("category", [None, "json_table"])
def test_engine_large_k_matches_jax(engines, mode, top_k, category):
    je, te = engines[mode]
    q = _engine_queries()
    rj = je.query_batch(q, top_k=top_k, category_filter=category)
    rt = te.query_batch(q, top_k=top_k, category_filter=category)
    assert rt.top_indices.shape == (B, top_k)
    assert_large_k_equal(rt, rj, _jax_row_scores(te, q, mode))
    fill = rt.top_scores[rt.top_scores < -1e29]
    if category is not None and top_k > N // 3:
        assert fill.size and (fill == (-np.inf if mode == "f32" else -1e30)).all()


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streaming_route_matches_jax(engines, mode, monkeypatch):
    """The engine's streaming branch (past 2^18 rows), with the threshold
    lowered to 256 rows and chunks of 320 rows (one whole and a ragged
    second), against the JAX engine's dense route."""
    je, te = engines[mode]
    monkeypatch.setattr(engine_mod, "STREAMING_MIN_ROWS", 256)
    for name, fn in (("streaming_masked_top_k", ts.streaming_masked_top_k),
                     ("streaming_quantized_top_k", tq.streaming_quantized_top_k)):
        monkeypatch.setattr(engine_mod, name, functools.partial(fn, chunk_rows=320))
    q = _engine_queries()
    rj = je.query_batch(q, top_k=300, category_filter="json_table")
    rt = te.query_batch(q, top_k=300, category_filter="json_table")
    assert_large_k_equal(rt, rj, _jax_row_scores(te, q, mode))
    assert te.resolved_kernel_config(B, 300)["kernel"].startswith("streaming_")


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_reports_the_route(engines, mode):
    _, te = engines[mode]
    c = te.resolved_kernel_config(B, 129)
    want = "quantized_scores+masked_top_k" if mode == "int8" else "masked_top_k"
    assert (c["kernel"], c["merge"], c["tile_n"], c["super_tiles"]) == (want, "none", 0, 1)
    assert te.resolved_kernel_config(B, 128)["kernel"].endswith("_plain")


@pytest.mark.parametrize("mode", list(MODES))
def test_route_calls_no_selection_kernel(engines, mode, monkeypatch):
    """Past 128 candidates the engine calls neither fused selection (and so
    none of kernels B1, B2, B4, B5, B7): the oversample m = max(top_k,
    rescore) decides, so top_k = 129 leaves the kernels in every mode."""
    _, te = engines[mode]

    def refuse(*args, **kwargs):
        raise AssertionError("a selection kernel's wrapper was called")

    monkeypatch.setattr(engine_mod, "cosine_top_k", refuse)
    monkeypatch.setattr(engine_mod, "cosine_top_k_int8", refuse)
    res = te.query_batch(_engine_queries(), top_k=129)
    assert res.top_indices.shape == (B, 129)
