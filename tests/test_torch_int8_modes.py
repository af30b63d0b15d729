"""The int8 density modes of the PyTorch port against the JAX package.

  * Kernel B3 (`_topk_tile_kernel_int8`'s k-pass packed and exact
    branches, run by `pallas_cosine_top_k_int8` in interpret mode) against
    the port's `cosine_top_k_int8`, whose wrappers run the plain versions on
    the CPU: packed through B1's plain version, exact through B3e's.  Exact
    equality: the integer dots are exact in f32 and the rescale rounds in
    the same order.
  * `quantize_residual`, `quantize_rows` across a row chunk and
    `quantized_scores`: byte-equal.
  * The port's QueryEngine against the JAX engine (Pallas in interpret
    mode, a graph, depth 1; n=4096, d=128, B=8, top_k=10) in every int8
    residency mode: indices and expansion exact, scores within 1e-5 (f32
    sums in another order).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_setup
from hcrag_tpu.core.types import QueryIntent as JaxIntent
from hcrag_tpu.ops.quantize import quantize_residual as jax_quantize_residual
from hcrag_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from hcrag_tpu.ops.quantize import quantized_scores as jax_quantized_scores
from hcrag_tpu.ops.topk_pallas import pallas_cosine_top_k_int8
from hcrag_tpu.query.engine import QueryEngine as JaxEngine
from hcrag_tpu_torch.convert import bank_from_numpy
from hcrag_tpu_torch.core.types import QueryIntent
from hcrag_tpu_torch.ops import topk_cuda
from hcrag_tpu_torch.ops.quantize import (
    ROW_CHUNK,
    quantize_residual,
    quantize_rows,
    quantized_scores,
)
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_setup


def _bank(n, d, seed, tied=False):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    if tied:
        e[:] = e[0]
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e8, es = jax_quantize_rows(e)
    return rng, e, e8, es


def _queries(rng, b, d):
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _both(q, e8, es, mask, k, tile, merge_k, packed):
    jv, ji = pallas_cosine_top_k_int8(
        jnp.asarray(q), jnp.asarray(e8), jnp.asarray(es), jnp.asarray(mask), k,
        tile_n=tile, packed_select=packed, two_level=False, merge_k=merge_k,
        interpret=True,
    )
    tv, ti = topk_cuda.cosine_top_k_int8(
        torch.from_numpy(q), torch.from_numpy(e8), torch.from_numpy(es),
        torch.from_numpy(mask), k, tile_n=tile, merge_k=merge_k,
        packed_select=packed,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _assert_same(jax_out, port_out):
    (jv, ji), (tv, ti) = jax_out, port_out
    np.testing.assert_array_equal(ti, ji)
    assert tv.dtype == jv.dtype == np.float32
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


@pytest.mark.parametrize("tile", [1024, 2048])
def test_b3_packed_kpass_equals_pallas(tile):
    """int8-only selection (no rescore): the k-pass packed branch at the
    path's width, a ragged last tile and a fifth of the rows masked."""
    rng, _, e8, es = _bank(6000, 384, seed=tile)
    q = _queries(rng, 6, 384)
    mask = rng.random(6000) > 0.2
    _assert_same(*_both(q, e8, es, mask, 10, tile, 0, packed=True))


@pytest.mark.parametrize("tile,merge_k", [(1024, 0), (2048, 0), (1024, 32)])
def test_b3_exact_equals_pallas(tile, merge_k):
    rng, _, e8, es = _bank(5000, 128, seed=tile + merge_k + 1)
    q = _queries(rng, 5, 128)
    mask = rng.random(5000) > 0.2
    jax_out, port_out = _both(q, e8, es, mask, 10, tile, merge_k, packed=False)
    _assert_same(jax_out, port_out)
    assert mask[port_out[1]].all()


def test_b3_exact_filter_fewer_than_k_in_a_tile():
    """Tile 0 keeps 3 rows: its other 7 slots are (-1e30, 0), the Pallas
    branch's repeated pick of the tile's first column; the merge still finds
    the global top 10 in the full tiles."""
    rng, _, e8, es = _bank(5000, 128, seed=3)
    q = _queries(rng, 4, 128)
    mask = np.ones(5000, bool)
    mask[:1024] = False
    mask[[5, 300, 1000]] = True
    vals, idxs = topk_cuda.int8_exact_tile_topk(
        *[torch.from_numpy(a) for a in (*_quantized(q), e8, es, mask)], 10, tile_n=1024
    )
    assert (vals[:, 0, 3:] == -1e30).all() and (idxs[:, 0, 3:] == 0).all()
    _assert_same(*_both(q, e8, es, mask, 10, 1024, 0, packed=False))


def test_b3_exact_filter_fewer_than_top_k_overall():
    """3 valid rows in the whole bank for top_k=10: the merged list holds
    them, then tile 0's (-1e30, 0) fill, as JAX's stable merge orders it."""
    rng, _, e8, es = _bank(5000, 128, seed=4)
    q = _queries(rng, 4, 128)
    mask = np.zeros(5000, bool)
    mask[[5, 2100, 4999]] = True
    jax_out, port_out = _both(q, e8, es, mask, 10, 1024, 0, packed=False)
    _assert_same(jax_out, port_out)
    tv, ti = port_out
    assert set(ti[:, :3].ravel()) == {5, 2100, 4999}
    assert (tv[:, 3:] == np.float32(-1e30)).all() and (ti[:, 3:] == 0).all()


def test_b3_exact_all_tied_and_zero_query():
    """Every row equal, and a zero query (every score +0.0): each tile
    gives its lowest rows and the merge keeps tiles in order."""
    rng, e, e8, es = _bank(3000, 128, seed=5, tied=True)
    q = np.concatenate([e[:2], np.zeros((2, 128), np.float32)])
    mask = np.ones(3000, bool)
    jax_out, port_out = _both(q, e8, es, mask, 10, 1024, 32, packed=False)
    _assert_same(jax_out, port_out)
    want = np.concatenate([t * 1024 + np.arange(10) for t in range(3)])
    np.testing.assert_array_equal(port_out[1], np.tile(want, (4, 1)))
    assert not np.signbit(port_out[0][2:]).any()


def _quantized(q):
    from hcrag_tpu_torch.ops.quantize import quantize_queries

    q8, qs = quantize_queries(torch.from_numpy(q))
    return q8.numpy(), qs.numpy()


def test_quantize_residual_and_rows_byte_equal():
    """A bank that spans two row chunks, with zero rows, and a bfloat16
    bank, as the JAX engine quantizes both."""
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((ROW_CHUNK + 300, 32)).astype(np.float32)
    emb[[0, ROW_CHUNK, ROW_CHUNK + 7]] = 0.0
    for host in (np.asarray(jnp.asarray(emb).astype(jnp.bfloat16)), emb):
        jq, js = jax_quantize_rows(np.asarray(host, np.float32))
        tq, ts = quantize_rows(host)
        assert jq.tobytes() == tq.tobytes() and js.tobytes() == ts.tobytes()
        jr, jrs = jax_quantize_residual(host, jq, js)
        tr, trs = quantize_residual(host, tq, ts)
        assert jr.tobytes() == tr.tobytes() and jrs.tobytes() == trs.tobytes()
    # The residual carries ~1/127 of the first level's error (f32 bank).
    first = np.abs(emb - tq * ts[:, None]).max()
    second = np.abs(emb - (tq * ts[:, None] + tr * trs[:, None])).max()
    assert second < first / 50


def test_quantized_scores_equal():
    rng, _, e8, es = _bank(700, 384, seed=7)
    q8, qs = _quantized(_queries(rng, 9, 384))
    want = np.asarray(jax_quantized_scores(*(jnp.asarray(a) for a in (q8, qs, e8, es))))
    got = quantized_scores(*(torch.from_numpy(a) for a in (q8, qs, e8, es)))
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# The engine in every int8 residency mode
# ---------------------------------------------------------------------------
N, D, B, K = 4096, 128, 8, 10
INT8 = dict(quantize_int8=True, ell_max_degree=8)
MODES = {
    "int8_only": (dict(int8_only=True, int8_rescore=32), "f32"),
    "residual_24": (dict(int8_residual=True, int8_rescore=24), "f32"),
    "residual_32": (dict(int8_residual=True, int8_rescore=32), "f32"),
    "bf16_rescore_f32_index": (dict(int8_rescore=32), "f32"),
    "bf16_rescore_bf16_index": (dict(int8_rescore=32), "bf16"),
    "no_rescore": (dict(), "f32"),
    "f32_rescore_dropped": (dict(int8_rescore=32, int8_f32_rescore=True), "bf16"),
}


@pytest.fixture(scope="module")
def setups():
    jidx, jg = _synthetic_setup(N, D, graph_degree=4)
    tidx, tg = synthetic_setup(N, D, graph_degree=4)
    emb16 = np.asarray(jnp.asarray(jidx.emb).astype(jnp.bfloat16))
    return {
        "f32": ((jidx, jg), (tidx, tg)),
        "bf16": ((dataclasses.replace(jidx, emb=emb16), jg),
                 (dataclasses.replace(tidx, emb=emb16.copy()), tg)),
    }


def _engines(setups, mode):
    opts, host = MODES[mode]
    (jidx, jg), (tidx, tg) = setups[host]
    return (JaxEngine(jidx, jg, pallas_interpret=True, **INT8, **opts),
            QueryEngine(tidx, tg, device="cpu", **INT8, **opts))


def _step_inputs(seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    ents = [[f"e{x}" for x in rng.integers(0, 128, size=3)] + ["not_in_vocab"]
            for _ in range(B)]
    ents[0] = []  # empty entity set: the 0.5 / 0.1 rule
    j_int = [list(JaxIntent)[i % 5] for i in range(B)]
    t_int = [list(QueryIntent)[i % 5] for i in range(B)]
    return q, dict(entity_lists=ents, intents=j_int), dict(entity_lists=ents, intents=t_int)


def _assert_results_match(rt, rj):
    for field in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rt, field), getattr(rj, field), err_msg=field)
    real = rt.top_indices >= 0
    for field in ("top_scores", "relevance", "combined"):
        a, b = getattr(rt, field), getattr(rj, field)
        np.testing.assert_allclose(a[real], b[real], atol=1e-5, rtol=0, err_msg=field)
        assert (a[~real] < -1e29).all() and (b[~real] < -1e29).all(), field
    np.testing.assert_allclose(rt.expanded_relevance, rj.expanded_relevance,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_mode_matches_jax_engine(setups, mode):
    je, te = _engines(setups, mode)
    q, jkw, tkw = _step_inputs()
    rj = je.query_batch(q, top_k=K, expansion_depth=1, **jkw)
    rt = te.query_batch(q, top_k=K, expansion_depth=1, **tkw)
    _assert_results_match(rt, rj)
    jc, tc = je.resolved_kernel_config(B, K), te.resolved_kernel_config(B, K)
    for key in ("quantize_int8", "int8_only", "int8_residual", "rescore_oversample",
                "merge_k", "rescore_bank"):
        assert tc[key] == jc[key], key
    assert tc["kernel"] == "int8_tile_topk_plain"
    # Which float copy each mode keeps: none in int8-only residency, an
    # f32 bank only for the f32 rescore.
    bank = te._bank()
    assert ("emb" in bank) == (not te.int8_only)
    assert ("emb_res8" in bank) == te.int8_residual
    assert "emb_f32" not in bank
    if te.int8_rescore and not te.int8_only:
        assert bank["emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["int8_only", "residual_32"])
def test_int8_mode_category_filter_matches_jax(setups, mode):
    """A filter that leaves 9 rows for top_k=10: the last slot is a packed
    filler (-1e30, -1) on both sides, with or without the rescore."""
    je, te = _engines(setups, mode)
    q, jkw, tkw = _step_inputs(seed=9)
    originals = [(e.index, [dict(m) for m in e.index.metadata]) for e in (je, te)]
    try:
        for e in (je, te):
            for r, m in enumerate(e.index.metadata):
                m["type"] = "json_table" if r % 500 == 0 else "database_table"
        rj = je.query_batch(q, top_k=K, category_filter="json_table", **jkw)
        rt = te.query_batch(q, top_k=K, category_filter="json_table", **tkw)
    finally:
        for index, meta in originals:
            index.metadata = meta
    assert (rt.top_indices[:, -1] == -1).all()
    _assert_results_match(rt, rj)


def test_bank_from_numpy_takes_the_int8_banks(setups):
    """`bank_from_numpy` carries the JAX engine's int8 banks (int8 rows,
    scales, the residual level) and a bf16 `emb` beside them with the same
    bits as the port's own."""
    for mode in ("residual_32", "bf16_rescore_f32_index"):
        je, te = _engines(setups, mode)
        keys = ("emb_int8", "emb_scale", "emb_res8", "emb_res_scale", "emb")
        jb = {k: np.asarray(v) for k, v in je._bank().items() if k in keys}
        got = bank_from_numpy(jb, device="cpu")
        own = te._bank()
        assert set(got) == {k for k in keys if k in own}, mode
        for key in got:
            a, b = got[key], own[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(torch.int16)
            assert torch.equal(a, b), key
