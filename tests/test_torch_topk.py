"""Kernels B1 (`int8_tile_topk`) and B2 (`packed_candidate_merge`) of the
PyTorch port against the JAX package's Pallas kernels, run in interpret
mode.  On the CPU the port's wrappers run their kernels' plain versions, so
these tests hold the plain versions to the Pallas kernels' contracts; the
chip smoke run and tests/test_torch_cuda.py hold the CUDA kernels to the
plain versions.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcrag_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from hcrag_tpu.ops.topk_pallas import (
    _merge_tile_candidates,
    _packed_candidate_merge,
    pallas_cosine_top_k_int8,
)
from hcrag_tpu_torch.ops import topk_cuda


def _bank(n, d, seed):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e8, es = jax_quantize_rows(e)
    return rng, e, e8, es


def _both(q, e8, es, mask, k, tile, merge_k):
    jv, ji = pallas_cosine_top_k_int8(
        jnp.asarray(q), jnp.asarray(e8), jnp.asarray(es), jnp.asarray(mask), k,
        tile_n=tile, packed_select=True, two_level=False, merge_k=merge_k,
        interpret=True,
    )
    tv, ti = topk_cuda.cosine_top_k_int8(
        torch.from_numpy(q), torch.from_numpy(e8), torch.from_numpy(es),
        torch.from_numpy(mask), k, tile_n=tile, merge_k=merge_k,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("tile", [1024, 2048])
@pytest.mark.parametrize("merge_k", [0, 32])
def test_b1_with_merge_equals_pallas(tile, merge_k):
    """n=5000 leaves a ragged last tile; a fifth of the rows are masked."""
    rng, _, e8, es = _bank(5000, 128, seed=tile + merge_k)
    q = rng.standard_normal((4, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = rng.random(5000) > 0.2
    (jv, ji), (tv, ti) = _both(q, e8, es, mask, 10, tile, merge_k)
    assert tv.shape == (4, max(10, merge_k))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert mask[ti[ti >= 0]].all()


@pytest.mark.parametrize("merge_k", [0, 32])
def test_b1_all_tied_rows_give_lowest_indices(merge_k):
    """Every row equal: all keys tie but for the lane field, so each tile
    gives its lowest 10 rows and the merge keeps tiles in order."""
    row = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    e = np.tile(row / np.linalg.norm(row), (5000, 1))
    e8, es = jax_quantize_rows(e)
    q = np.tile(row / np.linalg.norm(row), (4, 1)).astype(np.float32)
    mask = np.ones(5000, bool)
    (jv, ji), (tv, ti) = _both(q, e8, es, mask, 10, 1024, merge_k)
    want = np.concatenate([t * 1024 + np.arange(10) for t in range(5)])
    np.testing.assert_array_equal(ti, np.tile(want[: max(10, merge_k)], (4, 1)))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)


def test_b1_pick_count_raise():
    """Two tiles of 2048 cannot give 32 candidates at k=10: each tile picks
    ceil(32 / 2) = 16, and masked rows leave fillers in the last tile."""
    rng, _, e8, es = _bank(2100, 128, seed=7)
    q = rng.standard_normal((3, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = np.ones(2100, bool)
    mask[2050:] = False  # 2 valid rows in the last tile
    assert topk_cuda.tile_pick_count(10, 2100, 2048, 32) == 16
    (jv, ji), (tv, ti) = _both(q, e8, es, mask, 10, 2048, 32)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    # 16 + 2 real candidates, then 14 fillers per query.
    np.testing.assert_array_equal((ti == -1).sum(axis=1), [14, 14, 14])
    assert (tv[ti == -1] == np.float32(-1e30)).all()


def _lexsort_merge(v, i, out_k):
    """The exact B2 contract in numpy over a slot-major pool [b, c]:
    quantized key descending, position ascending."""
    key = ((v + np.float32(2.0)).view(np.int32) & ~0x7FF).astype(np.int64)
    pos = np.arange(v.shape[1])
    out_v, out_i = [], []
    for r in range(v.shape[0]):
        order = np.lexsort((pos, -key[r]))[:out_k]
        kk = key[r][order]
        ok = kk > 0
        val = (kk.astype(np.int32).view(np.float32) - np.float32(2.0))
        out_v.append(np.where(ok, val, np.float32(-1e30)))
        out_i.append(np.where(ok, i[r][order], -1))
    return np.array(out_v, np.float32), np.array(out_i, np.int32)


POOL_TILES, POOL_K = 489, 10  # the main path's pool: 489 tiles x 10


def _tile_major(a):
    """[b, 4890] slot-major pool -> B1's [b, tiles, k] tile-major layout,
    the layout the port's B2 reads."""
    t = a.reshape(a.shape[0], POOL_K, POOL_TILES).transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(t))


def _pool(seed, ties=False):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((4, 4890)) * 0.1).astype(np.float32)
    if ties:  # few distinct values: many quantized keys tie
        v = np.round(v * 8) / 8
    i = rng.integers(0, 1_000_000, size=(4, 4890)).astype(np.int32)
    v[:, -70:] = -1e30  # fillers, as tiles with few valid rows leave
    i[:, -70:] = -1
    return v.astype(np.float32), i


B2_SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def pallas_merges():
    """The Pallas merge of every seed's pool, in one interpret-mode call."""
    v = np.concatenate([_pool(s)[0] for s in B2_SEEDS])
    i = np.concatenate([_pool(s)[1] for s in B2_SEEDS])
    jv, ji = _packed_candidate_merge(jnp.asarray(v), jnp.asarray(i), 32, True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    return {s: (jv[4 * n:4 * n + 4], ji[4 * n:4 * n + 4])
            for n, s in enumerate(B2_SEEDS)}


@pytest.mark.parametrize("seed", B2_SEEDS)
def test_b2_equals_pallas_merge(seed, pallas_merges):
    """On these seeds no 1024-column tile of the pool puts more than 4 of
    its top 32 in one 128-lane column, so JAX's lane-depth-4 approximation
    does not bite and the Pallas merge equals the exact contract; the
    lexsort check holds both to it."""
    v, i = _pool(seed)
    jv, ji = pallas_merges[seed]
    tv, ti = topk_cuda.packed_candidate_merge(_tile_major(v), _tile_major(i), 32)
    lv, li = _lexsort_merge(v, i, 32)
    np.testing.assert_array_equal(tv.numpy(), lv)
    np.testing.assert_array_equal(ti.numpy(), li)
    np.testing.assert_array_equal(np.asarray(jv), lv)
    np.testing.assert_array_equal(np.asarray(ji), li)


@pytest.mark.parametrize("seed", [3, 4])
def test_b2_exact_on_heavy_ties(seed):
    """Heavily tied values: ties go to the lowest position (the JAX kernel
    approximates here, so only the exact contract is checked)."""
    v, i = _pool(seed, ties=True)
    tv, ti = topk_cuda.packed_candidate_merge(_tile_major(v), _tile_major(i), 32)
    lv, li = _lexsort_merge(v, i, 32)
    np.testing.assert_array_equal(tv.numpy(), lv)
    np.testing.assert_array_equal(ti.numpy(), li)


def test_merge_routing_at_bench_pool():
    """489 tiles x 10 = 4890 candidates (the main path's pool) route through
    B2, whose ties go by slot-major position, as `_merge_tile_candidates`
    routes them."""
    rng = np.random.default_rng(9)
    b, tiles, k = 4, 489, 10
    vals = -np.sort(-rng.random((b, tiles, k)).astype(np.float32), axis=2)
    vals = vals * 2 - 1
    idxs = rng.integers(0, 1_000_000, size=(b, tiles, k)).astype(np.int32)
    k_pad = 128
    jv = np.full((b, tiles, k_pad), -1e30, np.float32)
    ji = np.full((b, tiles, k_pad), -1, np.int32)
    jv[:, :, :k], ji[:, :, :k] = vals, idxs
    ov, oi = _merge_tile_candidates(
        jnp.asarray(jv.reshape(b, -1)), jnp.asarray(ji.reshape(b, -1)),
        b, tiles, k_pad, k, 32, packed_merge=True, interpret=True,
    )
    before = topk_cuda.packed_candidate_merge.launches
    tv, ti = topk_cuda.merge_tile_candidates(
        torch.from_numpy(vals), torch.from_numpy(idxs), 32
    )
    assert topk_cuda.packed_candidate_merge.launches == before  # CPU: plain
    np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ov))


def test_merge_routing_past_one_block():
    """10M rows at per-tile k = 12: 4,883 tiles x 12 = 58,596 candidates,
    more than one block's shared memory holds, still route through B2
    (which streams the pool from device memory, a small batch's query over
    8 warps) and equal `_merge_tile_candidates`, ties by slot-major
    position included."""
    rng = np.random.default_rng(11)
    b, tiles, k = 2, 4883, 12
    assert [topk_cuda.merge_warps(x) for x in (b, 2048, 4224, 8192)] == [8, 4, 1, 1]
    assert topk_cuda.uses_packed_merge(tiles, k, 32)
    vals = -np.sort(-rng.random((b, tiles, k)).astype(np.float32), axis=2)
    vals = np.round((vals * 2 - 1) * 64) / 64  # quantized keys tie often
    vals[:, -50:] = -1e30  # tiles with no valid row
    idxs = rng.integers(0, 10_000_000, size=(b, tiles, k)).astype(np.int32)
    idxs[:, -50:] = -1
    k_pad = 128
    jv = np.full((b, tiles, k_pad), -1e30, np.float32)
    ji = np.full((b, tiles, k_pad), -1, np.int32)
    jv[:, :, :k], ji[:, :, :k] = vals, idxs
    ov, oi = _merge_tile_candidates(
        jnp.asarray(jv.reshape(b, -1)), jnp.asarray(ji.reshape(b, -1)),
        b, tiles, k_pad, k, 32, packed_merge=True, interpret=True,
    )
    tv, ti = topk_cuda.merge_tile_candidates(
        torch.from_numpy(vals), torch.from_numpy(idxs), 32
    )
    slot_major = lambda a: a.transpose(0, 2, 1).reshape(b, -1)
    lv, li = _lexsort_merge(slot_major(vals), slot_major(idxs), 32)
    np.testing.assert_array_equal(ti.numpy(), li)
    np.testing.assert_array_equal(tv.numpy(), lv)
    np.testing.assert_array_equal(np.asarray(oi), li)
    np.testing.assert_array_equal(np.asarray(ov), lv)


def test_cuda_wrappers_refuse_other_devices():
    meta = torch.zeros((2, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        topk_cuda.int8_tile_topk(meta, meta, meta, meta, meta, 1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        topk_cuda.packed_candidate_merge(meta.float()[None], meta.int()[None], 1)
