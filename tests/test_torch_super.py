"""Kernel B7 (supertile selection) of the PyTorch port against the JAX
package's supertile kernels, run by Pallas in interpret mode.

  * `resolve_super_tiles` against `_resolve_super_tiles` over a grid.
  * The plain versions of B7i (`int8_super_tile_topk_plain`) and B7f
    (`float_packed_super_tile_topk_plain`, f32 and bf16 banks) against
    `_topk_tile_kernel_int8_super` / `_topk_tile_kernel_packed_super` at
    spt 2, 4 and 8 with masked rows and a ragged last supertile.  The
    Pallas kernels keep T candidates per 128-row lane of a supertile and
    drop a row that shares its lane with T better ones; the port keeps the
    exact top k_sub.  Every slot where the two differ must be such a drop:
    the Pallas output must equal the exact top k_sub of the rows that
    survive the lane planes, computed here from the same keys.  The float
    inputs are multiples of 1/64, so every dot is exact in f32 in any
    summation order and both sides see the same keys.
  * `cosine_top_k(_int8)(super_tiles=...)` against `pallas_cosine_top_k(_int8)`
    end to end (selection and merge) on every query without a drop.
  * `merge_super_candidates` against `_merge_super_candidates`: a tied
    small pool (stable top-k in slot-major order) and a large pool (B2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hcrag_tpu.ops import topk_pallas as tp
from hcrag_tpu_torch.ops import topk_cuda as tc
from hcrag_tpu_torch.ops.quantize import quantize_queries, quantize_rows

D, B, TOP_K, MERGE_K, TILE = 128, 24, 10, 32, 1024


@pytest.mark.parametrize("tile_n", [512, 1024, 2048])
def test_resolve_super_tiles_equals_jax(tile_n):
    for req in (0, 1, 2, 3, 4, 5, 8, 9, 16, 64):
        for tiles in (1, 2, 3, 4, 7, 8, 9, 123, 4884):
            for two_level, packed in ((True, True), (False, True), (True, False)):
                want = tp._resolve_super_tiles(req, tile_n, tiles, two_level, packed)
                got = tc.resolve_super_tiles(req, tile_n, tiles, two_level, packed)
                assert got == want, (req, tile_n, tiles, two_level, packed)


# ---------------------------------------------------------------------------
# The supertile kernels
# ---------------------------------------------------------------------------
def _inputs(kind, n, seed):
    """Queries, bank and mask for `kind` ("int8", "f32", "bf16"): the int8
    operands quantized by the port; float ones multiples of 1/64."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) > 0.2
    if kind == "int8":
        e = rng.standard_normal((n, D)).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        q = rng.standard_normal((B, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q8, qs = quantize_queries(torch.from_numpy(q))
        e8, es = quantize_rows(e)
        return q, (q8.numpy(), qs.numpy(), e8, es), mask
    q = (rng.integers(-6, 7, (B, D)) / 64).astype(np.float32)
    e = (rng.integers(-6, 7, (n, D)) / 64).astype(np.float32)
    return q, (q, e), mask


def _jax_dtype(kind):
    return jnp.bfloat16 if kind == "bf16" else jnp.float32


def _pallas_super(kind, ops, mask, k, k_sub, spt, tile_n):
    """The Pallas supertile kernel as `pallas_cosine_top_k(_int8)` launches
    it: [b, S, k_sub] values and indices."""
    n = mask.shape[0]
    lbits = spt * tile_n
    n_pad = -(-n // lbits) * lbits
    num_super = n_pad // lbits
    b_pad = 128
    pad_rows = ((0, n_pad - n), (0, 0))
    pad_q = ((0, b_pad - B), (0, 0))
    mask_2d = jnp.pad(jnp.asarray(mask), (0, n_pad - n)).astype(jnp.int32)[None]
    vmem = dict(memory_space=pltpu.VMEM)
    blocks = [pl.BlockSpec((b_pad, D), lambda i, j: (0, 0), **vmem)]
    if kind == "int8":
        q8, qs, e8, es = ops
        args = [jnp.pad(jnp.asarray(q8), pad_q),
                jnp.pad(jnp.asarray(qs), (0, b_pad - B))[:, None],
                jnp.pad(jnp.asarray(e8), pad_rows),
                jnp.pad(jnp.asarray(es), (0, n_pad - n))[None], mask_2d]
        blocks.append(pl.BlockSpec((b_pad, 1), lambda i, j: (0, 0), **vmem))
        kernel = tp._topk_tile_kernel_int8_super
    else:
        q, e = ops
        args = [jnp.pad(jnp.asarray(q), pad_q).astype(_jax_dtype(kind)),
                jnp.pad(jnp.asarray(e), pad_rows).astype(_jax_dtype(kind)), mask_2d]
        kernel = tp._topk_tile_kernel_packed_super
    blocks.append(pl.BlockSpec((tile_n, D), lambda i, j: (i * spt + j, 0), **vmem))
    if kind == "int8":
        blocks.append(pl.BlockSpec((1, tile_n), lambda i, j: (0, i * spt + j), **vmem))
    blocks.append(pl.BlockSpec((1, tile_n), lambda i, j: (0, i * spt + j), **vmem))
    out_block = pl.BlockSpec((k_sub, b_pad), lambda i, j: (i, 0), **vmem)
    vals, idxs = pl.pallas_call(
        lambda *refs: kernel(*refs, k=k_sub, spt=spt, lbits=lbits),
        grid=(num_super, spt),
        in_specs=blocks,
        out_specs=[out_block, out_block],
        out_shape=[jax.ShapeDtypeStruct((num_super * k_sub, b_pad), jnp.float32),
                   jax.ShapeDtypeStruct((num_super * k_sub, b_pad), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((b_pad, 128), jnp.int32)
                        for _ in range(tp._super_lane_depth(k, spt))],
        interpret=True,
    )(*args)

    def layout(a):
        return np.asarray(a).reshape(num_super, k_sub, b_pad)[:, :, :B].transpose(2, 0, 1)

    return layout(vals), layout(idxs)


def _keys(kind, ops, mask, lbits):
    """Every row's packed key [B, S, lbits] (rows past n: INT32_MIN), from
    the same scores the kernels compute."""
    if kind == "int8":
        q8, qs, e8, es = (torch.from_numpy(a) for a in ops)
        s = (q8.float() @ e8.float().T) * qs[:, None] * es[None, :]
    else:
        q, e = (torch.from_numpy(a) for a in ops)
        s = q @ e.T  # exact: multiples of 2^-12 below 2 in magnitude
    s = s + torch.where(torch.from_numpy(mask), 2.0, -3.0)[None, :]
    n = mask.shape[0]
    lmask = lbits - 1
    keys = (s.view(torch.int32) & ~lmask) | (lmask - torch.arange(n) % lbits).int()
    pad = -n % lbits
    keys = torch.nn.functional.pad(keys, (0, pad), value=-(2**31))
    return keys.view(B, -1, lbits)


def _decode(top, lbits):
    lmask = lbits - 1
    base = (torch.arange(top.shape[1]) * lbits)[None, :, None]
    valid = top > 0
    val = (top & ~lmask).view(torch.float32) - 2.0
    idx = lmask - (top & lmask) + base
    return (torch.where(valid, val, tc.NEG_INF).numpy(),
            torch.where(valid, idx, -1).int().numpy())


def _lane_survivors(keys, t):
    """Keys that the Pallas kernel's T lane planes keep: the T largest
    positive keys of each 128-row lane of a supertile."""
    b, s, lbits = keys.shape
    lanes = keys.view(b, s, lbits // 128, 128)
    thr = lanes.sort(dim=2, descending=True).values[:, :, min(t, lbits // 128) - 1]
    kept = (lanes >= thr[:, :, None, :]) & (lanes > 0)
    return torch.where(kept, lanes, -(2**31)).view(b, s, lbits)


def _port_super(kind, ops, mask, k_sub, lbits):
    t = [torch.from_numpy(a) for a in ops] + [torch.from_numpy(mask)]
    if kind == "bf16":
        t[:2] = [a.bfloat16() for a in t[:2]]
    if kind == "int8":
        v, i = tc.int8_super_tile_topk(*t, k_sub, lbits)
    else:
        v, i = tc.float_packed_super_tile_topk(*t, k_sub, lbits)
    return v.numpy(), i.numpy()


def _check_against_pallas(kind, ops, mask, k, k_sub, spt, tile_n):
    """Port plain vs Pallas kernel, slot for slot, every difference a lane
    drop.  Returns the [B] flags of queries with a drop."""
    lbits = spt * tile_n
    jv, ji = _pallas_super(kind, ops, mask, k, k_sub, spt, tile_n)
    pv, pi = _port_super(kind, ops, mask, k_sub, lbits)
    keys = _keys(kind, ops, mask, lbits)
    exact = _decode(keys.topk(k_sub, dim=2).values, lbits)
    survivors = _lane_survivors(keys, tp._super_lane_depth(k, spt))
    approx = _decode(survivors.topk(k_sub, dim=2).values, lbits)
    # The port computes the exact contract, bit for bit ...
    np.testing.assert_array_equal(pi, exact[1])
    np.testing.assert_array_equal(pv.view(np.int32), exact[0].view(np.int32))
    # ... and the Pallas kernel the exact top k_sub of its lane survivors.
    np.testing.assert_array_equal(ji, approx[1])
    np.testing.assert_array_equal(jv.view(np.int32), approx[0].view(np.int32))
    differ = (ji != pi).any(axis=2)  # [B, S]
    dropped = (exact[1] != approx[1]).any(axis=2)
    np.testing.assert_array_equal(differ, dropped)
    return differ.any(axis=1)


CASES = [(kind, spt) for kind in ("int8", "f32", "bf16") for spt in (2, 4, 8)]


@pytest.mark.parametrize("kind,spt", CASES)
def test_b7_plain_equals_pallas_super_kernel(kind, spt):
    """Two full supertiles and a ragged third (spt * 1024-row supertiles),
    a fifth of the rows masked; then the whole selection with its merge
    (pool 3 x 16 < 1024: the stable slot-major top-k) equals the Pallas
    route's on every query without a lane drop."""
    lbits = spt * TILE
    n = 2 * lbits + 700
    q, ops, mask = _inputs(kind, n, seed=spt + len(kind))
    k_sub = tc.super_pick_count(TOP_K, n, lbits, MERGE_K)
    assert k_sub == 16
    drops = _check_against_pallas(kind, ops, mask, TOP_K, k_sub, spt, TILE)
    assert drops.sum() <= B // 4  # lane drops are rare on these inputs
    if kind == "int8":
        jv, ji = tp.pallas_cosine_top_k_int8(
            jnp.asarray(q), *(jnp.asarray(a) for a in ops[2:]), jnp.asarray(mask),
            TOP_K, tile_n=TILE, packed_select=True, merge_k=MERGE_K, super_tiles=spt,
            interpret=True)
        tv, ti = tc.cosine_top_k_int8(
            torch.from_numpy(q), *(torch.from_numpy(a) for a in ops[2:]),
            torch.from_numpy(mask), TOP_K, tile_n=TILE, merge_k=MERGE_K, super_tiles=spt)
    else:
        jv, ji = tp.pallas_cosine_top_k(
            jnp.asarray(q), jnp.asarray(ops[1]).astype(_jax_dtype(kind)), jnp.asarray(mask),
            TOP_K, tile_n=TILE, packed_select=True, merge_k=MERGE_K, super_tiles=spt,
            interpret=True)
        e = torch.from_numpy(ops[1])
        tv, ti = tc.cosine_top_k(
            torch.from_numpy(q), e.bfloat16() if kind == "bf16" else e,
            torch.from_numpy(mask), TOP_K, tile_n=TILE, merge_k=MERGE_K,
            packed_select=True, super_tiles=spt)
    keep = ~drops
    np.testing.assert_array_equal(ti.numpy()[keep], np.asarray(ji)[keep])
    np.testing.assert_array_equal(tv.numpy()[keep].view(np.int32),
                                  np.asarray(jv)[keep].view(np.int32))


def test_b7_lane_drop_is_the_only_difference():
    """Rows 0, 128, 256 and 384 of supertile 0 (one 128-row lane) are the
    best rows for query 0: the Pallas kernel's 3 lane planes (spt 4) keep
    three of them and drop row 384; the port keeps all four."""
    n, spt = 9000, 4
    q, (q8, qs, e8, es), mask = _inputs("int8", n, seed=3)
    mask[:512] = True
    e8[[0, 128, 256, 384]] = q8[0]
    es[[0, 128, 256, 384]] = es.max() * 2
    drops = _check_against_pallas("int8", (q8, qs, e8, es), mask, TOP_K, 16, spt, TILE)
    assert drops[0]
    _, pi = _port_super("int8", (q8, qs, e8, es), mask, 16, spt * TILE)
    assert set(pi[0, 0, :4]) == {0, 128, 256, 384}


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_b7_small_pool_pick_raise(kind):
    """Two 2048-row supertiles at top_k 5 hold 2 x 8 < 32 candidates: each
    picks 16, as the Pallas route raises k_sub."""
    n, spt, k = 3000, 2, 5
    q, ops, mask = _inputs(kind, n, seed=11)
    k_sub = tc.super_pick_count(k, n, spt * TILE, MERGE_K)
    assert k_sub == 16
    _check_against_pallas(kind, ops, mask, k, k_sub, spt, TILE)


@pytest.mark.parametrize("top_k,n,lbits,merge_k,want", [
    (10, 1_007_616, 8192, 32, 16),     # 123 supertiles x 16: no raise
    (10, 8192, 8192, 32, 32),          # one supertile: raised to 32
    (5, 3000, 2048, 32, 16),           # two supertiles x 8 < 32
    (100, 1_007_616, 8192, 0, 104),    # k 100 rounds up to 104
    (128, 20_000, 4096, 0, 128),
    (10, 4000, 4096, 300, 128),        # the raise is capped at 128
])
def test_super_pick_count_follows_pallas(top_k, n, lbits, merge_k, want):
    """The Pallas wrappers' inline rule: k_sub = round_up(min(top_k, n), 8),
    raised to min(128, round_up(ceil(merge_k / S), 8)) when S * k_sub <
    merge_k."""
    num_super = -(-n // lbits)
    k_sub = tp._round_up(min(top_k, n), 8)
    if merge_k > num_super * k_sub:
        k_sub = min(128, tp._round_up(-(-merge_k // num_super), 8))
    assert tc.super_pick_count(top_k, n, lbits, merge_k) == k_sub == want


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("num_super,k_sub,merge_k,tied", [
    (3, 16, 32, True),     # pool 48: stable top-k in slot-major order
    (5, 8, 0, True),       # out_k = k = 10
    (123, 16, 32, False),  # pool 1968 >= 1024: kernel B2
])
def test_merge_super_candidates_equals_jax(num_super, k_sub, merge_k, tied):
    rng = np.random.default_rng(num_super)
    b = 16
    v = (rng.standard_normal((b, num_super, k_sub)) * 0.2).astype(np.float32)
    if tied:
        # Many exact ties across supertiles; + 0.0 folds -0.0, which B7's
        # decoded values (key - 2.0) never hold.
        v = np.round(v * 4) / 4 + np.float32(0.0)
    v[:, -1, k_sub // 2:] = tc.NEG_INF
    i = rng.integers(0, 10**6, size=(b, num_super, k_sub)).astype(np.int32)
    i[:, -1, k_sub // 2:] = -1
    # The Pallas kernel's row-major blocks [S * k_sub, b].
    vt, it = (jnp.asarray(a.transpose(1, 2, 0).reshape(num_super * k_sub, b))
              for a in (v, i))
    jv, ji = tp._merge_super_candidates(vt, it, b, num_super, k_sub, TOP_K, merge_k,
                                        interpret=True)
    tv, ti = tc.merge_super_candidates(torch.from_numpy(v), torch.from_numpy(i), TOP_K,
                                       merge_k)
    assert tc.uses_packed_super_merge(num_super, k_sub, tv.shape[1]) == (num_super > 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_bounds_of_the_supertile_paths():
    """`utils/bounds.py` counts B7 over the padded banks the supertile paths
    run (123 and 1,221 supertiles of 8192 rows, 16 picks each), bound by
    operations, and B2 over their pools, bound by bytes."""
    from hcrag_tpu_torch.utils.bounds import D, table

    rows = {(r["id"], r["path"].split(":")[0]): r for r in table()}
    for path, b, n, kind in (("path S1", 8192, 1_007_616, "bf16"),
                             ("path S2", 8192, 1_007_616, "int8"),
                             ("path S3", 2048, 10_002_432, "int8")):
        r = rows[("B7", path)]
        assert r["ops"] == 2.0 * b * n * D and r["ops_type"] == kind
        assert r["bound_by"] == "operations"
    assert rows[("B2", "paths S1/S2")]["bytes"] == 4 * 8192 * 123 * 16 + 40 * 8192 * 32
    assert rows[("B2", "path S3")]["bytes"] == 4 * 2048 * 1221 * 16 + 40 * 2048 * 32
    assert rows[("B5", "path X")]["ops"] == 2.0 * 256 * 1_001_472 * D
