"""Kernels B1 (`int8_tile_topk`) and B7i (`int8_super_tile_topk`) at the edge
shapes of their tensor-core loop, on the CPU, where the wrappers run their
plain versions: against the JAX package's Pallas kernels in interpret mode,
and the wrappers' operand rules (the tensor-core kernel's shared-memory
sizing, the limit on d).  tests/test_torch_cuda.py holds the CUDA kernels to
the plain versions at the same shapes, bit for bit.

The edge shapes: d of 16 and 48 (not a whole 128-byte chunk: the kernel's
zero fill), 128, 384 and 768; per-tile k of 1, 10, 16, 17, 64 and 128 (both
epilogues); 64-, 1024- and 2048-row tiles and 128- and 8192-row
supertiles; batches of 1, 65, 130 and 8192; ragged last tiles, a tenth of
the rows masked, a filter that leaves fewer than k rows in a tile, and
all-tied rows.  The Pallas kernels take rows of whole 128-column multiples
(`pallas_cosine_top_k_int8` asserts it): they get the same int8 rows padded
with zero columns, which change no integer dot.  Every comparison is exact,
bit for bit against the contract computed here from the same scores; the
Pallas kernel in interpret mode equals it too, except where XLA's CPU
backend, which runs it, contracts the last product and the mask's shift
into one FMA (one rounding fewer than the TPU kernel and the port): there
it equals the contract under that FMA, key for key.  At 8192-row
supertiles the Pallas kernel keeps T candidates per 128-row lane, and
every supertile where it differs from the port's exact top k_sub must hold
such a drop (or an FMA move).
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


def _inputs(b, n, d, seed, tied=False, mask_frac=0.1):
    """Quantized queries and rows (numpy) and a mask with a tenth of the
    rows cleared; `tied`: every row equal to row 0, the queries too."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    if tied:
        e[:] = e[0]
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = np.repeat(e[:1], b, axis=0) if tied else rng.standard_normal((b, d))
    q = torch.nn.functional.normalize(torch.from_numpy(np.asarray(q, np.float32)), dim=1)
    q8, qs = quantize_queries(q)
    e8, es = quantize_rows(e)
    mask = rng.random(n) >= mask_frac
    return q8.numpy(), qs.numpy(), e8, es, mask


def _padded(q8, qs, e8, es, mask, b_pad, n_pad):
    """The Pallas kernels' operands: queries padded to b_pad, rows to n_pad,
    both to whole 128-column multiples with zero columns."""
    b, d = q8.shape
    n = e8.shape[0]
    d_pad = -(-d // 128) * 128
    return (jnp.pad(jnp.asarray(q8), ((0, b_pad - b), (0, d_pad - d))),
            jnp.pad(jnp.asarray(qs), (0, b_pad - b))[:, None],
            jnp.pad(jnp.asarray(e8), ((0, n_pad - n), (0, d_pad - d))),
            jnp.pad(jnp.asarray(es), (0, n_pad - n))[None],
            jnp.pad(jnp.asarray(mask), (0, n_pad - n)).astype(jnp.int32)[None])


def _vmem(shape, index_map):
    return pl.BlockSpec(shape, index_map, memory_space=pltpu.VMEM)


def _pallas_b1(q8, qs, e8, es, mask, k, tile_n):
    """`_topk_tile_kernel_int8` in its k-pass packed branch (the exact
    contract B1 computes), launched as `pallas_cosine_top_k_int8` launches
    it: (vals, idx) [b, tiles, k]."""
    b, n = q8.shape[0], e8.shape[0]
    tiles = -(-n // tile_n)
    b_pad = -(-b // 32) * 32
    args = _padded(q8, qs, e8, es, mask, b_pad, tiles * tile_n)
    d_pad = args[0].shape[1]
    out = _vmem((b_pad, 128), lambda i: (0, i))
    vals, idxs = pl.pallas_call(
        lambda *refs: tp._topk_tile_kernel_int8(*refs, k=k, k_pad=128, packed=True,
                                                two_level=False),
        grid=(tiles,),
        in_specs=[_vmem((b_pad, d_pad), lambda i: (0, 0)),
                  _vmem((b_pad, 1), lambda i: (0, 0)),
                  _vmem((tile_n, d_pad), lambda i: (i, 0)),
                  _vmem((1, tile_n), lambda i: (0, i)),
                  _vmem((1, tile_n), lambda i: (0, i))],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((b_pad, tiles * 128), jnp.float32),
                   jax.ShapeDtypeStruct((b_pad, tiles * 128), jnp.int32)],
        interpret=True,
    )(*args)

    def layout(a):
        return np.asarray(a)[:b].reshape(b, tiles, 128)[:, :, :k]

    return layout(vals), layout(idxs)


def _pallas_b7i(q8, qs, e8, es, mask, k_sub, lbits, tile_n):
    """`_topk_tile_kernel_int8_super` over lbits-row supertiles of tile_n-row
    tiles, launched as `pallas_cosine_top_k_int8(super_tiles=...)` launches
    it: (vals, idx) [b, S, k_sub]."""
    b, n = q8.shape[0], e8.shape[0]
    spt = lbits // tile_n
    num_super = -(-n // lbits)
    b_pad = -(-b // 128) * 128
    args = _padded(q8, qs, e8, es, mask, b_pad, num_super * lbits)
    d_pad = args[0].shape[1]
    out = _vmem((k_sub, b_pad), lambda i, j: (i, 0))
    vals, idxs = pl.pallas_call(
        lambda *refs: tp._topk_tile_kernel_int8_super(*refs, k=k_sub, spt=spt,
                                                      lbits=lbits),
        grid=(num_super, spt),
        in_specs=[_vmem((b_pad, d_pad), lambda i, j: (0, 0)),
                  _vmem((b_pad, 1), lambda i, j: (0, 0)),
                  _vmem((tile_n, d_pad), lambda i, j: (i * spt + j, 0)),
                  _vmem((1, tile_n), lambda i, j: (0, i * spt + j)),
                  _vmem((1, tile_n), lambda i, j: (0, i * spt + j))],
        out_specs=[out, out],
        out_shape=[jax.ShapeDtypeStruct((num_super * k_sub, b_pad), jnp.float32),
                   jax.ShapeDtypeStruct((num_super * k_sub, b_pad), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((b_pad, 128), jnp.int32)
                        for _ in range(tp._super_lane_depth(k_sub, spt))],
        interpret=True,
    )(*args)

    def layout(a):
        return np.asarray(a).reshape(num_super, k_sub, b_pad)[:, :, :b].transpose(2, 0, 1)

    return layout(vals), layout(idxs)


def _port(fn, ops, k, rows):
    v, i = fn(*(torch.from_numpy(a) for a in ops), k, rows)
    return v.numpy(), i.numpy()


def _assert_bits(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].view(np.int32))


def _keys(ops, rows, lane_bits, fma=False):
    """Every row's packed key [b, tiles, rows] over tiles of `rows` rows
    (rows past n: INT32_MIN), from the scores the kernels compute:
    s = fp32(dot) * q_scale * e_scale + (2 if mask else -3), each product
    and the shift rounded to f32 in turn, as the TPU kernel and the port
    round them.  `fma`: the last product and the shift in one rounding, as
    XLA's CPU backend contracts them when it runs the Pallas kernel in
    interpret mode."""
    q8, qs, e8, es, mask = (torch.from_numpy(x) for x in ops)
    a = (q8.double() @ e8.double().T).float() * qs[:, None]
    shift = torch.where(mask, 2.0, -3.0)[None, :]
    if fma:
        s = (a.double() * es.double()[None, :] + shift.double()).float()
    else:
        s = a * es[None, :] + shift
    n, lmask = mask.shape[0], lane_bits - 1
    keys = (s.view(torch.int32) & ~lmask) | (lmask - torch.arange(n) % rows).int()
    keys = torch.nn.functional.pad(keys, (0, -n % rows), value=-(2**31))
    return keys.view(q8.shape[0], -1, rows)


def _top(keys, k, lane_bits):
    """The k largest keys of every tile, decoded: (vals, idx) [b, tiles, k]."""
    lmask, rows = lane_bits - 1, keys.shape[2]
    top = keys.topk(k, dim=2).values
    base = (torch.arange(top.shape[1]) * rows)[None, :, None]
    valid = top > 0
    return (torch.where(valid, (top & ~lmask).view(torch.float32) - 2.0, tc.NEG_INF).numpy(),
            torch.where(valid, lmask - (top & lmask) + base, -1).int().numpy())


def _lane_survivors(keys, depth):
    """The keys the Pallas supertile kernel's `depth` lane planes keep: the
    largest positive keys of each 128-row lane of a supertile."""
    b, t, rows = keys.shape
    lanes = keys.view(b, t, rows // 128, 128)
    thr = lanes.sort(dim=2, descending=True).values[:, :, min(depth, rows // 128) - 1]
    kept = (lanes >= thr[:, :, None, :]) & (lanes > 0)
    return torch.where(kept, lanes, -(2**31)).view(b, t, rows)


def _assert_either(got, one, other):
    """Slot for slot, `got` equals `one` or `other` (values by their bits)."""
    for g, x, y in zip(got, one, other):
        g, x, y = (np.asarray(a).view(np.int32) for a in (g, x, y))
        assert ((g == x) | (g == y)).all()


def _check_b1(ops, k, tile_n, jax_out=None):
    """The port equals B1's contract bit for bit; the Pallas kernel equals
    it, or where XLA's FMA moved a key, the contract under that FMA."""
    got = _port(tc.int8_tile_topk, ops, k, tile_n)
    exact = _top(_keys(ops, tile_n, 2048), k, 2048)
    _assert_bits(got, exact)
    jax_out = _pallas_b1(*ops, k, tile_n) if jax_out is None else jax_out
    _assert_either(jax_out, exact, _top(_keys(ops, tile_n, 2048, fma=True), k, 2048))
    return got


def _check_b7i(ops, k, lbits, tile_n):
    """The port equals B7i's exact contract bit for bit; the Pallas kernel
    the exact top k_sub of the rows its lane planes keep (under either
    rounding of the shift); they differ only in supertiles where the lane
    planes dropped a row or the FMA moved a key.  `tile_n` None: held to the
    contract alone (the Pallas kernel cannot run 128-row supertiles, whose
    tiles would be narrower than its 128-row lane groups; at k_sub = 128
    its unrolled loop takes half a minute to trace).  Returns the port's output and
    the Pallas kernel's."""
    got = _port(tc.int8_super_tile_topk, ops, k, lbits)
    keys = [_keys(ops, lbits, lbits, fma) for fma in (False, True)]
    exact = _top(keys[0], k, lbits)
    _assert_bits(got, exact)
    if tile_n is None:
        return got, None
    jax_out = _pallas_b7i(*ops, k, lbits, tile_n)
    depth = tp._super_lane_depth(k, lbits // tile_n)
    kept = [_top(_lane_survivors(x, depth), k, lbits) for x in keys]
    _assert_either(jax_out, *kept)
    moved = ((kept[0][1] != exact[1]) | (kept[1][1] != exact[1])
             | (kept[0][0] != kept[1][0])).any(axis=2)
    assert not ((jax_out[1] != got[1]).any(axis=2) & ~moved).any()
    return got, jax_out


# (b, n, d, k, tile_n): every listed d, k, tile and batch, ragged last tiles.
B1_CASES = [(1, 3000, 16, 1, 64), (65, 5000, 48, 17, 1024), (130, 4500, 128, 16, 2048),
            (65, 2100, 384, 64, 2048), (8192, 2100, 128, 10, 2048),
            (3, 3000, 768, 128, 1024), (65, 1000, 16, 64, 64)]


@pytest.mark.parametrize("b,n,d,k,tile_n", B1_CASES)
def test_b1_plain_equals_pallas_at_edge_shapes(b, n, d, k, tile_n):
    _check_b1(_inputs(b, n, d, seed=b + n + d + k), k, tile_n)


# (b, n, d, k_sub, lbits, tile_n): 128-row supertiles (the port's
# narrowest; the Pallas route's are 512 rows or more), 512-row ones of two
# 256-row tiles, and 8192-row ones; tile_n None: the contract alone.
B7I_CASES = [(65, 3000, 48, 16, 128, None), (1, 700, 16, 64, 128, None),
             (130, 1000, 768, 17, 128, None), (65, 3000, 48, 16, 512, 256),
             (1, 1300, 16, 64, 512, 256), (130, 9000, 384, 10, 8192, 2048),
             (3, 9000, 128, 1, 8192, 2048), (65, 9000, 128, 128, 8192, None)]


@pytest.mark.parametrize("b,n,d,k,lbits,tile_n", B7I_CASES)
def test_b7i_plain_equals_pallas_at_edge_shapes(b, n, d, k, lbits, tile_n):
    _check_b7i(_inputs(b, n, d, seed=b + n + d + k + 1), k, lbits, tile_n)


@pytest.mark.parametrize("kernel,k,rows", [("b1", 10, 2048), ("b1", 64, 2048),
                                           ("b7i", 16, 8192), ("b7i", 64, 8192)])
def test_filter_leaving_fewer_than_k_rows(kernel, k, rows):
    """Three valid rows in the first tile (supertile): its other slots are
    (-1e30, -1) fillers, on the Pallas kernel as in the plain version."""
    ops = _inputs(64, 9000, 384, seed=k + rows)
    mask = ops[4]
    mask[:rows] = False
    mask[[5, 700, 2000]] = True
    if kernel == "b1":
        got = _check_b1(ops, k, rows)
    else:
        got, jax_out = _check_b7i(ops, k, rows, 2048)
        _assert_bits((jax_out[0][:, :1], jax_out[1][:, :1]), (got[0][:, :1], got[1][:, :1]))
    np.testing.assert_array_equal(np.sort(got[1][:, 0, :3], axis=1),
                                  np.tile([5, 700, 2000], (64, 1)))
    assert (got[1][:, 0, 3:] == -1).all() and (got[0][:, 0, 3:] == np.float32(-1e30)).all()


@pytest.mark.parametrize("kernel,k,rows", [("b1", 64, 1024), ("b7i", 17, 8192)])
def test_all_tied_rows_give_the_lowest_indices(kernel, k, rows):
    ops = _inputs(65, 9000, 128, seed=3, tied=True)
    ops = ops[:4] + (np.ones(9000, bool),)
    if kernel == "b1":
        got = _check_b1(ops, k, rows)
    else:
        got, jax_out = _check_b7i(ops, k, rows, 2048)
        _assert_bits(jax_out, got)
    tiles = -(-9000 // rows)
    want = np.arange(tiles)[:, None] * rows + np.arange(k)
    np.testing.assert_array_equal(got[1], np.broadcast_to(want, (65, tiles, k)))


@pytest.mark.parametrize("super_tiles", [1, 4])
@pytest.mark.parametrize("b,d", [(1, 128), (65, 384)])
def test_cosine_top_k_int8_equals_pallas_route(b, d, super_tiles):
    """The whole selection and merge against `pallas_cosine_top_k_int8`
    (its k-pass branch, or its supertiles, which need the two-level
    selection), on every query where neither a lane drop nor XLA's FMA
    moved a key."""
    n, k, merge_k, tile_n = 20_000, 10, 32, 2048
    _, _, e8, es, mask = _inputs(b, n, d, seed=b + d + super_tiles)
    rng = np.random.default_rng(b)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jv, ji = tp.pallas_cosine_top_k_int8(
        jnp.asarray(q), jnp.asarray(e8), jnp.asarray(es), jnp.asarray(mask), k,
        tile_n=tile_n, packed_select=True, merge_k=merge_k, super_tiles=super_tiles,
        two_level=None if super_tiles > 1 else False, interpret=True)
    tv, ti = tc.cosine_top_k_int8(torch.from_numpy(q), torch.from_numpy(e8),
                                  torch.from_numpy(es), torch.from_numpy(mask), k,
                                  tile_n=tile_n, merge_k=merge_k, super_tiles=super_tiles)
    ji, jv = np.asarray(ji), np.asarray(jv)
    same = (ji == ti.numpy()).all(axis=1)
    assert same.sum() >= b - max(1, b // 8)  # lane drops and FMA moves are rare
    np.testing.assert_array_equal(tv.numpy()[same].view(np.int32), jv[same].view(np.int32))


@pytest.mark.parametrize("elem_bytes", [1, 2])
def test_tc_sizing_fits_for_the_block_the_wrapper_picks(elem_bytes):
    """For every d up to 768 the kernels take (int8: multiples of 16; bf16:
    of 64) and every k up to 128, the block the wrapper sizes (128 queries
    where they fit, else 64) fits one block's shared memory; int8 rows up
    to 768 always take 128 queries."""
    step = 16 if elem_bytes == 1 else 64
    for d in range(step, 769, step):
        for k in range(1, 129):
            qb = tc.tc_block_queries(d, k, elem_bytes)
            assert qb in (64, 128), (d, k)
            assert tc.tc_smem_bytes(qb, d, k, elem_bytes) <= 232_448, (d, k)
            if elem_bytes == 1:
                assert qb == 128, (d, k)


def test_tc_sizing_counts_whole_chunks():
    """A row of 48 int8 columns takes a whole 128-byte chunk of the query
    block; 1040 columns take 9.  Past 128 queries' fit, 64 are picked."""
    ring = 4 * (64 * 128 + 16)
    assert tc.tc_smem_bytes(128, 48, 10, 1) == 1024 + 128 * 128 + ring + 4 * (128 * 75)
    assert tc.tc_smem_bytes(64, 1040, 128, 1) == 1024 + 64 * 1152 + ring + 4 * (64 * 193)
    assert tc.tc_block_queries(1040, 128, 1) == 64
    assert tc.tc_smem_bytes(128, 384, 10) == tc.tc_smem_bytes(128, 768, 10, 1)


@pytest.mark.parametrize("name", ["int8_tile_topk", "int8_exact_tile_topk",
                                  "int8_super_tile_topk"])
def test_int8_wrappers_refuse_rows_past_1040(name):
    """127^2 * 1056 >= 2^24: fp32(dot) would no longer be exact.  1040
    columns still run."""
    rng = np.random.default_rng(0)
    for d, ok in ((1040, True), (1056, False)):
        q8 = torch.from_numpy(rng.integers(-127, 128, (2, d), dtype=np.int8))
        e8 = torch.from_numpy(rng.integers(-127, 128, (300, d), dtype=np.int8))
        args = (q8, torch.ones(2), e8, torch.ones(300), torch.ones(300, dtype=torch.bool), 4,
                128)
        if ok:
            v, _ = getattr(tc, name)(*args)
            assert v.shape[0] == 2
        else:
            with pytest.raises(ValueError, match="1040"):
                getattr(tc, name)(*args)
