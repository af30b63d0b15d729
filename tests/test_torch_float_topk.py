"""Kernels B4 (`float_tile_topk`) and B5 (`float_packed_tile_topk`) of the
PyTorch port, through `cosine_top_k`, against the JAX package's
`pallas_cosine_top_k` run in interpret mode (its exhaustive branches).  On
the CPU the port's wrappers run their kernels' plain versions, so these
tests hold the plain versions to the Pallas kernels' contracts; the chip
smoke run and tests/test_torch_cuda.py hold the CUDA kernels to the plain
versions.

Tolerances: the two sides take their f32 dot sums in another order.  B4's
values agree to atol 1e-6 and its indices exactly, once the seed is checked
to put no two competing scores within 1e-6 of each other.  B5's keys are
compared exactly, once the seed is checked to put no competing score within
1e-6 of a key-quantum boundary (a seed that fails a check is a bad seed,
not a fault)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcrag_tpu.ops.topk_pallas import pallas_cosine_top_k
from hcrag_tpu_torch.convert import _tensor
from hcrag_tpu_torch.ops import topk_cuda

N, D, B, K = 5000, 128, 4, 10


def _inputs(seed, dtype, mask_frac=0.2, zero_queries=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((N, D)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:zero_queries] = 0.0
    mask = rng.random(N) >= mask_frac
    if dtype == "bfloat16":
        e = np.asarray(jnp.asarray(e).astype(jnp.bfloat16))
    return q, e, mask


def _exact_scores(q, e, mask):
    """float64 dots of the operands the kernels see (bf16 queries for a
    bf16 bank); filtered rows at -inf."""
    e64 = np.asarray(e, np.float32).astype(np.float64)
    if e.dtype != np.float32:
        q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16), np.float32)
    s = np.asarray(q, np.float64) @ e64.T
    return np.where(mask[None, :], s, -np.inf)


def _both(q, e, mask, tile, *, packed, merge_k=0, top_k=K):
    jv, ji = pallas_cosine_top_k(
        jnp.asarray(q), jnp.asarray(e), jnp.asarray(mask), top_k, tile_n=tile,
        packed_select=packed, two_level=False, merge_k=merge_k, interpret=True,
    )
    tv, ti = topk_cuda.cosine_top_k(
        torch.from_numpy(q), _tensor(e), torch.from_numpy(mask), top_k,
        tile_n=tile, packed_select=packed, merge_k=merge_k,
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [1024, 2048])
def test_b4_with_merge_equals_pallas(tile, dtype):
    """n=5000 leaves a ragged last tile; a fifth of the rows are masked."""
    q, e, mask = _inputs(tile, dtype)
    top = -np.sort(-_exact_scores(q, e, mask), axis=1)[:, : K + 1]
    assert (np.diff(-top, axis=1) > 1e-6).all(), "bad seed: near-tied scores"
    (jv, ji), (tv, ti) = _both(q, e, mask, tile, packed=False)
    assert tv.shape == (B, K) and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)
    assert mask[ti].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b4_zero_query_gives_lowest_rows(dtype):
    """A zero query ties every valid row at 0: the lowest valid rows win,
    with the value +0.0."""
    q, e, mask = _inputs(3, dtype, mask_frac=0.0, zero_queries=2)
    (jv, ji), (tv, ti) = _both(q, e, mask, 1024, packed=False)
    np.testing.assert_array_equal(ti[:2], np.tile(np.arange(K), (2, 1)))
    np.testing.assert_array_equal(ti, ji)
    assert (tv[:2] == 0.0).all() and not np.signbit(tv[:2]).any()
    np.testing.assert_allclose(tv, jv, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b4_filter_with_fewer_than_k_rows(dtype):
    """A filter that keeps 3 rows: they come first, then slots at exactly
    -1e30 that all name row 0.  The Pallas kernel removes each pick by
    writing -1e30 over it, so once a tile's valid rows are gone every pass
    returns the tile's first row; the stable merge takes tile 0's first."""
    q, e, _ = _inputs(4, dtype)
    mask = np.zeros(N, bool)
    mask[[7, 2500, 4999]] = True
    (jv, ji), (tv, ti) = _both(q, e, mask, 1024, packed=False)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.sort(ti[:, :3], axis=1), np.tile([7, 2500, 4999], (B, 1)))
    np.testing.assert_array_equal(ti[:, 3:], np.zeros((B, K - 3), np.int32))
    assert (tv[:, 3:] == np.float32(-1e30)).all() and (jv[:, 3:] == np.float32(-1e30)).all()
    np.testing.assert_allclose(tv[:, :3], jv[:, :3], atol=1e-6, rtol=0)


def _near_quantum_boundary(s):
    """Shifted scores s + 2 within 1e-6 of a multiple of their key quantum
    (the f32 ulp times 2^11)."""
    x = s + 2.0
    quantum = np.where(x >= 2.0, 2.0**-11, 2.0**-12)
    return np.abs(x - np.round(x / quantum) * quantum) < 1e-6


def _boundary_ok(q, e, mask, tile):
    """The boundary rule: no row that a tile selects, or that lies within
    1e-3 (two key quanta) below the tile's k-th pick, has a score within
    1e-6 of a key-quantum boundary.  Other rows cannot move in the order."""
    s = _exact_scores(q, e, mask)
    et = _tensor(e)
    _, ti = topk_cuda.float_packed_tile_topk_plain(
        torch.from_numpy(q).to(et.dtype), et, torch.from_numpy(mask), K, tile
    )
    for b, t in np.ndindex(ti.shape[:2]):
        sel = ti[b, t][ti[b, t] >= 0].numpy()
        if not len(sel):
            continue
        rows = s[b, t * tile:(t + 1) * tile]
        involved = rows[np.isfinite(rows) & (rows >= s[b, sel].min() - 1e-3)]
        if _near_quantum_boundary(involved).any():
            return False
    return True


def _good_inputs(seed, dtype, tile, **kw):
    """The first seed from `seed` on whose inputs the boundary rule holds."""
    for s in range(seed, seed + 40):
        q, e, mask = _inputs(s, dtype, **kw)
        if _boundary_ok(q, e, mask, tile):
            return q, e, mask
    raise AssertionError("no seed in 40 meets the boundary rule")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [1024, 2048])
def test_b5_with_merge_equals_pallas(tile, dtype):
    """The packed selection at merge_k=32 (the engine's oversample): pools
    of 5 x 10 and 3 x 11 candidates (the pick count rises to cover 32)."""
    q, e, mask = _good_inputs(10 + tile, dtype, tile)
    (jv, ji), (tv, ti) = _both(q, e, mask, tile, packed=True, merge_k=32)
    assert tv.shape == (B, 32)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert mask[ti].all()


def test_b5_pick_count_raise_and_fillers():
    """Two tiles of 2048 cannot give 32 candidates at k=10: each tile picks
    16, and a filter that leaves 2 rows in the last tile leaves fillers."""
    for seed in range(7, 47):
        rng = np.random.default_rng(seed)
        n = 2100
        e = rng.standard_normal((n, D)).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        q = rng.standard_normal((3, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        mask = np.ones(n, bool)
        mask[2050:] = False
        s = np.where(mask[None], q.astype(np.float64) @ e.T.astype(np.float64), -np.inf)
        top17 = -np.sort(-s[:, :2048], axis=1)[:, :17]
        rows = np.concatenate([top17, s[:, 2048:2050]], axis=1)
        if not _near_quantum_boundary(rows).any():
            break
    else:
        raise AssertionError("no seed in 40 meets the boundary rule")
    assert topk_cuda.tile_pick_count(K, n, 2048, 32) == 16
    (jv, ji), (tv, ti) = _both(q, e, mask, 2048, packed=True, merge_k=32)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal((ti == -1).sum(axis=1), [14, 14, 14])
    assert (tv[ti == -1] == np.float32(-1e30)).all()


def test_top_k_limit_and_whole_index():
    """top_k above 128 raises on every device; top_k == n at n <= 128
    returns every row."""
    rng = np.random.default_rng(8)
    e = rng.standard_normal((200, D)).astype(np.float32)
    q = rng.standard_normal((2, D)).astype(np.float32)
    mask = np.ones(200, bool)
    with pytest.raises(ValueError, match="128"):
        topk_cuda.cosine_top_k(torch.from_numpy(q), torch.from_numpy(e),
                               torch.from_numpy(mask), 129)
    v, i = topk_cuda.cosine_top_k(torch.from_numpy(q), torch.from_numpy(e[:100]),
                                  torch.from_numpy(mask[:100]), 100)
    assert sorted(i[0].tolist()) == list(range(100)) and v.shape == (2, 100)


def test_float_wrappers_refuse_other_devices():
    meta = torch.zeros((2, 64), device="meta")
    mask = torch.zeros((2,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        topk_cuda.float_tile_topk(meta, meta, mask, 1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        topk_cuda.float_packed_tile_topk(meta, meta, mask, 1)


def test_card_checks_accept_equal_and_reject_faults():
    """The card comparisons of `hcrag_tpu_torch.testing` pass equal outputs
    and refuse an index moved away from a near-tie or a key moved away from
    a quantum boundary."""
    from hcrag_tpu_torch.testing import check_exact_topk, check_packed_topk

    q, e, mask = (torch.from_numpy(a) for a in _inputs(30, "float32"))
    pv, pi = topk_cuda.float_tile_topk_plain(q, e, mask, K, 1024)
    assert check_exact_topk(pv.clone(), pi.clone(), pv, pi, q, e, mask) == (0.0, 0)
    bad = pi.clone()
    bad[0, 0, 0] = bad[0, 0, 5]
    with pytest.raises(AssertionError, match="near-tie"):
        check_exact_topk(pv, bad, pv, pi, q, e, mask)
    with pytest.raises(AssertionError, match="values differ"):
        check_exact_topk(pv + 1e-3, pi, pv, pi, q, e, mask)

    pv, pi = topk_cuda.float_packed_tile_topk_plain(q, e, mask, K, 1024)
    assert check_packed_topk(pv.clone(), pi.clone(), pv, pi, q, e) == (0.0, 0)
    kv = pv.clone()
    kv[1, 2, 3] += 2.0**-11
    with pytest.raises(AssertionError, match="boundary"):
        check_packed_topk(kv, pi, pv, pi, q, e)


def test_bounds_cover_every_tpu_kernel():
    """`utils/bounds.py` gives a bound for every B1-B8 kernel; the ported
    ones match the paths' shapes (`chip_smoke.py` computes the same)."""
    from hcrag_tpu_torch.utils.bounds import table

    rows = {(r["id"], r["kernel"]): r for r in table()}
    assert {kid for kid, _ in rows} == {f"B{i}" for i in range(1, 9)}
    assert all(r["bound_ms"] > 0 for r in rows.values())
    by_id = {kid: r for (kid, _), r in rows.items()}
    for kid, ms, by in (("B1", 3.184, "operations"), ("B2", 0.0510, "bytes"),
                        ("B3", 7.948, "operations"),
                        ("B4", 11.755, "operations"), ("B5", 6.371, "operations"),
                        ("B8", 0.398, "operations")):
        assert by_id[kid]["bound_ms"] == pytest.approx(ms, rel=1e-3), kid
        assert by_id[kid]["bound_by"] == by, kid
