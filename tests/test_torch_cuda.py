"""The port's CUDA kernels against their plain PyTorch versions, and the
engine on the card against the engine on the CPU.  CUDA kernels have no
interpret mode, so these tests need an NVIDIA GPU with nvcc (sm_90a) and
skip without one; run them there with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hcrag_tpu_torch.ops import topk_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _b1_inputs(b, n, d, seed, dev, tied=False):
    from hcrag_tpu_torch.ops.quantize import quantize_queries, quantize_rows

    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    if tied:
        e[:] = e[0]
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = e[rng.integers(0, n, size=b)] if tied else rng.standard_normal((b, d))
    q = torch.from_numpy(np.asarray(q, np.float32)).to(dev)
    q8, qs = quantize_queries(torch.nn.functional.normalize(q, dim=1))
    e8, es = quantize_rows(e)
    mask = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    return q8, qs, torch.from_numpy(e8).to(dev), torch.from_numpy(es).to(dev), mask


# B1 and B7i run on the int8 tensor cores, and int32 sums are exact in any
# order, so both equal their plain versions bit for bit on random inputs.
# Past the first cases, the loop's edge shapes: k 1-16 take the register
# lists, 17-128 the shared-memory lists; d of 16 and 48 leave most of a
# 128-column chunk to the zero fill; tiles of 64-2048 rows and supertiles
# of 128 and 8192; batches of 1 to 8192 (ragged query blocks); ragged last
# tiles; d = 768 at k = 128 is the widest block that still takes 128
# queries.
INT8_TC_TILE = [(1, 3000, 16, 1, 64), (65, 9000, 48, 10, 1024), (130, 4500, 128, 16, 2048),
                (130, 5000, 384, 17, 2048), (65, 3000, 768, 64, 1024),
                (8192, 2100, 384, 10, 2048), (70, 4100, 128, 128, 2048),
                (130, 9000, 16, 64, 64), (130, 5000, 768, 128, 2048)]
INT8_TC_SUPER = [(65, 5000, 48, 16, 128), (130, 20_000, 384, 10, 8192),
                 (1, 9000, 768, 128, 8192), (8192, 9000, 128, 17, 8192),
                 (130, 3000, 16, 64, 128), (65, 20_000, 384, 1, 8192)]


@pytest.mark.parametrize(
    "b,n,d,k,tile",
    [(5, 5000, 128, 10, 1024), (70, 9000, 384, 16, 2048),
     (64, 4096, 128, 128, 2048), (130, 2100, 384, 33, 2048)] + INT8_TC_TILE,
)
def test_int8_tile_topk_equals_plain(cuda, b, n, d, k, tile):
    args = _b1_inputs(b, n, d, seed=b + k, dev=cuda)
    kv, ki = topk_cuda.int8_tile_topk(*args, k, tile_n=tile)
    pv, pi = topk_cuda.int8_tile_topk_plain(*args, k, tile_n=tile)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_int8_tile_topk_all_tied(cuda):
    args = _b1_inputs(8, 3000, 128, seed=1, dev=cuda, tied=True)
    args = args[:4] + (torch.ones_like(args[4]),)
    kv, ki = topk_cuda.int8_tile_topk(*args, 10, tile_n=1024)
    want = torch.arange(3, device=cuda)[:, None] * 1024 + torch.arange(10, device=cuda)
    assert torch.equal(ki, want.expand(8, 3, 10).to(torch.int32))


@pytest.mark.parametrize(
    "b,tiles,k,out_k",
    [(33, 489, 10, 32), (4, 10, 10, 100), (9, 100, 10, 7), (3, 4883, 10, 32),
     (3, 4883, 12, 32), (2, 20_000, 128, 128)],
)
def test_packed_candidate_merge_equals_plain(cuda, b, tiles, k, out_k):
    rng = np.random.default_rng(tiles * k)
    v = (rng.standard_normal((b, tiles, k)) * 0.1).astype(np.float32)
    v[:, -tiles // 10:] = -1e30
    v[0] = 0.25  # one row of ties
    i = rng.integers(0, 1 << 20, size=(b, tiles, k)).astype(np.int32)
    v, i = torch.from_numpy(v).to(cuda), torch.from_numpy(i).to(cuda)
    kv, ki = topk_cuda.packed_candidate_merge(v, i, out_k)
    pv, pi = topk_cuda.packed_candidate_merge_plain(v, i, out_k)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def _float_inputs(b, n, d, seed, dev, dtype, mask_frac=0.1):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    mask = torch.from_numpy(rng.random(n) >= mask_frac).to(dev)
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(e).to(dev, dtype),
            mask)


FLOAT_CASES = [(5, 5000, 128, 10, 1024), (70, 9000, 384, 16, 2048),
               (64, 4096, 128, 128, 2048), (130, 2100, 384, 33, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k,tile", FLOAT_CASES)
def test_float_tile_topk_equals_plain(cuda, b, n, d, k, tile, dtype):
    from hcrag_tpu_torch.testing import check_exact_topk

    q, e, mask = _float_inputs(b, n, d, b + k, cuda, dtype)
    kv, ki = topk_cuda.float_tile_topk(q, e, mask, k, tile_n=tile)
    pv, pi = topk_cuda.float_tile_topk_plain(q, e, mask, k, tile_n=tile)
    torch.cuda.synchronize()
    check_exact_topk(kv, ki, pv, pi, q, e, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k,tile", FLOAT_CASES)
def test_float_packed_tile_topk_equals_plain(cuda, b, n, d, k, tile, dtype):
    from hcrag_tpu_torch.testing import check_packed_topk

    q, e, mask = _float_inputs(b, n, d, b + k, cuda, dtype)
    kv, ki = topk_cuda.float_packed_tile_topk(q, e, mask, k, tile_n=tile)
    pv, pi = topk_cuda.float_packed_tile_topk_plain(q, e, mask, k, tile_n=tile)
    torch.cuda.synchronize()
    check_packed_topk(kv, ki, pv, pi, q, e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_float_tile_topk_ties_and_fills_exact(cuda, dtype):
    """A zero query ties every row at +0.0 (the lowest rows win); a filter
    with 3 valid rows leaves the rest of each tile's slots at (-1e30, the
    tile's first row).  Both exact."""
    q, e, _ = _float_inputs(8, 3000, 128, 2, cuda, dtype)
    q[:4] = 0
    mask = torch.zeros(3000, dtype=torch.bool, device=cuda)
    mask[[5, 1500, 2999]] = True
    kv, ki = topk_cuda.float_tile_topk(q, e, torch.ones_like(mask), 10, tile_n=1024)
    want = torch.arange(3, device=cuda)[:, None] * 1024 + torch.arange(10, device=cuda)
    assert torch.equal(ki[:4], want.expand(4, 3, 10).to(torch.int32))
    assert bool((kv[:4] == 0).all()) and not bool(torch.signbit(kv[:4]).any())
    kv, ki = topk_cuda.float_tile_topk(q, e, mask, 10, tile_n=1024)
    pv, pi = topk_cuda.float_tile_topk_plain(q, e, mask, 10, tile_n=1024)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv[:, :, 1:], pv[:, :, 1:])
    assert bool((kv[:, :, 1:] == -1e30).all())
    assert torch.equal(ki[:, :, 1:], (torch.arange(3, device=cuda) * 1024)[None, :, None]
                       .expand(8, 3, 9).to(torch.int32))


def _dyadic_inputs(b, n, d, seed, dev, dtype, mask_frac=0.1):
    """Float operands that are multiples of 1/64 (|x| <= 6/64): every dot is
    exact in f32 in any summation order, so B7f and its plain version see
    the same keys."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-6, 7, (b, d)) / 64).to(dev, dtype)
    e = torch.from_numpy(rng.integers(-6, 7, (n, d)) / 64).to(dev, dtype)
    return q, e, torch.from_numpy(rng.random(n) >= mask_frac).to(dev)


# (b, n, d, k_sub, lbits): three supertiles with a ragged last one; 8192-row
# supertiles at k_sub 128 and ragged queries; one ragged supertile.
SUPER_CASES = [(70, 9000, 384, 16, 2048), (64, 20_000, 128, 16, 4096),
               (130, 20_000, 384, 128, 8192), (5, 3000, 128, 32, 8192)]


@pytest.mark.parametrize("b,n,d,k,lbits", SUPER_CASES + INT8_TC_SUPER)
def test_int8_super_tile_topk_equals_plain(cuda, b, n, d, k, lbits):
    args = _b1_inputs(b, n, d, seed=b + k + 2, dev=cuda)
    kv, ki = topk_cuda.int8_super_tile_topk(*args, k, lbits)
    pv, pi = topk_cuda.int8_super_tile_topk_plain(*args, k, lbits)
    torch.cuda.synchronize()
    assert kv.shape == (b, -(-n // lbits), k)
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k,lbits", SUPER_CASES)
def test_float_packed_super_tile_topk_equals_plain(cuda, b, n, d, k, lbits, dtype):
    """Bit for bit on exact dots; on normal inputs by `check_packed_topk`'s
    rule for an lbits-wide lane field."""
    from hcrag_tpu_torch.testing import check_packed_topk

    q, e, mask = _dyadic_inputs(b, n, d, b + k, cuda, dtype)
    kv, ki = topk_cuda.float_packed_super_tile_topk(q, e, mask, k, lbits)
    pv, pi = topk_cuda.float_packed_super_tile_topk_plain(q, e, mask, k, lbits)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    q, e, mask = _float_inputs(b, n, d, b + k, cuda, dtype)
    kv, ki = topk_cuda.float_packed_super_tile_topk(q, e, mask, k, lbits)
    pv, pi = topk_cuda.float_packed_super_tile_topk_plain(q, e, mask, k, lbits)
    torch.cuda.synchronize()
    check_packed_topk(kv, ki, pv, pi, q, e, lane_bits=lbits)


SUPER_MODES = {
    "exact_rescore": (dict(exact_rescore=32, pallas_super=8), "float_packed_super_tile_topk"),
    "int8_f32_rescore": (dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True,
                              pallas_super=4), "int8_super_tile_topk"),
    "int8_bf16_rescore": (dict(quantize_int8=True, int8_rescore=32, pallas_super=4),
                          "int8_super_tile_topk"),
    "int8_residual": (dict(quantize_int8=True, int8_residual=True, int8_rescore=32,
                           pallas_super=4), "int8_super_tile_topk"),
}


@pytest.mark.parametrize("mode", list(SUPER_MODES))
def test_super_engine_on_card_equals_engine_on_cpu(cuda, mode):
    """Each rescored mode with supertiles launches its B7 kernel once (and
    neither B1 nor B5) and equals the CPU engine."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    opts, kernel = SUPER_MODES[mode]
    index, graph = synthetic_setup(20_000, 384, graph_degree=4)
    q = np.random.default_rng(5).standard_normal((64, 384)).astype(np.float32)
    names = (kernel, "int8_tile_topk", "float_packed_tile_topk")
    before = [getattr(topk_cuda, name).launches for name in names]
    rg = QueryEngine(index, graph, device=cuda, ell_max_degree=8, **opts).query_batch(
        q, top_k=10)
    after = [getattr(topk_cuda, name).launches for name in names]
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]
    rc = QueryEngine(index, graph, device="cpu", ell_max_degree=8, **opts).query_batch(
        q, top_k=10)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5, rtol=0)


@pytest.mark.parametrize("depth", [2, 3])
def test_deep_expansion_on_card_equals_cpu(cuda, depth):
    """top_k=10 seeds and max_expanded=100: the second (and third) hop runs
    over the ANNOTATION table on the card as on the CPU."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, 384, graph_degree=8)
    opts = dict(ell_max_degree=8, exact_rescore=32)
    q = np.random.default_rng(depth).standard_normal((64, 384)).astype(np.float32)
    kw = dict(top_k=10, expansion_depth=depth, max_expanded=100)
    rg = QueryEngine(index, graph, device=cuda, **opts).query_batch(q, **kw)
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, **kw)
    assert (rc.expanded_counts > 80).all()
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5, rtol=0)


FIELDS = ("top_scores", "top_indices", "relevance", "combined",
          "expanded_nodes", "expanded_counts", "expanded_relevance")


FLOAT_MODES = {"int8": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True),
               "f32": dict(), "rescore": dict(exact_rescore=32)}


@pytest.mark.parametrize("mode", ["f32", "rescore"])
def test_float_engine_on_card_equals_engine_on_cpu(cuda, mode):
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, 384, graph_degree=4)
    opts = dict(ell_max_degree=8, **FLOAT_MODES[mode])
    q = np.random.default_rng(1).standard_normal((64, 384)).astype(np.float32)
    gpu = QueryEngine(index, graph, device=cuda, **opts)
    assert gpu.resolved_kernel_config(64)["kernel"] in (
        "float_tile_topk", "float_packed_tile_topk")
    rg = gpu.query_batch(q, top_k=10)
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, top_k=10)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def small_engines(cuda):
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, 384, graph_degree=4)
    opts = dict(ell_max_degree=8, **FLOAT_MODES["int8"])
    q = np.random.default_rng(0).standard_normal((64, 384)).astype(np.float32)
    return (QueryEngine(index, graph, device=cuda, **opts),
            QueryEngine(index, graph, device="cpu", **opts), q)


def test_engine_on_card_equals_engine_on_cpu(small_engines):
    gpu, cpu, q = small_engines
    rg = gpu.query_batch(q, top_k=10)
    rc = cpu.query_batch(q, top_k=10)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5, rtol=0)


def test_engine_on_card_ignores_tf32(small_engines):
    """The step takes no f32 matrix product, so enabling TF32 changes no
    bit of its outputs."""
    gpu, _, q = small_engines
    want = gpu.query_batch(q, top_k=10)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        got = gpu.query_batch(q, top_k=10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


B3E_CASES = [(5, 5000, 128, 10, 1024), (70, 9000, 384, 16, 2048),
             (64, 4096, 128, 128, 2048), (130, 2100, 384, 33, 2048)]


@pytest.mark.parametrize("b,n,d,k,tile", B3E_CASES)
def test_int8_exact_tile_topk_equals_plain(cuda, b, n, d, k, tile):
    args = _b1_inputs(b, n, d, seed=b + k + 1, dev=cuda)
    kv, ki = topk_cuda.int8_exact_tile_topk(*args, k, tile_n=tile)
    pv, pi = topk_cuda.int8_exact_tile_topk_plain(*args, k, tile_n=tile)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def test_int8_exact_tile_topk_fills_ties_and_zero_query(cuda):
    """A filter that leaves 3 rows fills each tile's other slots with
    (-1e30, the tile's first row); tied rows and a zero query give the
    lowest rows.  All bit-equal to the plain version."""
    q8, qs, e8, es, _ = _b1_inputs(8, 3000, 128, seed=3, dev=cuda, tied=True)
    q8[:2] = 0
    qs[:2] = 0
    mask = torch.zeros(3000, dtype=torch.bool, device=cuda)
    mask[[5, 1500, 2999]] = True
    for m in (mask, torch.ones_like(mask)):
        kv, ki = topk_cuda.int8_exact_tile_topk(q8, qs, e8, es, m, 10, tile_n=1024)
        pv, pi = topk_cuda.int8_exact_tile_topk_plain(q8, qs, e8, es, m, 10, tile_n=1024)
        torch.cuda.synchronize()
        assert torch.equal(ki, pi)
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))
    base = (torch.arange(3, device=cuda) * 1024)[None, :, None]
    want = (base + torch.arange(10, device=cuda)).expand(8, 3, 10).to(torch.int32)
    assert torch.equal(ki, want)
    kv, ki = topk_cuda.int8_exact_tile_topk(q8, qs, e8, es, mask, 10, tile_n=1024)
    assert bool((kv[:, :, 1:] == -1e30).all())
    assert torch.equal(ki[:, :, 1:], base.expand(8, 3, 9).to(torch.int32))


def _b6_inputs(b, n, seed, dev, d=384, w=8):
    from hcrag_tpu_torch.core.types import PRIORITY_MATRIX

    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    qb = (rng.integers(0, 2**32, (b, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (b, w), dtype=np.uint32))
    nb = (rng.integers(0, 2**32, (n, w), dtype=np.uint32)
          & rng.integers(0, 2**32, (n, w), dtype=np.uint32))
    qb[::2] = 0  # entity-less queries: the 0.5 / 0.1 rules
    nb[::7] = 0
    qc = np.unpackbits(qb.view(np.uint8), axis=1).sum(axis=1).astype(np.int32)
    nc = np.unpackbits(nb.view(np.uint8), axis=1).sum(axis=1).astype(np.int32)
    arrays = (q, qb.view(np.int32), qc, rng.integers(0, 5, b).astype(np.int32), e,
              nb.view(np.int32), nc, rng.integers(0, 6, n).astype(np.int32),
              np.array([0.3, 0.45, 0.15, 0.1], np.float32), PRIORITY_MATRIX,
              rng.uniform(0, 1, (b, n)).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


# Both regimes of B6: up to 16 queries the byte-bound kernel at query
# blocks of 1-16 (path R is 1 x 2048-32768), past 16 the tiled loop
# (256 x 8192 is the ablation shape), with ragged last node and query
# blocks; d = 383 reads scalars in (a) and sends 300 queries to (a) at 16
# a block; W = 1 and a W past the tiled loop's shared memory.
B6_SHAPES = [(1, 8192, 384, 8, 0, True), (1, 2048, 384, 8, 0, True),
             (1, 32768, 384, 8, 0, True), (256, 8192, 384, 8, 0, True),
             (256, 8192, 384, 8, 1, False), (256, 8192, 384, 8, 0, False),
             (3, 8191, 384, 8, 0, False), (17, 700, 384, 8, 1, True),
             (2, 999, 383, 8, 0, True), (8, 4097, 384, 1, 1, True),
             (16, 3001, 1040, 8, 0, True), (300, 1001, 383, 8, 0, True),
             (130, 257, 16, 1, 1, False), (64, 300, 384, 210, 0, True),
             (5, 100, 7, 3, 0, True)]


@pytest.mark.parametrize("b,n,d,w,reduction,with_llm", B6_SHAPES)
def test_batch_relevance_equals_plain(cuda, b, n, d, w, reduction, with_llm):
    from hcrag_tpu_torch.ops import scoring_cuda

    args = _b6_inputs(b, n, seed=b + n, dev=cuda, d=d, w=w)
    if not with_llm:
        args[-1] = None
    plan = scoring_cuda.launch_plan(args[0], args[4], w)
    assert plan.regime == ("tiled" if b > 16 and d % 8 == 0 and w < 200 else "few")
    before = scoring_cuda.batch_relevance.launches
    got = scoring_cuda.batch_relevance(*args, reduction=reduction)
    want = scoring_cuda.batch_relevance_plain(*args, reduction=reduction)
    torch.cuda.synchronize()
    assert scoring_cuda.batch_relevance.launches == before + 1
    assert got.shape == (b, n)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("b", [1, 64])
def test_batch_relevance_entity_ratio_is_exact(cuda, b):
    """With weights (0, 0, 1, 0) a score is the entity ratio alone, so both
    regimes' division (the fast path of div.rn, without its slow-path call)
    must give the plain version's correctly rounded quotient bit for bit,
    over query counts 1 to 4000 and every overlap of 8 words."""
    from hcrag_tpu_torch.ops import scoring_cuda

    args = _b6_inputs(b, 4096, seed=5, dev=cuda)
    rng = np.random.default_rng(6)
    args[2] = torch.from_numpy(rng.integers(1, 4000, b).astype(np.int32)).to(cuda)
    args[2][0] = 256
    args[8] = torch.tensor([0.0, 0.0, 1.0, 0.0], device=cuda)
    got = scoring_cuda.batch_relevance(*args, reduction=0)
    want = scoring_cuda.batch_relevance_plain(*args, reduction=0)
    assert torch.equal(got, want)


INT8_MODES = {
    "int8_only": dict(quantize_int8=True, int8_only=True),
    "residual": dict(quantize_int8=True, int8_residual=True, int8_rescore=32),
    "bf16_rescore": dict(quantize_int8=True, int8_rescore=32),
    "no_rescore": dict(quantize_int8=True),
}


@pytest.mark.parametrize("mode", list(INT8_MODES))
def test_int8_mode_engine_on_card_equals_engine_on_cpu(cuda, mode):
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(20_000, 384, graph_degree=4)
    opts = dict(ell_max_degree=8, **INT8_MODES[mode])
    q = np.random.default_rng(2).standard_normal((64, 384)).astype(np.float32)
    before = topk_cuda.int8_tile_topk.launches
    rg = QueryEngine(index, graph, device=cuda, **opts).query_batch(q, top_k=10)
    assert topk_cuda.int8_tile_topk.launches == before + 1
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, top_k=10)
    for f in ("top_indices", "expanded_nodes", "expanded_counts"):
        np.testing.assert_array_equal(getattr(rg, f), getattr(rc, f))
    for f in ("top_scores", "relevance", "combined", "expanded_relevance"):
        np.testing.assert_allclose(getattr(rg, f), getattr(rc, f), atol=1e-5, rtol=0)


def test_batch_isrelevant_fused_on_card(cuda):
    """From 2048 nodes on the card each multi-metric strategy is one launch
    of B6, within 1e-5 of the CPU's unfused route (a query with
    entities, where the two routes agree)."""
    from hcrag_tpu_torch.core.types import NodeInput, QueryInput, QueryIntent, ScorerType
    from hcrag_tpu_torch.ops import scoring_cuda
    from hcrag_tpu_torch.pipeline.isrelevant import batch_isRelevant

    rng = np.random.default_rng(4)
    ents = ["bike", "red", "frame", "manual", "helmet"]
    nodes = [NodeInput(f"red bike {i}", rng.standard_normal(384).astype(np.float32), {},
                       ["product", "document", "unknown"][i % 3],
                       [ents[i % 5]] if i % 4 else [])
             for i in range(2500)]
    query = QueryInput("red bike", rng.standard_normal(384).astype(np.float32),
                       ["red", "bike"], QueryIntent.PRODUCT_SEARCH)
    for st in (ScorerType.COMPOSITE, ScorerType.PARALLEL, ScorerType.ROUTER,
               ScorerType.ROUTER_ALL, ScorerType.ROUTER_TWO_SEM_LLM,
               ScorerType.ROUTER_TWO_ENT_TYPE):
        before = scoring_cuda.batch_relevance.launches
        got = batch_isRelevant(query, nodes, st)
        assert scoring_cuda.batch_relevance.launches == before + 1, st
        want = batch_isRelevant(query, nodes, st, device="cpu")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=str(st))


def _sweep_dyadic(b, n, d, seed, dev):
    """Multiples of 1/64 up to 12/64 (every dot exact in f32); query 0 is
    all 12/64 and column 5 of every 128-column group holds its negation, so
    its keys in B8c are negative."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-12, 13, (b, d)) / 64).float()
    e = torch.from_numpy(rng.integers(-12, 13, (n, d)) / 64).float()
    q[0] = 12 / 64
    e[5::128] = -q[0]
    return q.to(dev), e.to(dev, torch.bfloat16)


SWEEP_KERNELS = ("matmul_only_acc", "matmul_only_wide", "encode_level1")


@pytest.mark.parametrize("b,tile_n,tiles", [(512, 2048, 3), (200, 1024, 5), (200, 128, 40)])
@pytest.mark.parametrize("name", SWEEP_KERNELS)
def test_sweep_kernels_equal_plain_on_exact_dots(cuda, name, b, tile_n, tiles):
    from hcrag_tpu_torch.ops import sweep_cuda

    q, e = _sweep_dyadic(b, tile_n * tiles, 384, b + tile_n, cuda)
    got = getattr(sweep_cuda, name)(q, e, tile_n)
    want = getattr(sweep_cuda, name + "_plain")(q, e, tile_n)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("tile_n", [2048, 128])
@pytest.mark.parametrize("name", SWEEP_KERNELS)
def test_sweep_kernels_agree_with_plain_on_normal_inputs(cuda, name, tile_n):
    from hcrag_tpu_torch.ops import sweep_cuda
    from hcrag_tpu_torch.testing import check_level1

    q, e, _ = _float_inputs(300, 4 * 2048, 384, tile_n, cuda, torch.float32)
    e = e.to(torch.bfloat16)
    got = getattr(sweep_cuda, name)(q, e, tile_n)
    want = getattr(sweep_cuda, name + "_plain")(q, e, tile_n)
    torch.cuda.synchronize()
    if name == "encode_level1":
        check_level1(got, want, q.to(torch.bfloat16), e, tile_n)
    else:
        assert float((got - want).abs().max()) <= 1e-5


def test_sweep_acc_keeps_every_dot(cuda):
    """B8a over the same bank at tile_n 2048 (128 of every 2048 columns reach
    the output) and 128 (all of them): the same dots, so within 20% in time;
    a kernel that dropped the dead columns' dots would be ~16x faster."""
    from hcrag_tpu_torch.ops import sweep_cuda
    from hcrag_tpu_torch.utils.timing import device_time

    q, e = _sweep_dyadic(512, 64 * 2048, 384, 3, cuda)
    t = {tile: device_time(sweep_cuda.matmul_only_acc, q, e, tile, iters=5, device=cuda)
         for tile in (2048, 128)}
    assert 1 / 1.2 <= t[2048] / t[128] <= 1.2, t


@pytest.mark.parametrize("b", [4229, 2049, 7])
def test_packed_candidate_merge_several_queries_per_block(cuda, b):
    """B2 with 8 (b >= 4224), 2 (b = 2049: four warps a query) and one
    query per block of 8 warps, over a batch that is not a multiple of the
    block's queries; ties and fillers included."""
    rng = np.random.default_rng(b)
    v = np.round(rng.standard_normal((b, 489, 10)) * 8) / 64
    v[:, -20:] = -1e30
    i = rng.integers(0, 1 << 20, size=(b, 489, 10)).astype(np.int32)
    v = torch.from_numpy(v.astype(np.float32)).to(cuda)
    i = torch.from_numpy(i).to(cuda)
    assert 8 // topk_cuda.merge_warps(b) == {4229: 8, 2049: 2, 7: 1}[b]
    kv, ki = topk_cuda.packed_candidate_merge(v, i, 32)
    pv, pi = topk_cuda.packed_candidate_merge_plain(v, i, 32)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


# (b, n, d, k, tile or supertile rows): ragged tiles, masked rows, ragged
# query blocks, per-tile k from 1 to 128; d = 768 takes the kernel's
# 64-query blocks (128 do not fit shared memory).
TC_CASES = [(130, 9000, 384, 1, 2048), (70, 5000, 128, 10, 2048),
            (200, 4500, 384, 100, 2048), (64, 4096, 128, 128, 1024),
            (130, 20_000, 384, 10, 8192), (130, 9000, 128, 128, 4096),
            (129, 5000, 384, 100, 2048), (70, 5000, 768, 16, 2048)]


@pytest.mark.parametrize("b,n,d,k,rows", TC_CASES)
def test_tensor_core_b5_b7f_exact_dots_bit_equal(cuda, b, n, d, k, rows):
    """B5 (rows <= 2048) and B7f over a bf16 bank run on the tensor cores;
    on dots exact in any order they equal their plain versions bit for
    bit, for B5 at its 2048-row lane field and B7f at `rows`."""
    q, e, mask = _dyadic_inputs(b, n, d, b + k + d, cuda, torch.bfloat16)
    outs = [(topk_cuda.float_packed_super_tile_topk(q, e, mask, k, rows),
             topk_cuda.float_packed_super_tile_topk_plain(q, e, mask, k, rows))]
    if rows <= 2048:
        outs.append((topk_cuda.float_packed_tile_topk(q, e, mask, k, tile_n=rows),
                     topk_cuda.float_packed_tile_topk_plain(q, e, mask, k, tile_n=rows)))
    torch.cuda.synchronize()
    for (kv, ki), (pv, pi) in outs:
        assert torch.equal(ki, pi)
        assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


@pytest.mark.parametrize("b,n,d,k,rows", TC_CASES)
def test_tensor_core_b5_b7f_normal_inputs(cuda, b, n, d, k, rows):
    from hcrag_tpu_torch.testing import check_packed_topk

    q, e, mask = _float_inputs(b, n, d, b + k + d + 1, cuda, torch.bfloat16)
    kv, ki = topk_cuda.float_packed_super_tile_topk(q, e, mask, k, rows)
    pv, pi = topk_cuda.float_packed_super_tile_topk_plain(q, e, mask, k, rows)
    torch.cuda.synchronize()
    check_packed_topk(kv, ki, pv, pi, q, e, lane_bits=rows)


def test_tensor_core_dots_within_the_band(cuda):
    """The tensor-core loop's sums lie within `testing.TC_DOT_ERROR` of the
    float64 dots, and are exact on dyadic inputs."""
    from hcrag_tpu_torch.testing import TC_DOT_ERROR

    q, e, _ = _float_inputs(256, 20_000, 384, 3, cuda, torch.bfloat16)
    got = topk_cuda.bf16_tc_dots(q, e)
    err = float((got.double() - q.double() @ e.double().T).abs().max())
    assert err <= TC_DOT_ERROR
    q, e, _ = _dyadic_inputs(64, 3000, 128, 4, cuda, torch.bfloat16)
    assert torch.equal(topk_cuda.bf16_tc_dots(q, e), (q.double() @ e.double().T).float())


def _int8_tc(kernel, args, k, rows):
    """(kernel, plain) outputs of B1 or B7i."""
    if kernel == "b1":
        return (topk_cuda.int8_tile_topk(*args, k, tile_n=rows),
                topk_cuda.int8_tile_topk_plain(*args, k, tile_n=rows))
    return (topk_cuda.int8_super_tile_topk(*args, k, rows),
            topk_cuda.int8_super_tile_topk_plain(*args, k, rows))


def _bit_equal(out, plain):
    torch.cuda.synchronize()
    assert torch.equal(out[1], plain[1])
    assert torch.equal(out[0].view(torch.int32), plain[0].view(torch.int32))


@pytest.mark.parametrize("kernel,k,rows", [("b1", 10, 2048), ("b1", 64, 1024),
                                           ("b7i", 16, 8192), ("b7i", 128, 8192)])
def test_tensor_core_b1_b7i_filter_and_ties(cuda, kernel, k, rows):
    """A filter that leaves 3 rows in the first tile: its other slots are
    (-1e30, -1) fillers; all-tied rows: every tile gives its lowest rows.
    Both bit-equal to the plain version."""
    q8, qs, e8, es, mask = _b1_inputs(130, 9000, 384, seed=k + rows, dev=cuda)
    mask[:rows] = False
    mask[[5, 700, 1000]] = True
    out, plain = _int8_tc(kernel, (q8, qs, e8, es, mask), k, rows)
    _bit_equal(out, plain)
    got = torch.sort(out[1][:, 0, :3], dim=1).values
    assert torch.equal(got, torch.tensor([5, 700, 1000], device=cuda, dtype=torch.int32)
                       .expand(130, 3))
    assert bool((out[1][:, 0, 3:] == -1).all()) and bool((out[0][:, 0, 3:] == -1e30).all())
    args = _b1_inputs(65, 9000, 128, seed=k, dev=cuda, tied=True)
    args = args[:4] + (torch.ones_like(args[4]),)
    out, plain = _int8_tc(kernel, args, k, rows)
    _bit_equal(out, plain)
    tiles = -(-9000 // rows)
    want = torch.arange(tiles, device=cuda)[:, None] * rows + torch.arange(k, device=cuda)
    assert torch.equal(out[1], want.expand(65, tiles, k).to(torch.int32))


@pytest.mark.parametrize("mode", ["f32", "rescore", "int8"])
def test_large_k_route_on_card_equals_cpu(cuda, mode):
    """top_k = 300 takes the route without a kernel (ops/similarity.py) on
    the card too: the same answer as on the CPU (two rows may trade places
    only where their float64 scores lie within 1e-6: the rescore's f32
    sums are taken in another order), with TF32 on or off, and no
    selection kernel launched."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    index, graph = synthetic_setup(5000, 384, graph_degree=4)
    opts = dict(ell_max_degree=8, **FLOAT_MODES[mode])
    q = np.random.default_rng(2).standard_normal((16, 384)).astype(np.float32)
    gpu = QueryEngine(index, graph, device=cuda, **opts)
    names = ("int8_tile_topk", "float_tile_topk", "float_packed_tile_topk",
             "packed_candidate_merge")
    before = [getattr(topk_cuda, n).launches for n in names]
    rg = gpu.query_batch(q, top_k=300)
    assert [getattr(topk_cuda, n).launches for n in names] == before
    rc = QueryEngine(index, graph, device="cpu", **opts).query_batch(q, top_k=300)
    moved = rg.top_indices != rc.top_indices
    if moved.any():
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        exact = qn.astype(np.float64) @ np.asarray(index.emb, np.float64).T
        rows = np.nonzero(moved)[0]
        np.testing.assert_allclose(exact[rows, rg.top_indices[moved]],
                                   exact[rows, rc.top_indices[moved]], atol=1e-6, rtol=0)
    np.testing.assert_allclose(rg.top_scores, rc.top_scores, atol=1e-5, rtol=0)
    for f in ("relevance", "combined"):  # of the same rows
        np.testing.assert_allclose(getattr(rg, f)[~moved], getattr(rc, f)[~moved], atol=1e-5,
                                   rtol=0)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        rt = gpu.query_batch(q, top_k=300)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(rt, f), getattr(rg, f), err_msg=f)


# Kernel B4 on the register-tiled CUDA-core loop (128 queries x 128-row
# sub-tiles a block, the filtering epilogue), each case over an f32 and a
# bf16 bank: (b, n, d, k, tile).  Batches of 1, 63, 129, 130 and 1024
# (ragged query blocks), d of 64 to 1024 (streamed in 8-column chunks),
# per-tile k of 1 to 128 (k = 128 at 128-row tiles keeps every row),
# tiles of 64 to 2048 rows (64: half a sub-tile; 192: a sub-tile and a
# half), ragged bank ends, a tenth of the rows masked.
B4_GRID = [(1, 3000, 64, 1, 64), (63, 5000, 384, 10, 2048), (129, 4100, 768, 16, 1024),
           (1024, 2100, 384, 10, 2048), (129, 3000, 1024, 17, 512),
           (63, 9000, 64, 100, 2048), (130, 2500, 1024, 128, 2048),
           (129, 3000, 384, 128, 128), (63, 1000, 768, 1, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k,tile", B4_GRID)
def test_b4_grid_against_plain(cuda, b, n, d, k, tile, dtype):
    from hcrag_tpu_torch.testing import check_exact_topk

    q, e, mask = _float_inputs(b, n, d, b + k + d, cuda, dtype)
    kv, ki = topk_cuda.float_tile_topk(q, e, mask, k, tile_n=tile)
    pv, pi = topk_cuda.float_tile_topk_plain(q, e, mask, k, tile_n=tile)
    torch.cuda.synchronize()
    check_exact_topk(kv, ki, pv, pi, q, e, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,d,k,tile", B4_GRID)
def test_b4_grid_bit_equal_on_exact_dots(cuda, b, n, d, k, tile, dtype):
    """Multiples of 1/64: every dot is exact in any order, and many tie, so
    the kernel equals its plain version bit for bit, ties to the lowest
    row."""
    q, e, mask = _dyadic_inputs(b, n, d, b + k + d + 1, cuda, dtype)
    out = topk_cuda.float_tile_topk(q, e, mask, k, tile_n=tile)
    _bit_equal(out, topk_cuda.float_tile_topk_plain(q, e, mask, k, tile_n=tile))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,tile", [(1, 64), (16, 512), (17, 2048), (128, 2048)])
def test_b4_filter_leaving_fewer_than_k_rows(cuda, k, tile, dtype):
    """Only the first k // 2 rows of each tile pass the filter (none at
    k = 1), the last tile's none: every further slot is (-1e30, the tile's
    first row), bit-equal to the plain version."""
    n = 5000
    q, e, _ = _dyadic_inputs(129, n, 384, k + tile, cuda, dtype)
    r = torch.arange(n, device=cuda)
    mask = (r % tile < k // 2) & (r < (n - 1) // tile * tile)
    out = topk_cuda.float_tile_topk(q, e, mask, k, tile_n=tile)
    _bit_equal(out, topk_cuda.float_tile_topk_plain(q, e, mask, k, tile_n=tile))
    kv, ki = out
    base = (torch.arange(-(-n // tile), device=cuda) * tile).to(torch.int32)
    assert bool((kv[:, :, k // 2:] == -1e30).all())
    assert torch.equal(ki[:, :, k // 2:], base[None, :, None].expand_as(ki[:, :, k // 2:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_signed_zeros_and_ties(cuda, dtype):
    """Rows of +0.0 and of -0.0 between copies of one row v, queries -v
    (below zero on v) and zero queries: +0.0 and -0.0 dots tie, so each
    tile keeps its lowest zero rows (every row for a zero query), with the
    value +0.0; bit-equal to the plain version."""
    n, d, k, tile = 3000, 128, 10, 1024
    v = torch.from_numpy(np.random.default_rng(5).integers(1, 7, d) / 64).to(cuda, dtype)
    e = v.repeat(n, 1)
    r = torch.arange(n, device=cuda)
    e[r % 3 == 0] = 0.0
    e[r % 3 == 1] = -0.0
    q = torch.cat([-v.repeat(6, 1), torch.zeros(3, d, device=cuda, dtype=dtype)])
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    out = topk_cuda.float_tile_topk(q, e, mask, k, tile_n=tile)
    _bit_equal(out, topk_cuda.float_tile_topk_plain(q, e, mask, k, tile_n=tile))
    kv, ki = out
    assert bool((kv == 0).all()) and not bool(torch.signbit(kv).any())
    tiles = -(-n // tile)
    zero_rows = torch.stack([r[(r // tile == t) & (r % 3 != 2)][:k] for t in range(tiles)])
    all_rows = torch.arange(tiles, device=cuda)[:, None] * tile + torch.arange(k, device=cuda)
    assert torch.equal(ki[:6], zero_rows.to(torch.int32).expand(6, tiles, k))
    assert torch.equal(ki[6:], all_rows.to(torch.int32).expand(3, tiles, k))


# B3e on the int8 tensor cores with its 64-bit key: B1's edge shapes (k 1 to
# 128: 10-key register lists in 128-query blocks up to k = 10, 16-key ones in
# 64-query blocks up to 16, shared-memory lists past that), plus the widest
# rows (d = 1040) at both list kinds, and k = 100.
B3E_GRID = INT8_TC_TILE + [(65, 3000, 1040, 10, 2048), (130, 2500, 1040, 128, 2048),
                           (129, 5000, 384, 100, 2048), (2048, 2100, 384, 11, 2048)]


@pytest.mark.parametrize("b,n,d,k,tile", B3E_GRID)
def test_b3e_grid_bit_equal(cuda, b, n, d, k, tile):
    args = _b1_inputs(b, n, d, seed=b + k + d, dev=cuda)
    out = topk_cuda.int8_exact_tile_topk(*args, k, tile_n=tile)
    _bit_equal(out, topk_cuda.int8_exact_tile_topk_plain(*args, k, tile_n=tile))


@pytest.mark.parametrize("k,tile", [(10, 2048), (16, 1024), (17, 2048), (128, 2048)])
def test_b3e_filter_and_ties(cuda, k, tile):
    """A filter that leaves 3 rows in the first tile: its other slots are
    (-1e30, 0); all-tied rows: every tile gives its lowest rows.  Both
    bit-equal to the plain version, at each kind of list."""
    q8, qs, e8, es, mask = _b1_inputs(130, 9000, 384, seed=k + tile, dev=cuda)
    mask[:tile] = False
    mask[[5, 700, 1000]] = True
    out = topk_cuda.int8_exact_tile_topk(q8, qs, e8, es, mask, k, tile_n=tile)
    _bit_equal(out, topk_cuda.int8_exact_tile_topk_plain(q8, qs, e8, es, mask, k,
                                                          tile_n=tile))
    got = torch.sort(out[1][:, 0, :3], dim=1).values
    assert torch.equal(got, torch.tensor([5, 700, 1000], device=cuda, dtype=torch.int32)
                       .expand(130, 3))
    assert bool((out[1][:, 0, 3:] == 0).all()) and bool((out[0][:, 0, 3:] == -1e30).all())
    args = _b1_inputs(65, 9000, 128, seed=k, dev=cuda, tied=True)
    args = args[:4] + (torch.ones_like(args[4]),)
    out = topk_cuda.int8_exact_tile_topk(*args, k, tile_n=tile)
    _bit_equal(out, topk_cuda.int8_exact_tile_topk_plain(*args, k, tile_n=tile))
    tiles = -(-9000 // tile)
    want = torch.arange(tiles, device=cuda)[:, None] * tile + torch.arange(k, device=cuda)
    assert torch.equal(out[1], want.expand(65, tiles, k).to(torch.int32))


@pytest.mark.parametrize("max_len", [64, 192])
def test_minilm_on_card_equals_cpu(cuda, max_len):
    """The distilled encoder's forward on the card against the CPU's, in
    f32 with TF32 off: within 1e-4 on the normalized embeddings."""
    from hcrag_tpu_torch.models.minilm import load_distilled_embedder

    card = load_distilled_embedder(device=cuda)
    cpu = load_distilled_embedder(device="cpu")
    vocab = [w for w in card.tokenizer.vocab if w.isalpha()]
    rng = np.random.default_rng(max_len)
    texts = [" ".join(rng.choice(vocab, size=k)) for k in (1, 4, 9, 30, 60, 150, 190, 7)]
    got, want = card.encode(texts, max_len=max_len), cpu.encode(texts, max_len=max_len)
    assert got.shape == (8, 384) and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4
    assert next(card.model.parameters()).device.type == "cuda"


def test_refresh_index_on_card(cuda):
    """`refresh_index` after `append` on the card: the bank crosses a tile
    boundary, a query equal to an appended row finds that row first, and
    the card equals the CPU engine refreshed the same way."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    rng = np.random.default_rng(11)
    new = rng.standard_normal((3000, 384)).astype(np.float32)
    meta = [{"id": f"new_{i}", "type": "database_table"} for i in range(3000)]
    texts = [f"appended {i}" for i in range(3000)]
    engines = []
    for dev in (cuda, "cpu"):
        index, graph = synthetic_setup(5000, 384)
        engine = QueryEngine(index, graph, device=dev, ell_max_degree=8,
                             quantize_int8=True, int8_rescore=32, int8_f32_rescore=True)
        index.append(new, meta, texts)
        engine.refresh_index()
        engines.append(engine)
    assert engines[0]._n_bank == 8192 and engines[0].d_emb_int8.shape[0] == 8192
    q = np.concatenate([new[[0, 1234, 2999]], rng.standard_normal((13, 384))]).astype(np.float32)
    rg, rc = (e.query_batch(q, top_k=10) for e in engines)
    assert rg.top_indices[:3, 0].tolist() == [5000, 6234, 7999]
    np.testing.assert_array_equal(rg.top_indices, rc.top_indices)
    np.testing.assert_allclose(rg.top_scores, rc.top_scores, atol=1e-5, rtol=0)
