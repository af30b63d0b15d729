"""Host-side rules of kernels B4 and B3e on their H100 loops, on the CPU.

B4 (`float_tile_topk`) over an f32 bank, and B5 / B7f over one, run the
register-tiled CUDA-core loop of csrc/float_dot.cuh: 128 queries a block,
both operands streamed in 8-column chunks, so its shared memory does not
depend on d.  B4 over a bf16 bank runs the tensor-core kernel of
csrc/tc_tile_topk.cuh with 64-bit keys where that takes 128 queries a
block, or 64 with register lists, and the CUDA-core loop elsewhere.  B3e (`int8_exact_tile_topk`) runs the
int8 tensor-core kernel with 64-bit keys.  64-bit register lists take
128-query blocks up to k = 10 and 64-query blocks from 11 to 16.  These
tests hold
the wrappers' sizing and operand rules (`float_launch_plan`,
`int8_launch_plan`, `core_smem_bytes`, `tc_block_queries`,
`sweep_smem_bytes`) to those layouts; the kernels themselves are held to
their plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from hcrag_tpu_torch.ops import sweep_cuda
from hcrag_tpu_torch.ops import topk_cuda as tc

SMEM = 232_448  # what one block may use on an H100
SM_SMEM = 233_472  # an SM's shared memory; each block also reserves 1 KB


def test_core_loop_smem_is_two_chunk_buffers():
    """Two buffers of 8 columns of 128 queries and 128 rows, each row of a
    chunk padded to 132 floats; then per query 64 candidate slots, k list
    slots and a count, and 64 slots of merge scratch for each of 8 warps."""
    assert tc.CORE_LOOP_SMEM == 2 * 8 * (132 + 132) * 4 == 16_896
    assert tc.core_smem_bytes(10, 8) == 16_896 + 8 * (128 * (64 + 10) + 8 * 64) + 4 * 128


@pytest.mark.parametrize("key_bytes", [4, 8])
def test_core_smem_fits_every_k(key_bytes):
    """Every k up to 128 fits one block; up to k = 16 two blocks share an
    SM (the launch bounds give each thread 128 registers for that)."""
    for k in range(1, 129):
        assert tc.core_smem_bytes(k, key_bytes) <= SMEM, k
    for k in range(1, 17):
        assert 2 * (tc.core_smem_bytes(k, key_bytes) + 1024) <= SM_SMEM, k
    assert tc.core_smem_bytes(128, 8) == 16_896 + 8 * (128 * (64 + 128) + 8 * 64) + 4 * 128


@pytest.mark.parametrize("d", [64, 384, 768, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_plan_takes_any_width(d, dtype):
    """B4's plan over either bank: tiles and the shared memory of its
    kernel.  Over f32 the CUDA-core kernel's, the same at every d; over bf16
    the tensor-core kernel's with 8-byte keys where that fits, else the
    CUDA-core kernel's."""
    q, e = torch.zeros(130, d, dtype=dtype), torch.zeros(5000, d, dtype=dtype)
    mask = torch.ones(5000, dtype=torch.bool)
    for k in (1, 10, 128):
        got = tc.float_launch_plan("float_tile_topk", 8, q, e, mask, k, 2048)
        qb = tc.tc_block_queries(d, k, 2, 8)
        if dtype == torch.bfloat16 and (qb == 128 or (qb == 64 and k <= 16)):
            assert tc.b4_on_tensor_cores(dtype, d, k)
            assert got == (3, tc.tc_smem_bytes(qb, d, k, 2, 8))
        else:
            assert not tc.b4_on_tensor_cores(dtype, d, k)
            assert got == (3, tc.core_smem_bytes(k, 8))


# (d, k, queries per tensor-core block with 64-bit keys or 0 where none
# fits, whether B4 over bf16 takes the tensor cores): kg1m_bf16.batch1k's
# shape (k = 10: 128-query blocks, register lists); 64-bit register lists
# of 16 (64-query blocks); shared-memory buffers in 128-query blocks (k = 17
# to 27 at d = 384); graph3's k = 100 (64-query blocks with buffers, ~167 KB,
# slower than the CUDA-core loop on an H100); d = 1024 past k = 16 (the
# same); and widths no plan holds (d = 1024 at k = 128; d = 2048).
B4_ROUTES = [(384, 10, 128, True), (384, 16, 64, True), (384, 17, 128, True),
             (384, 27, 128, True), (384, 100, 64, False), (1024, 10, 64, True),
             (1024, 17, 64, False), (1024, 128, 0, False), (2048, 1, 0, False)]


@pytest.mark.parametrize("d,k,qb,on_tc", B4_ROUTES)
def test_b4_route_by_shape(d, k, qb, on_tc):
    """B4 over bf16 takes the tensor cores where they hold 128 queries a
    block, or 64 with register lists; over f32 it never does.  The plan's
    shared memory is that of the kernel the route runs."""
    assert tc.tc_block_queries(d, k, 2, 8) == qb
    assert tc.b4_on_tensor_cores(torch.bfloat16, d, k) == on_tc
    assert not tc.b4_on_tensor_cores(torch.float32, d, k)
    q, e = torch.zeros(512, d, dtype=torch.bfloat16), torch.zeros(4100, d, dtype=torch.bfloat16)
    mask = torch.ones(4100, dtype=torch.bool)
    _, smem = tc.float_launch_plan("float_tile_topk", 8, q, e, mask, k, 2048)
    assert smem == (tc.tc_smem_bytes(qb, d, k, 2, 8) if on_tc else tc.core_smem_bytes(k, 8))
    assert smem <= SMEM
    assert (tc.tc_smem_bytes(64, d, k, 2, 8) <= SMEM) == (qb > 0)


def test_b5_plan_over_f32_takes_the_core_loop():
    q, e = torch.zeros(9, 384), torch.zeros(3000, 384)
    mask = torch.ones(3000, dtype=torch.bool)
    assert tc.float_launch_plan("float_packed_tile_topk", 4, q, e, mask, 10, 1024) == (
        3, tc.core_smem_bytes(10, 4))
    qb, eb = q.to(torch.bfloat16), e.to(torch.bfloat16)
    smem = tc.tc_smem_bytes(tc.tc_block_queries(384, 10), 384, 10)
    assert tc.float_launch_plan("float_packed_tile_topk", 4, qb, eb, mask, 10, 1024) == (
        3, smem)


@pytest.mark.parametrize("bad", ["d", "k", "tile", "dtype", "mask", "empty"])
def test_b4_plan_refuses(bad):
    """Rows of whole 64-column multiples, k from 1 to 128 and at most the
    tile, tiles of 64-row multiples up to 2048, one type for both operands,
    one mask entry a row, and at least one query and row."""
    b, n, d, k, tile = 5, 3000, 128, 10, 1024
    dtype, mask_n = torch.float32, n
    if bad == "d":
        d = 96
    elif bad == "k":
        k = 129
    elif bad == "tile":
        tile = 1000
    elif bad == "mask":
        mask_n = n - 1
    elif bad == "empty":
        b = 0
    q, e = torch.zeros(b, d, dtype=dtype), torch.zeros(n, d, dtype=dtype)
    if bad == "dtype":
        q = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tc.float_launch_plan("float_tile_topk", 8, q, e, torch.ones(mask_n, dtype=torch.bool),
                             k, tile)


def test_tc_sizing_of_64_bit_keys():
    """B3e's keys take 8 bytes in the tensor-core kernel's buffers and
    lists; its 10-key register lists fit 128-query blocks, its 16-key ones
    only 64-query blocks; the widest rows take 64-query blocks at any k."""
    ring = 4 * (64 * 128 + 16)
    assert tc.tc_smem_bytes(128, 384, 10, 1, 8) == (1024 + 128 * 384 + ring
                                                    + 8 * (128 * 64 + 128 * 10) + 4 * 128)
    assert tc.tc_smem_bytes(128, 384, 10, 1, 4) == tc.tc_smem_bytes(128, 384, 10, 1)
    assert [tc.tc_block_queries(384, k, 1, 8) for k in (1, 10, 11, 16, 17, 128)] == [
        128, 128, 64, 64, 128, 64]
    assert [tc.tc_block_queries(384, k, 1, 4) for k in (1, 10, 11, 16, 17, 128)] == [
        128, 128, 128, 128, 128, 128]
    assert tc.tc_block_queries(1040, 10, 1, 8) == 64
    assert tc.tc_block_queries(1040, 128, 1, 8) == 64
    for d in (16, 48, 128, 384, 768, 1040):
        for k in (1, 10, 11, 16, 17, 64, 128):
            qb = tc.tc_block_queries(d, k, 1, 8)
            assert qb and tc.tc_smem_bytes(qb, d, k, 1, 8) <= SMEM, (d, k)


def _int8_operands(b=65, n=3000, d=384):
    rng = np.random.default_rng(0)
    q8 = torch.from_numpy(rng.integers(-127, 128, (b, d), dtype=np.int8))
    e8 = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8))
    return q8, torch.ones(b), e8, torch.ones(n + 2), torch.ones(n + 4, dtype=torch.bool)


def test_b3e_plan_is_the_tensor_core_kernel():
    q8, qs, e8, es, mask = _int8_operands()
    n = e8.shape[0]
    for k in (10, 16, 128):
        tiles, smem = tc.int8_launch_plan("int8_exact_tile_topk", 8, q8, qs, e8, es[:n],
                                          mask[:n], k, 2048)
        assert tiles == 2
        assert smem == tc.tc_smem_bytes(tc.tc_block_queries(384, k, 1, 8), 384, k, 1, 8)


def test_b3e_plan_refuses_misaligned_scales_and_mask():
    """B3e reads the row scales as float2 and the mask bytes in pairs, as B1
    does: e_scale on an 8-byte boundary and mask on a 4-byte one."""
    q8, qs, e8, es, mask = _int8_operands()
    n = e8.shape[0]
    with pytest.raises(ValueError, match="8-byte"):
        tc.int8_launch_plan("int8_exact_tile_topk", 8, q8, qs, e8, es[1:n + 1], mask[:n], 10,
                            2048)
    with pytest.raises(ValueError, match="4-byte"):
        tc.int8_launch_plan("int8_exact_tile_topk", 8, q8, qs, e8, es[:n], mask[2:n + 2], 10,
                            2048)


def test_sweep_smem_is_the_core_loop_and_its_fold():
    """B8a keeps 128 running maxima a query of the 128-query block, B8c 128
    level-1 pairs, B8b nothing past the loop's buffers."""
    assert sweep_cuda.sweep_smem_bytes("matmul_only_wide") == tc.CORE_LOOP_SMEM
    assert sweep_cuda.sweep_smem_bytes("matmul_only_acc") == tc.CORE_LOOP_SMEM + 4 * 128 * 128
    assert sweep_cuda.sweep_smem_bytes("encode_level1") == tc.CORE_LOOP_SMEM + 8 * 128 * 128
    assert all(sweep_cuda.sweep_smem_bytes(name) <= SMEM
               for name in ("matmul_only_acc", "matmul_only_wide", "encode_level1"))
