"""The stage-attribution kernels of the kernel sweep, with their CUDA kernels.

Counterpart of `make_matmul_only_acc`, `make_matmul_only_wide` and
`make_encode_level1` (benchmarks/kernel_sweep.py): stripped-down versions of
the fused float top-k on the CUDA cores (the loop of kernel B4 and of B5
over an f32 bank) over the same bank, whose differences in time split that
loop's time into its stages (`hcrag_tpu_torch.benchmarks.kernel_sweep`).  For queries q [B, D] and a
bf16 bank e [N, D] of whole `tile_n`-row tiles, s = q . e^T in f32:

  * `matmul_only_acc` (kernel B8a) — out [B, 128] f32, the running max over
    the tiles of each tile's first 128 columns of s, from -1e30: the read
    and dot floor;
  * `matmul_only_wide` (kernel B8b) — out [B, tiles * 128] f32, each tile's
    first 128 columns of s: the same dots plus the wide per-tile writes;
  * `encode_level1` (kernel B8c) — out [B, 256] int32: B5's packed key
    (bits(s + 2) & ~0x7FF) | (2047 - column in the tile), the largest (m1)
    and second-largest (m2, from 0) key of each lane l < 128 over the
    tile's 128-column groups, and their max over the tiles from 0, as
    [m1 | m2]: the same dots plus the encode and the level-1 per-lane top-2.

All three are csrc/kernel_sweep.cu, whose dot loop is csrc/float_dot.cuh's
and computes every dot of s, whether or not it reaches the output.  The
queries are cast to bf16, as the Pallas kernels cast them to the bank's type.
Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, defined beside it, for CPU tensors; each counts its
launches in a plain integer attribute, `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch

from hcrag_tpu_torch.ops import _build
from hcrag_tpu_torch.ops.quantize import check_exact_matmul
from hcrag_tpu_torch.ops.topk_cuda import (
    _SMEM_LIMIT, CORE_BLOCK_QUERIES, CORE_LOOP_SMEM, LANE_BITS, LANE_MASK, NEG_INF, _check,
    _require_cuda,
)

LANES = 128  # output columns per tile (B8a, B8b), lanes of the level-1 pass (B8c)
MAX_TILE = LANE_BITS  # B8c's lane field, 2047 - column, has 11 bits
_BLOCK_ROWS = 2048  # index rows per block of csrc/kernel_sweep.cu
_SIGNATURE = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def _kernel(name: str):
    fn = getattr(_build.load("kernel_sweep"), name)
    fn.argtypes = _SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def check_operands(q: torch.Tensor, e: torch.Tensor, tile_n: int) -> None:
    """Raise ValueError unless q [B, D] (f32 or bf16) and e [N, D] (bf16)
    fit the kernels: B, N >= 1; N a whole number of tiles, as the Pallas
    grid requires; tile_n a multiple of 128 up to 2048; D a multiple of 64."""
    if q.dim() != 2 or e.dim() != 2 or q.shape[1] != e.shape[1]:
        raise ValueError(f"q [B, D] and e [N, D] must share D, got {tuple(q.shape)} and "
                         f"{tuple(e.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or e.dtype != torch.bfloat16:
        raise ValueError(f"q must be float32 or bfloat16 and e bfloat16, got {q.dtype} "
                         f"and {e.dtype}")
    (b, d), n = q.shape, e.shape[0]
    if b == 0 or n == 0:
        raise ValueError("the sweep kernels need at least one query and one row")
    if tile_n % LANES or not LANES <= tile_n <= MAX_TILE:
        raise ValueError(f"tile_n must be a multiple of {LANES} in [{LANES}, {MAX_TILE}], "
                         f"got {tile_n}")
    if n % tile_n:
        raise ValueError(f"n={n} is not a whole number of {tile_n}-row tiles")
    if d % 64:
        raise ValueError(f"d={d} must be a multiple of 64")


def _scores(q: torch.Tensor, e: torch.Tensor, tile_n: int,
            elems: int = 1 << 28) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """The plain scores in query chunks of about `elems` elements: yields
    (lo, hi, s) with s = bf16(q[lo:hi]) . e^T as f32 products of the widened
    operands (TF32 off), viewed [hi - lo, tiles, tile_n]."""
    check_exact_matmul()
    b, n = q.shape[0], e.shape[0]
    e_f = e.to(torch.float32)
    chunk = max(1, elems // n)
    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        s = q[lo:hi].to(torch.bfloat16).to(torch.float32) @ e_f.T
        yield lo, hi, s.view(hi - lo, n // tile_n, tile_n)


def matmul_only_acc_plain(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of kernel B8a (same contract; the f32 sums run
    in another order, so values agree to rounding): out [B, 128] f32,
    out[b, j] = max(-1e30, max over tiles t of s[b, t * tile_n + j])."""
    check_operands(q, e, tile_n)
    out = torch.empty((q.shape[0], LANES), dtype=torch.float32, device=q.device)
    for lo, hi, s in _scores(q, e, tile_n):
        out[lo:hi] = s[:, :, :LANES].amax(dim=1).clamp(min=NEG_INF)
    return out


def matmul_only_wide_plain(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of kernel B8b (same contract; values agree to
    rounding): out [B, tiles * 128] f32, out[b, t * 128 + j] =
    s[b, t * tile_n + j]."""
    check_operands(q, e, tile_n)
    tiles = e.shape[0] // tile_n
    out = torch.empty((q.shape[0], tiles * LANES), dtype=torch.float32, device=q.device)
    for lo, hi, s in _scores(q, e, tile_n):
        out[lo:hi] = s[:, :, :LANES].reshape(hi - lo, tiles * LANES)
    return out


def encode_level1_plain(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Plain PyTorch version of kernel B8c (same contract; the f32 sums run
    in another order, so a key can differ where a score lies within
    rounding of a key-quantum boundary: `testing.check_level1`).

    out [B, 256] int32: with key = (bits(s + 2) & ~0x7FF) | (2047 - col) for
    the row at column col of its tile, m1 the largest and m2 = max(0, the
    second-largest) key of lane l over the tile's groups (col = g * 128 + l),
    out[b, l] = max(0, max over tiles of m1) and out[b, 128 + l] = max(0,
    max over tiles of m2).  With one group per tile (tile_n 128), m2 is 0."""
    check_operands(q, e, tile_n)
    b, dev = q.shape[0], q.device
    groups = tile_n // LANES
    lane = LANE_MASK - torch.arange(tile_n, dtype=torch.int32, device=dev)
    out = torch.empty((b, 2 * LANES), dtype=torch.int32, device=dev)
    for lo, hi, s in _scores(q, e, tile_n):
        keys = ((s + 2.0).view(torch.int32) & ~LANE_MASK) | lane
        keys = keys.view(hi - lo, -1, groups, LANES)
        if groups > 1:
            top2 = keys.topk(2, dim=2).values  # keys are unique within a lane
            m1, m2 = top2[:, :, 0], top2[:, :, 1].clamp(min=0)
        else:
            m1, m2 = keys[:, :, 0], torch.zeros_like(keys[:, :, 0])
        out[lo:hi, :LANES] = m1.amax(dim=1).clamp(min=0)
        out[lo:hi, LANES:] = m2.amax(dim=1).clamp(min=0)
    return out


def sweep_smem_bytes(name: str) -> int:
    """Shared memory of a B8 kernel: the CUDA-core loop's chunk buffers
    (csrc/float_dot.cuh) and, per query of the 128-query block, B8a's 128
    running maxima or B8c's 128 level-1 pairs (m1, m2); none for B8b."""
    lanes = {"matmul_only_acc": LANES, "encode_level1": 2 * LANES}.get(name, 0)
    return CORE_LOOP_SMEM + 4 * CORE_BLOCK_QUERIES * lanes


def _launch(name: str, q: torch.Tensor, e: torch.Tensor, tile_n: int,
            out: torch.Tensor) -> torch.Tensor:
    """Check the operands of a B8 kernel on the card and launch it into
    `out`, which the caller has filled as the kernel's contract asks."""
    _require_cuda(q, "q")
    dev = q.device
    qb = q.to(torch.bfloat16)
    (b, d), n = qb.shape, e.shape[0]
    _check(qb, "q", torch.bfloat16, (b, d), dev)
    _check(e, "e", torch.bfloat16, (n, d), dev)
    if qb.data_ptr() % 16 or e.data_ptr() % 16:
        raise ValueError("q and e must start on 16-byte boundaries")
    smem = sweep_smem_bytes(name)
    blocks = -(-(n // tile_n) // max(1, _BLOCK_ROWS // tile_n))
    if smem > _SMEM_LIMIT or blocks > 65535:
        raise ValueError(f"{name}: d={d} needs {smem} bytes of shared memory (limit "
                         f"{_SMEM_LIMIT}) or {blocks} row blocks exceed 65535")
    err = _kernel(name)(qb.data_ptr(), e.data_ptr(), out.data_ptr(), b, n, d, tile_n,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def matmul_only_acc(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Kernel B8a for CUDA tensors, its plain version for CPU tensors (see
    `matmul_only_acc_plain` for the contract)."""
    check_operands(q, e, tile_n)
    if q.device.type == "cpu":
        return matmul_only_acc_plain(q, e, tile_n)
    out = torch.full((q.shape[0], LANES), NEG_INF, dtype=torch.float32, device=q.device)
    _launch("matmul_only_acc", q, e, tile_n, out)
    matmul_only_acc.launches += 1
    return out


matmul_only_acc.launches = 0


def matmul_only_wide(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Kernel B8b for CUDA tensors, its plain version for CPU tensors (see
    `matmul_only_wide_plain` for the contract)."""
    check_operands(q, e, tile_n)
    if q.device.type == "cpu":
        return matmul_only_wide_plain(q, e, tile_n)
    out = torch.empty((q.shape[0], e.shape[0] // tile_n * LANES), dtype=torch.float32,
                      device=q.device)
    _launch("matmul_only_wide", q, e, tile_n, out)
    matmul_only_wide.launches += 1
    return out


matmul_only_wide.launches = 0


def encode_level1(q: torch.Tensor, e: torch.Tensor, tile_n: int = 2048) -> torch.Tensor:
    """Kernel B8c for CUDA tensors, its plain version for CPU tensors (see
    `encode_level1_plain` for the contract)."""
    check_operands(q, e, tile_n)
    if q.device.type == "cpu":
        return encode_level1_plain(q, e, tile_n)
    out = torch.zeros((q.shape[0], 2 * LANES), dtype=torch.int32, device=q.device)
    _launch("encode_level1", q, e, tile_n, out)
    encode_level1.launches += 1
    return out


encode_level1.launches = 0
