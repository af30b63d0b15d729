"""Fused cosine + top-k over the index, with its CUDA kernels.

Counterpart of `pallas_cosine_top_k_int8`, `pallas_cosine_top_k`,
`_merge_tile_candidates` and `_merge_super_candidates`
(hcrag_tpu/ops/topk_pallas.py):

  * `int8_tile_topk` (kernel B1, csrc/int8_tile_topk.cu) — int8 dots,
    rescale, mask and the exact top-k of every index tile under the packed
    (score | lane) key.  It also serves kernel B3's k-pass packed branch,
    whose contract is the same exact per-tile top-k;
  * `int8_exact_tile_topk` (kernel B3's exact branch, csrc/int8_tile_topk.cu)
    — int8 dots and rescale, and the exact top-k of every tile by raw value,
    ties to the lowest row;
  * `packed_candidate_merge` (kernel B2, csrc/packed_candidate_merge.cu) —
    the top out_k of a packed candidate pool under the packed
    (value | slot-major position) key;
  * `float_tile_topk` (kernel B4, csrc/float_tile_topk.cu) — f32 or bf16
    dots, additive mask and the exact top-k of every tile by raw value, ties
    to the lowest row;
  * `float_packed_tile_topk` (kernel B5, csrc/float_tile_topk.cu) — B1's
    packed-key selection over a float dot;
  * `int8_super_tile_topk` and `float_packed_super_tile_topk` (kernel B7,
    csrc/int8_tile_topk.cu and csrc/float_tile_topk.cu) — B1's and B5's
    selections over supertiles of up to 8192 rows, under a packed key whose
    lane field is as wide as the supertile; `merge_super_candidates` merges
    their pools (kernel B2, or a stable sort in slot-major order).

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain PyTorch version, defined beside it, for CPU tensors.  Each counts its
launches in a plain integer attribute, `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch

from hcrag_tpu_torch.ops import _build
from hcrag_tpu_torch.ops.quantize import check_exact_matmul, quantize_queries
from hcrag_tpu_torch.ops.similarity import top_k as stable_top_k

NEG_INF = -1e30
LANE_BITS = 2048  # B1/B5: the 11 low bits of a packed key hold 2047 - lane
LANE_MASK = LANE_BITS - 1
MAX_TILE_K = 128
MAX_SUPER_ROWS = 8192  # B7: a supertile's lane field holds at most 13 bits
PACKED_MERGE_MIN_POOL = 2 * 2048  # smaller pools take the stable sort
PACKED_SUPER_MERGE_MIN_POOL = 1024  # the same for supertile pools
_INT32_MIN = -(2**31)
_INT64_MIN = -(2**63)
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
#: The widest int8 row the kernels take: |dot| <= 127^2 * d < 2^24 keeps
#: fp32(dot) exact, and with it the bits of the scores.
MAX_INT8_DEPTH = 1040

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "int8_tile_topk": (_VP,) * 7 + (_I,) * 5 + (_VP,),
    "int8_exact_tile_topk": (_VP,) * 7 + (_I,) * 5 + (_VP,),
    "int8_super_tile_topk": (_VP,) * 7 + (_I,) * 5 + (_VP,),
    "packed_candidate_merge": (_VP,) * 4 + (_I,) * 5 + (_VP,),
    "float_tile_topk": (_VP,) * 5 + (_I,) * 6 + (_VP,),
    "float_packed_tile_topk": (_VP,) * 5 + (_I,) * 6 + (_VP,),
    "float_packed_super_tile_topk": (_VP,) * 5 + (_I,) * 6 + (_VP,),
    "bf16_tc_dots": (_VP,) * 3 + (_I,) * 3 + (_VP,),
}
_SOURCES = {  # entry point -> csrc/<source>.cu, where the two differ
    "int8_exact_tile_topk": "int8_tile_topk",
    "int8_super_tile_topk": "int8_tile_topk",
    "float_packed_tile_topk": "float_tile_topk",
    "float_packed_super_tile_topk": "float_tile_topk",
    "bf16_tc_dots": "float_tile_topk",
}


def _kernel(name: str):
    fn = getattr(_build.load(_SOURCES.get(name, name)), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA or CPU tensor, got {t.device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous on {device}")


# ---------------------------------------------------------------------------
# Kernels B1 and B3: per-tile top-k over an int8 bank
# ---------------------------------------------------------------------------
def _int8_scores(
    q8, q_scale, e8, e_scale, tile_n: int, elems: int
) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """The plain int8 scores in query chunks of about `elems` elements:
    yields (lo, hi, s) with s = (fp32(q8[lo:hi] . e8^T) * q_scale) * e_scale,
    f32 [hi - lo, N], in the kernels' order of rounding."""
    check_exact_matmul()
    b, n = q8.shape[0], e8.shape[0]
    e_f = e8.to(torch.float32)
    chunk = max(1, elems // (-(-n // tile_n) * tile_n))
    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        s = q8[lo:hi].to(torch.float32) @ e_f.T  # exact integer dots
        s = s * q_scale[lo:hi, None]
        yield lo, hi, s * e_scale[None, :]


def _mask_shift(mask: torch.Tensor) -> torch.Tensor:
    """The packed key's shift: +2 where the mask is set, -3 where not."""
    dev = mask.device
    return torch.where(mask, torch.tensor(2.0, device=dev), torch.tensor(-3.0, device=dev))


def _packed_tile_select(scores, b: int, n: int, k: int, tile_n: int, lane_bits: int,
                        dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of every `tile_n`-row tile under the packed key, over
    score chunks (lo, hi, s [hi - lo, N] f32, the mask's shift included):

      key = (bits(s) & ~(lane_bits - 1)) | (lane_bits - 1 - row_in_tile)

    as int32.  The k largest keys decode to value float(key & ~(lane_bits -
    1)) - 2.0 and index tile * tile_n + lane_bits - 1 - (key & (lane_bits -
    1)); a key <= 0 (masked row, row past n, no row left) to (-1e30, -1).
    B1 and B5 take lane_bits 2048 over tiles of at most 2048 rows, B7 a
    supertile of lane_bits rows.  Returns (vals, idx) [b, tiles, k]."""
    lmask = lane_bits - 1
    tiles = -(-n // tile_n)
    pad = tiles * tile_n - n
    lane = (lmask - torch.arange(tile_n, dtype=torch.int32, device=dev)).repeat(tiles)[:n]
    base = (torch.arange(tiles, dtype=torch.int32, device=dev) * tile_n)[:, None]
    out_v = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
    for lo, hi, s in scores:
        keys = (s.view(torch.int32) & ~lmask) | lane
        if pad:
            keys = torch.nn.functional.pad(keys, (0, pad), value=_INT32_MIN)
        top = keys.view(hi - lo, tiles, tile_n).topk(k, dim=2).values  # unique keys
        valid = top > 0
        val = (top & ~lmask).view(torch.float32) - 2.0
        idx = lmask - (top & lmask) + base
        out_v[lo:hi] = torch.where(valid, val, NEG_INF)
        out_i[lo:hi] = torch.where(valid, idx, -1)
    return out_v, out_i


def _int8_packed_plain(q8, q_scale, e8, e_scale, mask, k, tile_n, lane_bits):
    offs = _mask_shift(mask)[None, :]
    scores = ((lo, hi, s + offs)
              for lo, hi, s in _int8_scores(q8, q_scale, e8, e_scale, tile_n, 1 << 29))
    return _packed_tile_select(scores, q8.shape[0], e8.shape[0], k, tile_n, lane_bits,
                               q8.device)


def int8_tile_topk_plain(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B1 (same contract, same bits).

    q8 [B, D] int8, q_scale [B] f32, e8 [N, D] int8, e_scale [N] f32,
    mask [N] bool -> (vals [B, tiles, k] f32, idx [B, tiles, k] int32), the
    exact top-k of every `tile_n`-row tile under the packed key (lane field
    2047 - row_in_tile, `_packed_tile_select`) of the shifted score
    s = (fp32(q8 . e8) * q_scale) * e_scale + (2 if mask else -3); fillers
    (-1e30, -1).  Queries go in chunks that keep the [chunk, N] score
    buffers near 2 GiB."""
    return _int8_packed_plain(q8, q_scale, e8, e_scale, mask, k, tile_n, LANE_BITS)


def _check_tiles(tile_n: int, k: int, super_rows: bool) -> None:
    """A tile of 64 to 2048 rows (a multiple of 64), or a supertile of a
    power of two from 128 to 8192 rows; a per-tile k of 1 to 128."""
    if super_rows:
        if tile_n & (tile_n - 1) or not 128 <= tile_n <= MAX_SUPER_ROWS:
            raise ValueError(f"lbits must be a power of two in [128, {MAX_SUPER_ROWS}], "
                             f"got {tile_n}")
    elif tile_n % 64 or not 64 <= tile_n <= 2048:
        raise ValueError(f"tile_n must be a multiple of 64 in [64, 2048], got {tile_n}")
    if not 1 <= k <= min(MAX_TILE_K, tile_n):
        raise ValueError(f"per-tile k must be in [1, {min(MAX_TILE_K, tile_n)}], got {k}")


def tc_smem_bytes(qb: int, d: int, k: int, elem_bytes: int = 2, key_bytes: int = 4) -> int:
    """Shared memory of the tensor-core kernel of B1 / B3e / B7i (int8,
    elem_bytes 1) and B5 / B7f (bf16, elem_bytes 2), csrc/tc_tile_topk.cuh,
    with qb queries per block: 1024 bytes of alignment, the query block in
    whole 128-byte chunks of each row, four 64-row chunks with their two
    mbarriers each, the key buffers and the lists (key_bytes a key: 8 for
    B3e, 4 for the others) and their counts."""
    row = -(-d * elem_bytes // 128) * 128
    return (1024 + qb * row + 4 * (64 * 128 + 16) + key_bytes * (qb * 64 + qb * k)
            + 4 * qb)


def tc_block_queries(d: int, k: int, elem_bytes: int = 2, key_bytes: int = 4) -> int:
    """The queries per block the tensor-core kernel takes: 128 where they
    fit shared memory, else 64; 0 where neither fits.  B3e's 64-bit keys at
    10 < k <= 16 (per-thread register lists of 16) take 64: a 128-query
    block's 9 warps leave too few registers for them (its lists hold 10)."""
    for qb in ((64,) if key_bytes == 8 and 10 < k <= 16 else (128, 64)):
        if tc_smem_bytes(qb, d, k, elem_bytes, key_bytes) <= _SMEM_LIMIT:
            return qb
    return 0


#: The CUDA-core kernel of B4 (and of B5 / B7f over an f32 bank),
#: csrc/float_tile_topk.cu on csrc/float_dot.cuh: queries per block, rows
#: per sub-tile, and the bytes of the loop's two chunk buffers (8 columns of
#: 128 queries and 128 rows, rows padded to 132 floats).
CORE_BLOCK_QUERIES = 128
CORE_SUB_ROWS = 128
CORE_LOOP_SMEM = 2 * 8 * 132 * 2 * 4


def core_smem_bytes(k: int, key_bytes: int) -> int:
    """Shared memory of the CUDA-core kernel: the loop's chunk buffers, then
    per query a candidate buffer of half a sub-tile and a list of k keys
    (key_bytes a key: 8 for B4, 4 for B5 / B7f), 64 keys of merge scratch
    for each of the 8 warps, and a count a query.  It does not depend on d:
    both operands stream through the chunk buffers."""
    qb = CORE_BLOCK_QUERIES
    return CORE_LOOP_SMEM + key_bytes * (qb * (CORE_SUB_ROWS // 2 + k) + 8 * 64) + 4 * qb


def _check_int8_depth(d: int) -> None:
    if d > MAX_INT8_DEPTH:
        raise ValueError(f"int8 rows of d={d} > {MAX_INT8_DEPTH}: 127^2 * d reaches 2^24, "
                         "past which fp32(dot) is no longer exact")


def int8_launch_plan(name, key_bytes, q8, q_scale, e8, e_scale, mask, k, tile_n,
                     super_rows=False) -> Tuple[int, int]:
    """The operand rules of kernel B1, B3e or B7i (all on the int8 tensor
    cores; key_bytes 8 for B3e's 64-bit key, else 4), on tensors of any one
    device: raises ValueError where the kernel would refuse them, else
    returns (tiles, shared-memory bytes of a block)."""
    b, d = q8.shape
    n = e8.shape[0]
    dev = q8.device
    _check(q8, "q8", torch.int8, (b, d), dev)
    _check(q_scale, "q_scale", torch.float32, (b,), dev)
    _check(e8, "e8", torch.int8, (n, d), dev)
    _check(e_scale, "e_scale", torch.float32, (n,), dev)
    _check(mask, "mask", torch.bool, (n,), dev)
    if b == 0 or n == 0:
        raise ValueError(f"{name} needs at least one query and one row")
    if d % 16 or q8.data_ptr() % 16 or e8.data_ptr() % 16:
        raise ValueError("rows must be 16-byte multiples on 16-byte boundaries")
    _check_int8_depth(d)
    _check_tiles(tile_n, k, super_rows)
    tiles = -(-n // tile_n)
    if e_scale.data_ptr() % 8 or mask.data_ptr() % 4:
        raise ValueError(f"{name}: e_scale must lie on an 8-byte boundary and mask "
                         "on a 4-byte one")
    smem = tc_smem_bytes(tc_block_queries(d, k, 1, key_bytes) or 64, d, k, 1, key_bytes)
    if smem > _SMEM_LIMIT or tiles > 65535:
        raise ValueError(
            f"{name}: d={d}, k={k} needs {smem} bytes of shared memory "
            f"(limit {_SMEM_LIMIT}) or {tiles} tiles exceed 65535"
        )
    return tiles, smem


def _int8_launch(name, key_bytes, q8, q_scale, e8, e_scale, mask, k, tile_n,
                 super_rows=False):
    """Check the operands of kernel B1, B3e or B7i and launch it."""
    _require_cuda(q8, "q8")
    tiles, _ = int8_launch_plan(name, key_bytes, q8, q_scale, e8, e_scale, mask, k, tile_n,
                                super_rows)
    (b, d), n, dev = q8.shape, e8.shape[0], q8.device
    out_v = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
    err = _kernel(name)(
        q8.data_ptr(), q_scale.data_ptr(), e8.data_ptr(), e_scale.data_ptr(),
        mask.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
        b, n, d, k, tile_n, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_i


def int8_tile_topk(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 for CUDA tensors, its plain version for CPU tensors (see
    `int8_tile_topk_plain` for the contract)."""
    if q8.device.type == "cpu":
        _check_int8_depth(q8.shape[1])
        return int8_tile_topk_plain(q8, q_scale, e8, e_scale, mask, k, tile_n)
    out = _int8_launch("int8_tile_topk", 4, q8, q_scale, e8, e_scale, mask, k, tile_n)
    int8_tile_topk.launches += 1
    return out


int8_tile_topk.launches = 0


def int8_exact_tile_topk_plain(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B3e (same contract, same bits).

    Operands as `int8_tile_topk_plain`.  Every `tile_n`-row tile's k best
    rows among those with mask set, by the raw f32 value
    (fp32(dot) * q_scale) * e_scale descending (-0.0 counts as +0.0), ties
    to the lowest row; slots left when a tile has fewer than k valid rows
    hold (-1e30, the tile's first row), as B4's do."""
    b, n = q8.shape[0], e8.shape[0]
    scores = _int8_scores(q8, q_scale, e8, e_scale, tile_n, 1 << 28)
    return _exact_tile_select(scores, mask, b, n, k, tile_n)


def int8_exact_tile_topk(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B3e for CUDA tensors, its plain version for CPU tensors (see
    `int8_exact_tile_topk_plain` for the contract)."""
    if q8.device.type == "cpu":
        _check_int8_depth(q8.shape[1])
        return int8_exact_tile_topk_plain(q8, q_scale, e8, e_scale, mask, k, tile_n)
    out = _int8_launch(
        "int8_exact_tile_topk", 8, q8, q_scale, e8, e_scale, mask, k, tile_n
    )
    int8_exact_tile_topk.launches += 1
    return out


int8_exact_tile_topk.launches = 0


# ---------------------------------------------------------------------------
# Kernel B2: candidate merge
# ---------------------------------------------------------------------------
def packed_candidate_merge_plain(
    v: torch.Tensor, i: torch.Tensor, out_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B2 (same contract, same bits).

    v, i [b, tiles, k] (B1's tile-major candidates) -> (out_v [b, out_k]
    f32, out_i [b, out_k] int32): ordered by the quantized key
    bits(v + 2) & ~0x7FF, descending, ties to the lowest slot-major
    position slot * tiles + tile; values decode from the key, fillers
    (-1e30, -1)."""
    b, tiles, k = v.shape
    key = ((v + 2.0).view(torch.int32) & ~LANE_MASK).to(torch.int64)
    rank = (
        torch.arange(k, dtype=torch.int64, device=v.device)[None, :] * tiles
        + torch.arange(tiles, dtype=torch.int64, device=v.device)[:, None]
    )  # [tiles, k]: the slot-major position of each tile-major candidate
    word = key * 2**32 + (2**32 - 1 - rank)  # unique: a plain max orders it
    top = word.reshape(b, -1).topk(out_k, dim=1).values
    hi = torch.div(top, 2**32, rounding_mode="floor")
    r = 2**32 - 1 - (top - hi * 2**32)
    valid = hi > 0
    val = hi.to(torch.int32).view(torch.float32) - 2.0
    idx = torch.gather(i.reshape(b, -1), 1, (r % tiles) * k + r // tiles)
    return (
        torch.where(valid, val, NEG_INF),
        torch.where(valid, idx, -1).to(torch.int32),
    )


#: Warps resident at once on half of an H100's 132 SMs' 64 slots: B2 splits
#: a query over more warps until the batch fills that many.
_MERGE_TARGET_WARPS = 132 * 32


def merge_warps(b: int) -> int:
    """Warps per query of kernel B2 over a batch of b queries: the fewest
    of 1, 2, 4 and 8 that give b * warps >= 4224, else 8."""
    w = 1
    while w < 8 and b * w < _MERGE_TARGET_WARPS:
        w *= 2
    return w


def packed_candidate_merge(
    v: torch.Tensor, i: torch.Tensor, out_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B2 for CUDA tensors, its plain version for CPU tensors (see
    `packed_candidate_merge_plain` for the contract).  A pool of any size,
    streamed from device memory; out_k up to 128."""
    if v.device.type == "cpu":
        return packed_candidate_merge_plain(v, i, out_k)
    _require_cuda(v, "v")
    b, tiles, k = v.shape
    c = tiles * k
    dev = v.device
    _check(v, "v", torch.float32, (b, tiles, k), dev)
    _check(i, "i", torch.int32, (b, tiles, k), dev)
    if b == 0 or not 1 <= out_k <= min(c, MAX_TILE_K):
        raise ValueError(f"need b >= 1 and 1 <= out_k <= min({c}, {MAX_TILE_K}), "
                         f"got b={b}, out_k={out_k}")
    out_v = torch.empty((b, out_k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, out_k), dtype=torch.int32, device=dev)
    err = _kernel("packed_candidate_merge")(
        v.data_ptr(), i.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), b, tiles, k,
        out_k, merge_warps(b), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"packed_candidate_merge launch failed: CUDA error {err}")
    packed_candidate_merge.launches += 1
    return out_v, out_i


packed_candidate_merge.launches = 0


# ---------------------------------------------------------------------------
# Kernels B4 and B5: per-tile top-k over a float bank
# ---------------------------------------------------------------------------
def _float_tiles(q, e, mask, tile_n, packed):
    """The plain B4's and B5's float dots, in query chunks that keep the
    [chunk, N] buffers near 2 GiB: yields (lo, hi, s) with s = q[lo:hi] . e^T
    (B5: plus 2 where the mask is set, -3 where not), f32 [hi - lo, N]."""
    check_exact_matmul()
    b, n = q.shape[0], e.shape[0]
    offs = _mask_shift(mask)
    e_f = e.to(torch.float32)
    tiles = -(-n // tile_n)
    chunk = max(1, (1 << 28) // (tiles * tile_n))
    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        s = q[lo:hi].to(torch.float32) @ e_f.T
        yield lo, hi, (s + offs[None, :] if packed else s)


def _exact_tile_select(scores, mask, b: int, n: int, k: int, tile_n: int):
    """The exact per-tile top-k of B4 and B3e over score chunks (lo, hi, s
    [hi - lo, N] f32): (vals [b, tiles, k] f32, idx [b, tiles, k] int32) by
    value descending, ties to the lowest row, fill (-1e30, tile's first
    row)."""
    dev = mask.device
    tiles = -(-n // tile_n)
    pad = tiles * tile_n - n
    # A unique int64 word per row: order-preserving score bits, then
    # 2^32 - 1 - row_in_tile, so a plain max orders it.
    low = (2**32 - 1 - torch.arange(tile_n, dtype=torch.int64, device=dev)).repeat(
        tiles
    )[:n]
    base = (torch.arange(tiles, dtype=torch.int64, device=dev) * tile_n)[:, None]
    out_v = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
    for lo, hi, s in scores:
        bits = (s + 0.0).view(torch.int32)  # -0.0 ties with +0.0
        skey = bits ^ ((bits >> 31) & 0x7FFFFFFF)
        word = torch.where(mask, skey.to(torch.int64) * 2**32 + low, _INT64_MIN)
        if pad:
            word = torch.nn.functional.pad(word, (0, pad), value=_INT64_MIN)
        top = word.view(hi - lo, tiles, tile_n).topk(k, dim=2).values
        valid = top != _INT64_MIN
        hi32 = torch.div(top, 2**32, rounding_mode="floor")
        row = 2**32 - 1 - (top - hi32 * 2**32)
        sk = hi32.to(torch.int32)
        val = (sk ^ ((sk >> 31) & 0x7FFFFFFF)).view(torch.float32)
        out_v[lo:hi] = torch.where(valid, val, NEG_INF)
        out_i[lo:hi] = torch.where(valid, row + base, base).to(torch.int32)
    return out_v, out_i


def float_tile_topk_plain(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B4 (same contract; its f32 sums are
    taken in another order, so values agree to rounding).

    q [B, D], e [N, D] (both f32 or both bf16), mask [N] bool -> (vals
    [B, tiles, k] f32, idx [B, tiles, k] int32): every `tile_n`-row tile's k
    best rows of s = q.e among those with mask set, by raw value
    descending, ties to the lowest row.  Slots left when a tile has fewer
    than k valid rows hold (-1e30, the tile's first row): the Pallas
    kernel's repeated picks of its first column once every column is at
    -1e30."""
    scores = _float_tiles(q, e, mask, tile_n, packed=False)
    return _exact_tile_select(scores, mask, q.shape[0], e.shape[0], k, tile_n)


def float_packed_tile_topk_plain(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B5 (same contract; its f32 sums are
    taken in another order, so a key can differ where a score lies within
    rounding of a 2^-11-quantum boundary).

    q [B, D], e [N, D] (both f32 or both bf16), mask [N] bool -> (vals
    [B, tiles, k] f32, idx [B, tiles, k] int32): the exact top-k of every
    `tile_n`-row tile under the packed key (bits(s) & ~0x7FF) | (2047 -
    lane), s = q.e + (2 if mask else -3); values decode as the key's score
    minus 2, masked rows and empty slots are fillers (-1e30, -1)."""
    return _packed_tile_select(_float_tiles(q, e, mask, tile_n, packed=True), q.shape[0],
                               e.shape[0], k, tile_n, LANE_BITS, q.device)


def float_launch_plan(name, key_bytes, q, e, mask, k, tile_n,
                      super_rows=False) -> Tuple[int, int]:
    """The operand rules of kernel B4 (key_bytes 8), B5 or B7f (4), on
    tensors of any one device: raises ValueError where the kernel would
    refuse them, else returns (tiles, shared-memory bytes of a block).  B5
    and B7f over a bf16 bank run on the tensor cores; B4 over either bank
    and B5 / B7f over an f32 one on the CUDA-core kernel, whose shared
    memory does not depend on d."""
    b, d = q.shape
    n = e.shape[0]
    dev = q.device
    if e.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"e: expected float32 or bfloat16, got {e.dtype}")
    _check(q, "q", e.dtype, (b, d), dev)
    _check(e, "e", e.dtype, (n, d), dev)
    _check(mask, "mask", torch.bool, (n,), dev)
    if b == 0 or n == 0:
        raise ValueError(f"{name} needs at least one query and one row")
    if d % 64 or q.data_ptr() % 16 or e.data_ptr() % 16:
        raise ValueError("rows must be multiples of 64 values on 16-byte boundaries")
    _check_tiles(tile_n, k, super_rows)
    tiles = -(-n // tile_n)
    if key_bytes == 4 and e.dtype == torch.bfloat16:
        smem = tc_smem_bytes(tc_block_queries(d, k) or 64, d, k)
    else:
        smem = core_smem_bytes(k, key_bytes)
    if smem > _SMEM_LIMIT or tiles > 65535:
        raise ValueError(
            f"{name}: d={d}, k={k} needs {smem} bytes of shared memory "
            f"(limit {_SMEM_LIMIT}) or {tiles} tiles exceed 65535"
        )
    return tiles, smem


def _float_launch(name, key_bytes, q, e, mask, k, tile_n, super_rows=False):
    """Check the operands of kernel B4, B5 or B7f and launch it."""
    _require_cuda(q, "q")
    tiles, _ = float_launch_plan(name, key_bytes, q, e, mask, k, tile_n, super_rows)
    (b, d), n, dev = q.shape, e.shape[0], q.device
    out_v = torch.empty((b, tiles, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, tiles, k), dtype=torch.int32, device=dev)
    err = _kernel(name)(
        q.data_ptr(), e.data_ptr(), mask.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), b, n, d, k, tile_n, int(e.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_v, out_i


def float_tile_topk(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B4 for CUDA tensors, its plain version for CPU tensors (see
    `float_tile_topk_plain` for the contract)."""
    if q.device.type == "cpu":
        return float_tile_topk_plain(q, e, mask, k, tile_n)
    out = _float_launch("float_tile_topk", 8, q, e, mask, k, tile_n)
    float_tile_topk.launches += 1
    return out


float_tile_topk.launches = 0


def float_packed_tile_topk(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int,
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B5 for CUDA tensors, its plain version for CPU tensors (see
    `float_packed_tile_topk_plain` for the contract)."""
    if q.device.type == "cpu":
        return float_packed_tile_topk_plain(q, e, mask, k, tile_n)
    out = _float_launch("float_packed_tile_topk", 4, q, e, mask, k, tile_n)
    float_packed_tile_topk.launches += 1
    return out


float_packed_tile_topk.launches = 0


# ---------------------------------------------------------------------------
# Kernel B7: per-supertile top-k over an int8 or a float bank
# ---------------------------------------------------------------------------
def resolve_super_tiles(super_tiles: int, tile_n: int, n_pad_tiles: int,
                        two_level: bool = True, packed_select: bool = True) -> int:
    """The supertile factor a selection runs (`_resolve_super_tiles`):
    1 unless the packed two-level selection is asked for; else the floor
    power of two of `super_tiles`, halved until a supertile spans at most
    8192 rows and at most the bank's `n_pad_tiles` tiles."""
    if super_tiles <= 1 or not (two_level and packed_select):
        return 1
    spt = 1 << (int(super_tiles).bit_length() - 1)
    while spt > 1 and spt * tile_n > MAX_SUPER_ROWS:
        spt //= 2
    while spt > 1 and spt > n_pad_tiles:
        spt //= 2
    return spt


def super_pick_count(top_k: int, n: int, lbits: int, merge_k: int) -> int:
    """Picks per supertile: min(top_k, n) rounded up to 8, raised to
    min(128, ceil(merge_k / supertiles) rounded up to 8) when the
    supertiles are too few for the pool to cover merge_k."""
    def round_up_8(x: int) -> int:
        return -(-x // 8) * 8

    k_sub = round_up_8(min(top_k, n))
    num_super = -(-n // lbits)
    if merge_k > num_super * k_sub:
        k_sub = min(MAX_TILE_K, round_up_8(-(-merge_k // num_super)))
    return k_sub


def int8_super_tile_topk_plain(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    lbits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B7i (same contract, same bits).

    Operands as `int8_tile_topk_plain`.  Returns (vals [B, S, k] f32,
    idx [B, S, k] int32) with S = ceil(N / lbits): the exact top-k of every
    `lbits`-row supertile s under the packed key of B1's shifted score with
    an lbits-wide lane field,

      key = (bits(s) & ~(lbits - 1)) | (lbits - 1 - row_in_supertile),

    values decoded as float(key & ~(lbits - 1)) - 2.0 (2^-10 relative
    quantization at 8192 rows), fillers (-1e30, -1).  The Pallas kernel
    keeps only a few candidates per 128-row lane and so can drop a row that
    shares its lane with better ones; this is the exact contract it
    approximates."""
    return _int8_packed_plain(q8, q_scale, e8, e_scale, mask, k, lbits, lbits)


def int8_super_tile_topk(
    q8: torch.Tensor,
    q_scale: torch.Tensor,
    e8: torch.Tensor,
    e_scale: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    lbits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B7i for CUDA tensors, its plain version for CPU tensors (see
    `int8_super_tile_topk_plain` for the contract)."""
    if q8.device.type == "cpu":
        _check_int8_depth(q8.shape[1])
        return int8_super_tile_topk_plain(q8, q_scale, e8, e_scale, mask, k, lbits)
    out = _int8_launch("int8_super_tile_topk", 4, q8, q_scale, e8, e_scale, mask, k,
                       lbits, super_rows=True)
    int8_super_tile_topk.launches += 1
    return out


int8_super_tile_topk.launches = 0


def float_packed_super_tile_topk_plain(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int, lbits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B7f (same contract; its f32 sums are
    taken in another order, so a key can differ where a score lies within
    rounding of a key-quantum boundary, as B5's can).

    Operands as `float_packed_tile_topk_plain`.  Returns (vals [B, S, k]
    f32, idx [B, S, k] int32): the exact top-k of every `lbits`-row
    supertile under B5's shifted score with an lbits-wide lane field (see
    `int8_super_tile_topk_plain`)."""
    return _packed_tile_select(_float_tiles(q, e, mask, lbits, packed=True), q.shape[0],
                               e.shape[0], k, lbits, lbits, q.device)


def float_packed_super_tile_topk(
    q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor, k: int, lbits: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B7f for CUDA tensors, its plain version for CPU tensors (see
    `float_packed_super_tile_topk_plain` for the contract)."""
    if q.device.type == "cpu":
        return float_packed_super_tile_topk_plain(q, e, mask, k, lbits)
    out = _float_launch("float_packed_super_tile_topk", 4, q, e, mask, k, lbits,
                        super_rows=True)
    float_packed_super_tile_topk.launches += 1
    return out


float_packed_super_tile_topk.launches = 0


def bf16_tc_dots(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The sums of the tensor-core loop that B5 and B7f run over a bf16
    bank, without their selection: [b, n] f32 dots of bf16 queries q [b, d]
    with bf16 rows e [n, d].  Not on a query path: it measures how far that
    loop's sums lie from the float64 dots (`testing.py`).  CPU tensors take
    the float64 dots rounded to f32."""
    if q.device.type == "cpu":
        return (q.double() @ e.double().T).float()
    _require_cuda(q, "q")
    b, d = q.shape
    n = e.shape[0]
    _check(q, "q", torch.bfloat16, (b, d), q.device)
    _check(e, "e", torch.bfloat16, (n, d), q.device)
    if d % 64 or b == 0 or n == 0:
        raise ValueError("bf16_tc_dots needs d % 64 == 0 and non-empty operands")
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    err = _kernel("bf16_tc_dots")(q.data_ptr(), e.data_ptr(), out.data_ptr(), b, n, d,
                                  torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"bf16_tc_dots launch failed: CUDA error {err}")
    bf16_tc_dots.launches += 1
    return out


bf16_tc_dots.launches = 0


def uses_packed_super_merge(num_super: int, k_sub: int, out_k: int) -> bool:
    """Whether the merge of a [num_super, k_sub] supertile pool goes
    through kernel B2: pools of >= 1024 candidates with out_k <= 128, as
    `_merge_super_candidates` routes them."""
    return out_k <= MAX_TILE_K and num_super * k_sub >= PACKED_SUPER_MERGE_MIN_POOL


def merge_super_candidates(
    vals: torch.Tensor, idxs: torch.Tensor, k: int, merge_k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-supertile merge of [B, S, k_sub] candidates (B7's output) into
    the top min(max(k, merge_k), S * k_sub), k the true top-k.  Large
    pools go through kernel B2, which ranks ties by slot-major position
    (slot * S + supertile) as it reads the pool; smaller ones take a stable
    top-k over the slot-major order ([B, k_sub, S] flattened), as
    `lax.top_k` after the Pallas merge's transpose does."""
    b, num_super, k_sub = vals.shape
    out_k = min(max(k, merge_k), num_super * k_sub)
    if uses_packed_super_merge(num_super, k_sub, out_k):
        return packed_candidate_merge(vals, idxs, out_k)
    out_v, pos = stable_top_k(vals.transpose(1, 2).reshape(b, -1), out_k)
    return out_v, torch.gather(idxs.transpose(1, 2).reshape(b, -1), 1, pos)


# ---------------------------------------------------------------------------
# The fused selections the query step calls
# ---------------------------------------------------------------------------
def uses_packed_merge(tiles: int, k: int, merge_k: int) -> bool:
    """Whether the merge of `tiles` x `k` candidates goes through kernel B2:
    pools of >= 4096 candidates with out_k <= 128, as
    `_merge_tile_candidates` routes them."""
    out_k = min(max(k, merge_k), tiles * k)
    return out_k <= MAX_TILE_K and tiles * k >= PACKED_MERGE_MIN_POOL


def merge_tile_candidates(
    vals: torch.Tensor, idxs: torch.Tensor, merge_k: int, *, packed: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-tile merge of [B, tiles, k] per-tile candidates into the top
    max(k, merge_k) (at most the pool).  Large pools of packed candidates
    go through kernel B2 (`uses_packed_merge`, ties by slot-major position);
    smaller pools, and the exact kernel's candidates (`packed=False`), take
    a stable top-k over the tile-major layout (`lax.top_k`'s tie rule)."""
    b, tiles, k = vals.shape
    out_k = min(max(k, merge_k), tiles * k)
    if packed and uses_packed_merge(tiles, k, merge_k):
        return packed_candidate_merge(vals, idxs, out_k)
    out_v, pos = stable_top_k(vals.reshape(b, -1), out_k)
    return out_v, torch.gather(idxs.reshape(b, -1), 1, pos)


def tile_pick_count(top_k: int, n: int, tile_n: int, merge_k: int) -> int:
    """Per-tile pick count: top_k, raised to ceil(merge_k / tiles) when the
    tiles are too few for the pool to cover merge_k."""
    k = min(top_k, n)
    tiles = -(-n // tile_n)
    if merge_k > k and tiles * k < merge_k:
        k = min(MAX_TILE_K, tile_n, -(-merge_k // tiles))
    return k


def _two_level_feasible(tile_n: int) -> bool:
    """The Pallas kernels' shape guard on their two-level selection, which
    supertiles need (`_use_two_level`; k <= 128 is checked on its own)."""
    return tile_n >= 256 and tile_n % 128 == 0


def _check_tile_k(top_k: int, n: int) -> int:
    """min(top_k, n), refused past the per-tile limit, as the Pallas
    kernels assert it (`topk_pallas.py:691`, :975)."""
    k = min(top_k, n)
    if k > MAX_TILE_K:
        raise ValueError(
            f"top_k={top_k}: a per-tile selection keeps at most {MAX_TILE_K} "
            "candidates (QueryEngine selects more through ops/similarity.py)"
        )
    return k


def cosine_top_k_int8(
    query_emb: torch.Tensor,
    e_int8: torch.Tensor,
    e_scale: torch.Tensor,
    valid_mask: torch.Tensor,
    top_k: int,
    *,
    tile_n: int = 2048,
    merge_k: int = 0,
    packed_select: bool = True,
    super_tiles: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 cosine + top-k of normalized queries [B, D] over an int8
    index [N, D] with row scales [N] and a row filter [N] bool; the
    counterpart of `pallas_cosine_top_k_int8`.

    The queries are quantized per row.  `packed_select=True` (every engine
    mode): kernel B1 keeps the exact top-k of every `tile_n`-row tile under
    the packed key — the contract of both the fused two-level branch (which
    approximates it) and the k-pass branch — with the per-tile pick count
    raised when the tiles are too few to cover merge_k; the merge keeps the
    best max(top_k, merge_k) of the pool, through kernel B2 for pools of
    >= 4096.  Values carry the packed key's 2^-11 quantization; surplus
    slots are (-1e30, -1) fillers.  `packed_select=False`: kernel B3e keeps
    every tile's exact top-k by raw value (ties to the lowest row) and a
    stable merge keeps the global top max(top_k, merge_k) by (value desc,
    index asc); filtered rows come back at -1e30.  `super_tiles` > 1 with
    the packed selection (`resolve_super_tiles`): kernel B7i keeps the
    exact top k_sub (`super_pick_count`) of every supertile of
    spt * tile_n rows under a key with a lane field that wide, and
    `merge_super_candidates` merges them.  Returns (values [B, m] f32,
    indices [B, m] int32)."""
    n = e_int8.shape[0]
    k = _check_tile_k(top_k, n)
    qi, qs = quantize_queries(query_emb.to(torch.float32))
    spt = resolve_super_tiles(super_tiles, tile_n, -(-n // tile_n),
                              _two_level_feasible(tile_n), packed_select)
    if spt > 1:
        lbits = spt * tile_n
        k_sub = super_pick_count(top_k, n, lbits, merge_k)
        vals, idxs = int8_super_tile_topk(qi, qs, e_int8, e_scale, valid_mask, k_sub, lbits)
        return merge_super_candidates(vals, idxs, k, merge_k)
    if packed_select:
        k = tile_pick_count(top_k, n, tile_n, merge_k)
        vals, idxs = int8_tile_topk(qi, qs, e_int8, e_scale, valid_mask, k, tile_n)
        return merge_tile_candidates(vals, idxs, merge_k)
    vals, idxs = int8_exact_tile_topk(qi, qs, e_int8, e_scale, valid_mask, k, tile_n)
    return merge_tile_candidates(vals, idxs, merge_k, packed=False)


def cosine_top_k(
    query_emb: torch.Tensor,
    index_emb: torch.Tensor,
    valid_mask: torch.Tensor,
    top_k: int,
    *,
    tile_n: int = 2048,
    merge_k: int = 0,
    packed_select: bool = False,
    super_tiles: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine + top-k of normalized queries [B, D] over a float index
    [N, D] (f32 or bf16) with a row filter [N] bool; the counterpart of
    `pallas_cosine_top_k`.

    The queries are cast to a bf16 index's type.  `packed_select=False`:
    kernel B4 keeps the exact top-k of every tile by raw value and a stable
    merge keeps the global top max(top_k, merge_k) by (value desc, index
    asc); filtered rows come back at -1e30 with their real indices.
    `packed_select=True`: kernel B5 selects under the packed key (values
    carry its 2^-11 quantization), with the per-tile pick count raised when
    the tiles are too few to cover merge_k, and the merge goes through
    kernel B2 for pools of >= 4096.  Surplus slots are (-1e30, -1) fillers.
    `super_tiles` > 1 with the packed selection: kernel B7f over supertiles
    and `merge_super_candidates`, as in `cosine_top_k_int8`.  Returns
    (values [B, m] f32, indices [B, m] int32)."""
    n = index_emb.shape[0]
    k = _check_tile_k(top_k, n)
    q = query_emb.to(
        torch.bfloat16 if index_emb.dtype == torch.bfloat16 else torch.float32
    )
    spt = resolve_super_tiles(super_tiles, tile_n, -(-n // tile_n),
                              _two_level_feasible(tile_n), packed_select)
    if spt > 1:
        lbits = spt * tile_n
        k_sub = super_pick_count(top_k, n, lbits, merge_k)
        vals, idxs = float_packed_super_tile_topk(q, index_emb, valid_mask, k_sub, lbits)
        return merge_super_candidates(vals, idxs, k, merge_k)
    if packed_select:
        k_tile = tile_pick_count(top_k, n, tile_n, merge_k)
        vals, idxs = float_packed_tile_topk(q, index_emb, valid_mask, k_tile, tile_n)
        return merge_tile_candidates(vals, idxs, merge_k)
    vals, idxs = float_tile_topk(q, index_emb, valid_mask, k, tile_n)
    return merge_tile_candidates(vals, idxs, merge_k, packed=False)
