"""Int8 index and query quantization.

Counterpart of `quantize_rows`, `quantize_residual`, `quantized_scores`,
`quantize_queries` and `streaming_quantized_top_k` in
`hcrag_tpu/ops/quantize.py`.  Symmetric per-row
scales; scores recover as

    score[b, n] = int_dot[b, n] * q_scale[b] * e_scale[n]

The index quantizers work in row chunks: every row's result depends on that
row alone, so the output is byte-equal to the JAX package's, while the f32
temporaries stay at one chunk (the whole-array version holds several copies
of the index at once: ~15 GB each at 10M x 384).  One chunk function serves
the host (`quantize_rows`, `quantize_residual`) and the engine, which
quantizes on its own device (`quantize_bank`): division, rounding half to
even and the residual's separate multiply and subtract round alike on the
CPU and the card.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from hcrag_tpu_torch.ops.similarity import merge_chunk_top_k, dots, fast_top_k

ROW_CHUNK = 1 << 16  # rows per chunk: 96 MB of f32 at D=384


def _quantize_chunk(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q [n, D] int8, scale [n] f32) of f32 rows x [n, D]."""
    scale = x.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _residual_chunk(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second level (r [n, D] int8, rscale [n] f32) of f32 rows x [n, D]
    whose first level is (q, scale): the quantized x - q * scale."""
    return _quantize_chunk(x - q.to(torch.float32) * scale[:, None])


def _f32_rows(emb, lo: int, hi: int) -> torch.Tensor:
    """Rows lo:hi of a bank (a host array, or a tensor on any device) as an
    f32 tensor (a bfloat16 bank widens exactly)."""
    if isinstance(emb, torch.Tensor):
        return emb[lo:hi].to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(emb[lo:hi], dtype=np.float32))


def quantize_bank(
    emb: Union[np.ndarray, torch.Tensor],
    device: torch.device,
    n_rows: Optional[int] = None,
    *,
    residual: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Quantize a bank [N, D] (a host array, or a tensor, as the kernel
    sweep's bf16 bank on the card) on `device`, one row chunk at a time:
    (q8 [n_rows, D] int8, scale [n_rows] f32) and, with `residual`, the
    second level (r8, rscale) of `quantize_residual`.  Rows past N (up to
    `n_rows`, default N) are zero rows with zero scales, as quantizing zero
    rows gives.  Byte-equal to `quantize_rows` / `quantize_residual`."""
    n, d = emb.shape
    n_rows = n if n_rows is None else n_rows
    outs = [torch.zeros((n_rows, d), dtype=torch.int8, device=device),
            torch.zeros((n_rows,), dtype=torch.float32, device=device)]
    if residual:
        outs += [torch.zeros_like(outs[0]), torch.zeros_like(outs[1])]
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        x = _f32_rows(emb, lo, hi).to(device)
        q, scale = _quantize_chunk(x)
        outs[0][lo:hi], outs[1][lo:hi] = q, scale
        if residual:
            outs[2][lo:hi], outs[3][lo:hi] = _residual_chunk(x, q, scale)
    return tuple(outs)


def quantize_rows(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization on the host.

    `emb` [N, D] is read as float32 (a bfloat16 array widens exactly).
    Returns (q [N, D] int8, scale [N] float32) with row ~= q * scale;
    byte-equal to the JAX package's `quantize_rows`.
    """
    q8, scale = quantize_bank(emb, torch.device("cpu"))
    return q8.numpy(), scale.numpy()


def quantize_residual(
    emb: np.ndarray, q8: np.ndarray, scale: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Second-level int8 quantization of the first level's residual
    emb - q8 * scale: (r8 [N, D] int8, rscale [N] float32), so that
    row ~= q8 * scale + r8 * rscale.  Byte-equal to the JAX package's
    `quantize_residual`."""
    n, d = emb.shape
    r8 = np.empty((n, d), np.int8)
    rscale = np.empty(n, np.float32)
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        r, rs = _residual_chunk(_f32_rows(emb, lo, hi), torch.from_numpy(q8[lo:hi]),
                                torch.from_numpy(scale[lo:hi]))
        r8[lo:hi], rscale[lo:hi] = r.numpy(), rs.numpy()
    return r8, rscale


def check_exact_matmul() -> None:
    """Refuse to take dots as float32 matrix products unless they run in
    full float32: int8 dots are exact there (|dot| <= 127^2 * 384 < 2^24)
    and float dots keep f32 products, but not under TF32 (the TPU kernels
    pin Precision.HIGHEST)."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "plain dots need full-precision float32 matmuls: "
            "TF32 / reduced float32 matmul precision is enabled"
        )


def quantized_scores(
    q_int8: torch.Tensor,
    q_scale: torch.Tensor,
    e_int8: torch.Tensor,
    e_scale: torch.Tensor,
) -> torch.Tensor:
    """Cosine scores [B, N] from int8 operands: the integer dots (exact,
    `similarity.dots`), then the rank-1 rescale (dot * q_scale) * e_scale,
    in that order."""
    return dots(q_int8, e_int8) * q_scale[:, None].to(torch.float32) * e_scale[
        None, :
    ].to(torch.float32)


#: 1/127 rounded to float32.  The JAX engine quantizes its queries inside
#: jit, where XLA's algebraic simplifier turns `absmax / 127.0` into
#: `absmax * (1 / 127)`; for about 4% of queries that scale differs from the
#: quotient in its last bit.
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of a float32 query batch on its device:
    (q8 [B, D] int8, scale [B] float32), bit-equal to the JAX package's
    `quantize_queries` as its engine runs it (under jit).  `torch.round`
    rounds half to even, as `jnp.round` does."""
    absmax = q.abs().amax(dim=1)
    scale = absmax * INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    qi = torch.clamp(torch.round(q / safe[:, None]), -127, 127).to(torch.int8)
    return qi, scale.to(torch.float32)


def streaming_quantized_top_k(
    q: torch.Tensor,
    e_int8: torch.Tensor,
    e_scale: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    chunk_rows: int = 1 << 17,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over an int8 index [N, D] with row scales [N], streamed
    over `chunk_rows`-row chunks: the queries [B, D] are quantized
    (`quantize_queries`), each chunk's `quantized_scores` (filtered rows at
    -inf) give their top-k, and one position-stable top-k merges them.
    Returns (values [B, k], indices [B, k] int32), k = min(k, N); ties to
    the lowest global index."""
    n = e_int8.shape[0]
    k = min(k, n)
    qi, qs = quantize_queries(q.to(torch.float32))
    neg = torch.tensor(float("-inf"), device=q.device)
    vals, idxs = [], []
    for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        s = quantized_scores(qi, qs, e_int8[lo:hi], e_scale[lo:hi])
        v, i = fast_top_k(torch.where(valid_mask[None, lo:hi], s, neg), min(k, hi - lo))
        vals.append(v)
        idxs.append(i + lo)
    return merge_chunk_top_k(vals, idxs, k)
