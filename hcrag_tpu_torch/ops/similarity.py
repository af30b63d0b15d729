"""Dense similarity and top-k: the selection route without a kernel.

Counterpart of `hcrag_tpu/ops/similarity.py`: `l2_normalize`,
`cosine_scores`, `normalized_cosine`, `fast_top_k`, `chunked_top_k`,
`dense_top_k`, `threshold_mask`, `masked_top_k` and
`streaming_masked_top_k`.  The JAX engine selects through these off the TPU
(`hcrag_tpu/query/engine.py:629-639`); the port's engine takes them where
the per-tile kernels cannot hold the request (more than 128 candidates).

The tie rule is `jax.lax.top_k`'s: values descending, ties to the LOWEST
index.  `torch.topk` promises no order among ties, so `top_k` is a stable
sort; the chunked variants scan their chunks in ascending order and merge
position-stably, so they keep that rule across chunks.  `fast_top_k` is the
`lax.top_k` branch of its JAX counterpart: the port runs on no TPU.

The dots (`dots`) are taken in float64 and rounded to float32: products of
f32 or bf16 values and their sums are then at least as exact as JAX's f32
dot at `Precision.HIGHEST`, and no TF32 or `float32_matmul_precision`
setting of the caller can reach them.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Rows of the bank past which the engine streams its selection in chunks
#: (the JAX engine's rule, `engine.py:619`, :631).
STREAMING_MIN_ROWS = 1 << 18


def l2_normalize(x: torch.Tensor, eps: float = 1e-12, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim`; zero vectors stay zero (cosine 0)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, descending, ties to the
    lowest index: (values [..., k], indices [..., k] int64)."""
    sv, si = torch.sort(values, dim=-1, descending=True, stable=True)
    return sv[..., :k], si[..., :k]


def dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, D] . b [N, D]^T as float32 [M, N], summed in float64 (exact
    for int8 operands)."""
    return (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.float32)


def cosine_scores(
    query_emb: torch.Tensor,
    index_emb: torch.Tensor,
    *,
    index_normalized: bool = True,
) -> torch.Tensor:
    """Cosine similarity [B, N] f32 of queries [B, D] (any norm) with the
    index [N, D]; pass `index_normalized=False` for raw rows.  The queries
    are cast to the index's type first (a bf16 index's normalized rows stay
    f32), as the JAX function casts them."""
    q = l2_normalize(query_emb.to(torch.float32))
    e = index_emb if index_normalized else l2_normalize(index_emb.to(torch.float32))
    return dots(q.to(index_emb.dtype), e)


def normalized_cosine(raw_cosine: torch.Tensor) -> torch.Tensor:
    """Map cosine in [-1, 1] to [0, 1]: (sim + 1) / 2."""
    return (raw_cosine + 1.0) * 0.5


def fast_top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last axis: (values [..., k], indices [..., k]
    int32), ties to the lowest index."""
    v, i = top_k(scores, k)
    return v, i.to(torch.int32)


def chunked_top_k(
    scores: torch.Tensor, k: int, chunk: int = 16384
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k over the last axis of scores [B, N]: the top-k of
    every `chunk` columns (the last chunk padded with -inf), then the top-k
    of the [B, chunks * k] survivors in chunk-major order.  Returns
    (values [B, k], indices [B, k] int32), k = min(k, N), sorted
    descending, ties to the lower index."""
    b, n = scores.shape
    k = min(k, n)
    if n <= max(chunk, 4 * k):
        return fast_top_k(scores, k)
    pad = (-n) % chunk
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    c = scores.shape[1] // chunk
    kc = min(k, chunk)
    v1, i1 = fast_top_k(scores.view(b, c, chunk), kc)  # [B, C, kc]
    base = (torch.arange(c, dtype=torch.int32, device=scores.device) * chunk)[None, :, None]
    gi1 = (i1 + base).reshape(b, c * kc)
    v2, i2 = fast_top_k(v1.reshape(b, c * kc), k)
    return v2, torch.gather(gi1, 1, i2.to(torch.int64))


def dense_top_k(
    query_emb: torch.Tensor,
    index_emb: torch.Tensor,
    top_k: int,
    *,
    index_normalized: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine + top-k: (scores [B, k], indices [B, k] int32); thresholding
    is left to the caller."""
    scores = cosine_scores(query_emb, index_emb, index_normalized=index_normalized)
    return chunked_top_k(scores, top_k)


def threshold_mask(scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """Keep-mask of scores at or above `threshold`."""
    return scores >= threshold


def masked_top_k(
    scores: torch.Tensor, valid_mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of scores [B, N] restricted to the rows where valid_mask [N]
    is set: the others score -inf, and come back as -inf with their own
    (lowest) indices when fewer than k rows are valid."""
    neg = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    return chunked_top_k(torch.where(valid_mask[None, :], scores, neg), k)


def merge_chunk_top_k(vals, idxs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k of per-chunk candidates, lists of [B, k] in ascending
    chunk order, merged position-stably (ties to the lower chunk)."""
    v = torch.cat(vals, dim=1)
    i = torch.cat(idxs, dim=1)
    out_v, pos = fast_top_k(v, k)
    return out_v, torch.gather(i, 1, pos.to(torch.int64))


def streaming_masked_top_k(
    query_emb: torch.Tensor,
    index_emb: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    chunk_rows: int = 1 << 17,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine + masked top-k streamed over `chunk_rows`-row chunks of the
    index: each chunk's [B, chunk] scores (queries [B, D] cast to the
    index's type, filtered rows at -inf) give their top-k, and one top-k
    merges them, so no [B, N] buffer is held.  Queries and rows are taken
    as normalized.  Returns (values [B, k], indices [B, k] int32),
    k = min(k, N); ties to the lowest global index."""
    n = index_emb.shape[0]
    k = min(k, n)
    q = query_emb.to(index_emb.dtype)
    neg = torch.tensor(float("-inf"), device=query_emb.device)
    vals, idxs = [], []
    for lo in range(0, n, chunk_rows):
        hi = min(n, lo + chunk_rows)
        s = torch.where(valid_mask[None, lo:hi], dots(q, index_emb[lo:hi]), neg)
        # A ragged last chunk stands for one padded with zero rows at -inf;
        # those can only fill slots after every real row.
        v, i = fast_top_k(s, min(k, hi - lo))
        vals.append(v)
        idxs.append(i + lo)
    return merge_chunk_top_k(vals, idxs, k)
