"""Normalization and a stable top-k.

Counterpart of `l2_normalize` in `hcrag_tpu/ops/similarity.py` and of the
tie rule of `jax.lax.top_k`: values descending, ties to the LOWEST index.
`torch.topk` promises no order among ties, so `top_k` is a stable sort.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12, dim: int = -1) -> torch.Tensor:
    """L2-normalize along `dim`; zero vectors stay zero (cosine 0)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, descending, ties to the
    lowest index: (values [..., k], indices [..., k] int64)."""
    sv, si = torch.sort(values, dim=-1, descending=True, stable=True)
    return sv[..., :k], si[..., :k]
