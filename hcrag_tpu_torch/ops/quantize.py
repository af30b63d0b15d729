"""Int8 index and query quantization.

Counterpart of `quantize_rows` and `quantize_queries` in
`hcrag_tpu/ops/quantize.py`.  Symmetric per-row scales; scores recover as

    score[b, n] = int_dot[b, n] * q_scale[b] * e_scale[n]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quantize_rows(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 quantization on the host.

    Returns (q [N, D] int8, scale [N] float32) with row ~= q * scale;
    byte-equal to the JAX package's `quantize_rows`.
    """
    emb = np.asarray(emb, dtype=np.float32)
    absmax = np.abs(emb).max(axis=1)
    scale = (absmax / 127.0).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(emb / safe[:, None]), -127, 127).astype(np.int8)
    return q, scale


def quantize_queries(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of a float32 query batch on its device:
    (q8 [B, D] int8, scale [B] float32).  `torch.round` rounds half to
    even, as `jnp.round` does."""
    absmax = q.abs().amax(dim=1)
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    qi = torch.clamp(torch.round(q / safe[:, None]), -127, 127).to(torch.int8)
    return qi, scale.to(torch.float32)
