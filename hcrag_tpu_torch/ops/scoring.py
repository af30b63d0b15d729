"""Relevance-scoring helpers of the query step.

Counterpart of `popcount_words` and `combine_metrics_dynamic` in
`hcrag_tpu/ops/scoring.py`.  Entity bitsets are uint32 words in the JAX
package; here they travel as int32 tensors holding the same bits (torch's
uint32 lacks bitwise ops on CUDA), and the popcount is a SWAR bit trick
(torch has no popcount).
"""

from __future__ import annotations

import torch


def popcount_words(bits: torch.Tensor) -> torch.Tensor:
    """Total set-bit count along the trailing word axis ([..., W] int32
    words holding uint32 bit patterns) -> [...] int32."""
    x = bits.to(torch.int64) & 0xFFFFFFFF  # the unsigned word, no sign bits
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = (x + (x >> 16)) & 0x3F
    return x.sum(dim=-1).to(torch.int32)


def combine_metrics_dynamic(
    metrics: torch.Tensor,
    weight_tensor: torch.Tensor,
    intent_ids: torch.Tensor,
    type_ids: torch.Tensor,
) -> torch.Tensor:
    """Fuse a [..., M] metric stack with per-(intent, node-type) weights
    [M, I, T]: a weighted AVERAGE (sum of weight * metric over the sum of
    weights), gathered per node.

    `intent_ids` broadcasts against `type_ids`, whose shape is
    metrics.shape[:-1].  Returns metrics.shape[:-1] float32 scores.
    """
    w_t = weight_tensor.to(torch.float32)
    ii = torch.broadcast_to(intent_ids.to(torch.int64), type_ids.shape)
    w = w_t[:, ii, type_ids.to(torch.int64)]  # [M, ...]
    w = torch.movedim(w, 0, -1)  # [..., M]
    num = torch.sum(w * metrics.to(torch.float32), dim=-1)
    den = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    return num / den
