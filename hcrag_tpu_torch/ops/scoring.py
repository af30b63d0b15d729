"""Batched relevance-scoring ops: the four metrics of `isRelevant` over a
node batch and their fusion.

Counterpart of `hcrag_tpu/ops/scoring.py`.  Entity bitsets are uint32 words
in the JAX package; here they travel as int32 tensors holding the same bits
(torch's uint32 lacks bitwise ops on CUDA), and the popcount is a SWAR bit
trick (torch has no popcount).  The f32 dots are elementwise products and
sums, so no TF32 / `float32_matmul_precision` setting changes them.

  * semantic similarity -> (cosine + 1) / 2
  * entity match        -> |q & n| / |q|, with 0.5 (both empty) and 0.1
                           (query empty) for an empty query
  * node-type priority  -> PRIORITY_MATRIX[intent, type]
  * llm judge           -> a host-supplied column; 0.0 when the strategy
                           does not use it
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.core.types import (
    PRIORITY_MATRIX,
    REDUCE_MAX,
    CompositeWeights,
    ScorerType,
    scorer_needs_llm,
    scorer_spec,
)

IntLike = Union[int, torch.Tensor]


def semantic_similarity_scores(
    query_emb: torch.Tensor, node_emb: torch.Tensor
) -> torch.Tensor:
    """Normalized cosine similarity in [0, 1]: query_emb [B, D] or [D]
    against raw node embeddings [N, D] -> [B, N] (or [N])."""
    single = query_emb.ndim == 1
    q = torch.atleast_2d(query_emb).to(torch.float32)
    e = node_emb.to(torch.float32)
    qn = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    en = e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-12)
    cos = (qn[:, None, :] * en[None, :, :]).sum(dim=-1)
    out = (cos + 1.0) * 0.5
    return out[0] if single else out


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


def entity_match_scores(
    query_bits: torch.Tensor,
    node_bits: torch.Tensor,
    node_counts: Optional[torch.Tensor] = None,
    query_oov: Optional[IntLike] = None,
) -> torch.Tensor:
    """Entity-match metric over bitset-encoded entity sets: query_bits
    [B, W] or [W] and node_bits [N, W] int32 words -> [B, N] (or [N]) f32.

      |q| > 0            -> |q & n| / |q|
      |q| == 0, |n| == 0 -> 0.5
      |q| == 0, |n| > 0  -> 0.1

    Query entities outside the vocabulary match nothing but count toward
    |q|: pass their number as `query_oov` ([B] or a scalar).  `node_counts`
    ([N]) defaults to the popcounts of node_bits."""
    single = query_bits.ndim == 1
    qb = torch.atleast_2d(query_bits)
    q_count = popcount_words(qb)
    if query_oov is not None:
        q_count = q_count + torch.atleast_1d(
            torch.as_tensor(query_oov, dtype=torch.int32, device=qb.device)
        )
    if node_counts is None:
        node_counts = popcount_words(node_bits)
    inter = popcount_words(qb[:, None, :] & node_bits[None, :, :])
    ratio = inter.to(torch.float32) / torch.clamp(
        q_count[:, None].to(torch.float32), min=1.0
    )
    out = torch.where(
        (q_count == 0)[:, None],
        torch.where((node_counts == 0)[None, :], 0.5, 0.1),
        ratio,
    )
    return out[0] if single else out


def node_type_priority_scores(
    intent_id: IntLike, type_ids: torch.Tensor
) -> torch.Tensor:
    """Gather from the intent x node-type priority matrix: a scalar or [B]
    intent index against [N] type ids -> [N] (or [B, N]) f32."""
    table = torch.as_tensor(PRIORITY_MATRIX, device=type_ids.device)
    ii = torch.as_tensor(intent_id, dtype=torch.int64, device=type_ids.device)
    single = ii.ndim == 0
    out = table[torch.atleast_1d(ii)[:, None], type_ids.to(torch.int64)[None, :]]
    return out[0] if single else out


def graph_centrality_scores(degrees: torch.Tensor, *, scale: float = 50.0) -> torch.Tensor:
    """Degree-centrality metric of the v1 scorer design: min(degree / 50,
    1.0)."""
    return torch.clamp(degrees.to(torch.float32) / scale, max=1.0)


def combine_metrics(
    metrics: torch.Tensor, weights: torch.Tensor, reduction: int
) -> torch.Tensor:
    """Fuse a [..., 4] metric stack: the weighted sum over the metric axis
    (REDUCE_WEIGHTED_SUM) or its maximum (REDUCE_MAX)."""
    if reduction == REDUCE_MAX:
        return metrics.amax(dim=-1)
    return (metrics * weights.to(metrics.dtype)).sum(dim=-1)


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


def batch_relevance(
    *,
    query_emb: torch.Tensor,
    query_bits: torch.Tensor,
    intent_id: IntLike,
    node_emb: torch.Tensor,
    node_bits: torch.Tensor,
    node_type_ids: torch.Tensor,
    scorer_type: ScorerType,
    weights: Optional[CompositeWeights] = None,
    llm_scores: Optional[torch.Tensor] = None,
    node_entity_counts: Optional[torch.Tensor] = None,
    query_oov: Optional[IntLike] = None,
) -> torch.Tensor:
    """`batch_isRelevant`'s scores for one query as tensor ops: query_emb
    [D], query_bits [W], node_emb [N, D], node_bits [N, W], node_type_ids
    [N], llm_scores [N] (used only when the strategy reads the judge; zeros
    otherwise) -> [N] f32."""
    n = node_emb.shape[0]
    sem = semantic_similarity_scores(query_emb, node_emb)
    ent = entity_match_scores(query_bits, node_bits, node_entity_counts, query_oov)
    typ = node_type_priority_scores(intent_id, node_type_ids)
    if llm_scores is None or not scorer_needs_llm(scorer_type):
        llm = torch.zeros((n,), dtype=torch.float32, device=node_emb.device)
    else:
        llm = llm_scores.to(torch.float32)
    metrics = torch.stack([sem, llm, ent, typ], dim=-1)
    w, reduction = scorer_spec(scorer_type, weights)
    return combine_metrics(metrics, torch.from_numpy(np.asarray(w)).to(node_emb.device),
                           reduction)
