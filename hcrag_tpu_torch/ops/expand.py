"""One-hop subgraph expansion over padded (ELL) adjacency, batched.

Counterpart of `dedup_and_cap`, `_ordered_unique_mask` and
`expand_batch_early_exit` in `hcrag_tpu/ops/expand.py` at depth <= 1, the
depth of the query step: one frontier gather over the [G, M] neighbor
table, a discovery-order dedup, and a cap that keeps the FIRST `max_nodes`
discovered nodes.  Outputs are [B, max_nodes] id buffers padded with -1 plus
a [B] count.  Deeper expansion (the second-hop table, the early exit and
the sort-based dedup for large candidate sets) is ROADMAP.md item A5.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _ordered_unique_mask(candidates: torch.Tensor) -> torch.Tensor:
    """[B, C] bool mask keeping the first occurrence of each valid (>= 0) id
    in every row of `candidates` ([B, C] int, -1 padding), by an O(C^2)
    pairwise comparison (C = 80 candidates at depth 1)."""
    c = candidates.shape[1]
    pos = torch.arange(c, device=candidates.device)
    earlier = pos[None, :] < pos[:, None]  # [C, C]: j < i
    eq = candidates[:, None, :] == candidates[:, :, None]  # [B, C, C]
    seen_before = (eq & earlier).any(dim=2)
    return (candidates >= 0) & ~seen_before


def dedup_and_cap(
    candidates: torch.Tensor, max_nodes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discovery-order dedup + cap over [B, C] candidate ids.

    Returns (connected [B, max_nodes] int32 padded with -1, count [B]
    int32)."""
    b = candidates.shape[0]
    keep = _ordered_unique_mask(candidates)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    keep = keep & (rank < max_nodes)
    count = keep.sum(dim=1, dtype=torch.int32)
    # One spare column takes every dropped candidate; it is cut off below.
    out = torch.full(
        (b, max_nodes + 1), -1, dtype=torch.int32, device=candidates.device
    )
    out.scatter_(
        1,
        torch.where(keep, rank, max_nodes),
        torch.where(keep, candidates, -1).to(torch.int32),
    )
    return out[:, :max_nodes], count


def expand_batch_early_exit(
    neighbors: torch.Tensor,
    seed_batch: torch.Tensor,
    *,
    depth: int = 1,
    max_nodes: int = 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched one-hop expansion of [B, S] seed sets (-1 = no seed) over
    the [G, M] neighbor table.  Depth 0 still expands one hop, as the JAX
    package does; a single hop has nothing to exit early from."""
    if depth > 1:
        raise NotImplementedError(
            "expansion beyond one hop is not ported yet (ROADMAP.md A5)"
        )
    b = seed_batch.shape[0]
    safe = torch.where(seed_batch >= 0, seed_batch, 0).to(torch.int64)
    nb = neighbors[safe]  # [B, S, M]
    nb = torch.where((seed_batch >= 0)[..., None], nb, -1)
    return dedup_and_cap(nb.reshape(b, -1), max_nodes)
