"""k-hop subgraph expansion over padded (ELL) adjacency, batched.

Counterpart of `hcrag_tpu/ops/expand.py`.  Expansion is a fixed-depth
breadth-first sweep: each hop gathers the frontier's rows of a [G, M]
neighbor table (the first hop over the whitelisted table, later hops over
`hop2_neighbors` when given: the reference's ANNOTATION-only second leg),
then a discovery-order dedup keeps the FIRST occurrence of each node and a
cap keeps the first `max_nodes` of them.  Outputs are [B, max_nodes] id
buffers padded with -1 plus a [B] count.

The JAX functions work on one seed set and are vmapped; here every function
takes a batch dimension except `expand_k_hop`, which keeps the JAX one-query
signature.  `expand_batch_early_exit` stops after the hop at which every
query of the batch has `max_nodes` nodes (one host sync per hop), with the
same results as `expand_batch`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from hcrag_tpu_torch.core.types import edge_type_id
from hcrag_tpu_torch.utils import timing

#: The pairwise dedup builds a [B, C, C] mask; past this many elements the
#: sort-based lowering runs instead (same result).
PAIRWISE_MAX_ELEMENTS = 1 << 26


def _ordered_unique_mask(candidates: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """[B, C] bool mask keeping the first occurrence of each valid (>= 0) id
    in every row of `candidates` ([B, C] int, -1 padding).

    Two lowerings with one result: for small batches of short lists an
    O(C^2) pairwise comparison; otherwise a stable sort of each row by id
    (ids < 0 sort as `num_nodes`), which keeps positions ascending within
    a run of one id, so each run's start is that id's first occurrence, and
    a scatter of the run starts back to their positions.  At depth 3 with
    100 seeds of degree 8, C is 58,400."""
    b, c = candidates.shape
    if b * c * c <= PAIRWISE_MAX_ELEMENTS:
        pos = torch.arange(c, device=candidates.device)
        earlier = pos[None, :] < pos[:, None]  # [C, C]: j < i
        eq = candidates[:, None, :] == candidates[:, :, None]  # [B, C, C]
        seen_before = (eq & earlier).any(dim=2)
        return (candidates >= 0) & ~seen_before
    safe = torch.where(candidates >= 0, candidates.to(torch.int64), num_nodes)
    s_ids, s_pos = torch.sort(safe, dim=1, stable=True)
    run_start = torch.ones_like(s_ids, dtype=torch.bool)
    run_start[:, 1:] = s_ids[:, 1:] != s_ids[:, :-1]
    first = torch.zeros_like(run_start).scatter_(1, s_pos, run_start)
    return (candidates >= 0) & first


def dedup_and_cap(
    candidates: torch.Tensor,
    num_nodes: int,
    max_nodes: int,
    seeds: Optional[torch.Tensor] = None,
    exclude_seeds: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discovery-order dedup + cap over [B, C] candidate ids of a graph of
    `num_nodes` nodes; with `exclude_seeds`, ids among the row's `seeds`
    ([B, S]) are dropped too.

    Returns (connected [B, max_nodes] int32 padded with -1, count [B]
    int32)."""
    b = candidates.shape[0]
    timing.count("expand.candidate_slots", b * candidates.shape[1])
    keep = _ordered_unique_mask(candidates, num_nodes)
    if exclude_seeds and seeds is not None and seeds.shape[1]:
        # Membership in the row's seeds by binary search, not a [B, C, S] mask.
        s_sorted = torch.sort(seeds.to(torch.int64), dim=1).values.contiguous()
        c64 = candidates.to(torch.int64).contiguous()
        at = torch.searchsorted(s_sorted, c64).clamp(max=s_sorted.shape[1] - 1)
        keep = keep & ~(torch.gather(s_sorted, 1, at) == c64)
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


def _gather_hop(table: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """[B, F] frontier ids (-1 = none) -> [B, F * M] neighbor candidates of
    the [G, M] table in frontier-major order (-1 where there is none)."""
    safe = torch.where(frontier >= 0, frontier, 0).to(torch.int64)
    nb = table[safe]  # [B, F, M]
    nb = torch.where((frontier >= 0)[..., None], nb, -1)
    return nb.reshape(frontier.shape[0], -1)


def expand_batch(
    neighbors: torch.Tensor,
    seed_batch: torch.Tensor,
    *,
    depth: int = 1,
    max_nodes: int = 20,
    exclude_seeds: bool = False,
    hop2_neighbors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand [B, S] seed sets (-1 = no seed) by `depth` >= 1 hops: the
    first over `neighbors` [G, M], the others over `hop2_neighbors` when
    given, else `neighbors`.  Each hop's frontier is the previous hop's
    candidates, duplicates included (a repeated node expands to the same
    neighbors, and the final dedup keeps first occurrences only).

    Returns (connected [B, max_nodes] int32, -1 padded, count [B] int32) in
    discovery order: hop-1 neighbors of seed 0, of seed 1, ..., then
    hop 2, deduplicated keeping first occurrences."""
    if depth < 1:
        raise ValueError(f"expand_batch needs depth >= 1, got {depth}")
    table2 = neighbors if hop2_neighbors is None else hop2_neighbors
    frontier = seed_batch
    hops: List[torch.Tensor] = []
    for hop in range(depth):
        frontier = _gather_hop(neighbors if hop == 0 else table2, frontier)
        hops.append(frontier)
    return dedup_and_cap(
        torch.cat(hops, dim=1), neighbors.shape[0], max_nodes, seeds=seed_batch,
        exclude_seeds=exclude_seeds,
    )


def expand_k_hop(
    neighbors: torch.Tensor,
    seeds: torch.Tensor,
    *,
    depth: int = 1,
    max_nodes: int = 20,
    exclude_seeds: bool = False,
    hop2_neighbors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`expand_batch` of one seed set [S]: (connected [max_nodes] int32,
    count int32 scalar)."""
    out, count = expand_batch(
        neighbors, seeds[None], depth=depth, max_nodes=max_nodes,
        exclude_seeds=exclude_seeds, hop2_neighbors=hop2_neighbors,
    )
    return out[0], count[0]


def expand_batch_early_exit(
    neighbors: torch.Tensor,
    seed_batch: torch.Tensor,
    *,
    depth: int = 1,
    max_nodes: int = 20,
    hop2_neighbors: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`expand_batch` (without seed exclusion) that stops early: hop-h
    candidates all precede hop-(h+1) candidates in discovery order, so once
    every query of the batch has `max_nodes` unique nodes among the hops
    so far, deeper hops change no result.  After each hop but the last,
    one host sync reads whether that holds.  Depth 0 expands one hop, as
    the JAX function does.

    Recorded (`utils/timing`): a span per hop and per sync; the counter
    `expand.kept_nodes` (the final counts' sum, on the device)."""
    g = neighbors.shape[0]
    table2 = neighbors if hop2_neighbors is None else hop2_neighbors
    last, hop = seed_batch, 0
    while True:
        hop += 1
        with timing.span("engine.expand.hop", hop=hop):
            last = _gather_hop(neighbors if hop == 1 else table2, last)
            cands = last if hop == 1 else torch.cat([cands, last], dim=1)
            out, count = dedup_and_cap(cands, g, max_nodes)
        if hop >= depth:
            break
        full = (count >= max_nodes).all()
        with timing.span("engine.expand.sync"):
            if bool(full):
                break
    timing.count("expand.kept_nodes", count)
    return out, count


def expansion_edges_host(
    graph,
    seeds: Sequence[int],
    *,
    whitelist: Sequence[str] = ("ANNOTATION", "DESCRIBED_BY"),
    max_nodes: int = 20,
) -> List[Tuple[int, int, int]]:
    """Host-side edge enumeration for visualization: (src, dst, edge_type)
    triples in discovery order over the whitelisted edges of each seed
    (-1 seeds skipped), keeping the edges into the first `max_nodes`
    distinct nodes discovered."""
    allowed = {edge_type_id(w) for w in whitelist}
    edges: List[Tuple[int, int, int]] = []
    seen = set()
    for seed in seeds:
        if seed < 0:
            continue
        nbrs, types = graph.neighbors_of(int(seed))
        for nb, t in zip(nbrs, types):
            if int(t) not in allowed:
                continue
            if int(nb) not in seen and len(seen) < max_nodes:
                seen.add(int(nb))
            if int(nb) in seen:
                edges.append((int(seed), int(nb), int(t)))
    return edges
