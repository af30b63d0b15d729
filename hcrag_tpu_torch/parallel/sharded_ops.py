"""Shard-local selection and the merge across ranks (the communication layer).

Counterpart of `hcrag_tpu/parallel/sharded_ops.py`, one process per rank:

  * the index rows are split contiguously over the mesh's rows axis; each
    rank holds its block and passes it here (`banks`, `valid_mask`);
  * each rank selects over its own block (the engine's kernels, or a plain
    product and top-k), with no communication;
  * the per-rank (values, global indices) candidates are all-gathered over
    the rows axis: O(ranks * m) a query, small beside the product;
  * a final top-k over the gathered candidates runs on every rank, so
    every rank ends with the same result.

Ties resolve to the lowest global index: each rank's candidates come
sorted with ties to the lowest local index, the gather concatenates them
rank-major (= ascending global row), and the merge is a stable sort
(`ops/similarity.top_k`), which prefers the lowest position, as
`lax.top_k` does.  The pools here are ranks x m candidates; kernel B2
(`packed_candidate_merge`) is kept for the pools of thousands inside a
shard.

Every collective goes through `_collective`, so a test can record each
call's kind and bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hcrag_tpu_torch.ops.similarity import candidate_dots, dots
from hcrag_tpu_torch.ops.similarity import top_k as stable_top_k
from hcrag_tpu_torch.parallel.mesh import ROWS_AXIS, Mesh


def _collective(kind: str, tensor: torch.Tensor, group) -> torch.Tensor:
    """The one place where tensors cross ranks.  "all_gather": the
    group's tensors stacked [s, ...] in group-rank order; "all_reduce": the
    sum over the group, taken in place (pass a temporary)."""
    if kind == "all_gather":
        n = dist.get_world_size(group)
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor.contiguous(), group=group)
        return torch.stack(parts)
    if kind == "all_reduce":
        dist.all_reduce(tensor, group=group)
        return tensor
    raise ValueError(f"unknown collective {kind!r}")


def _batch_slice(mesh: Mesh, batch_axis: Optional[str], b: int) -> Tuple[int, int]:
    """This rank's [lo, lo + per) slice of a batch of b queries split over
    `batch_axis` (the whole batch without one); the last slice may run past
    b, and its extra rows are dropped after the gather."""
    if batch_axis is None:
        return 0, b
    per = -(-b // mesh.shape[batch_axis])
    return mesh.coords[batch_axis] * per, per


def sharded_top_k(
    mesh: Mesh,
    query_emb: torch.Tensor,
    index_emb: Optional[torch.Tensor],
    top_k: int,
    valid_mask: Optional[torch.Tensor] = None,
    batch_axis: Optional[str] = None,
    *,
    banks: Optional[dict] = None,
    local_select=None,
    fetch_k: int = 0,
    rescore_key: Optional[str] = None,
    rescore_rows=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine + top-k over an index whose rows are split over the mesh's
    rows axis.  Every rank of the mesh calls it with the same queries and
    its own block of rows.

    Args:
      mesh: a mesh with the rows axis.
      query_emb: [B, D] L2-normalized queries, the same on every rank.
      index_emb: this rank's block [N/s, D] of the L2-normalized rows; may
        be None when `banks` carries the selection tensors.
      top_k: k.
      valid_mask: this rank's block [N/s] of the row filter (all rows when
        None).
      batch_axis: a mesh axis over which to split the query batch: each
        group along it selects and merges for its slice of the queries, and
        the slices are all-gathered back, so every rank still returns all B.
      banks: this rank's blocks [N/s, ...] of further tensors, handed to
        `local_select` and to the rescore (e.g. {"emb_int8": ...,
        "emb_scale": ..., "emb_f32": ...}).
      local_select: the selection over one block,
        `(q, banks_local, mask_local, top_k, fetch_k) -> (values, LOCAL
        indices)`, max(top_k, fetch_k) candidates a query, sorted, with
        (-1e30, -1) fillers allowed; by default a plain product
        (`ops/similarity.dots`) and a stable top-k over `banks["emb"]`.
      fetch_k: candidates kept at the merge (>= top_k enables the rescore's
        oversample; 0 means top_k).
      rescore_key: re-rank the merged candidates by exact f32 dots with
        `banks[rescore_key]`'s rows.  The rescore is distributed: each rank
        scores only the candidates it holds (zero elsewhere) and one
        all-reduce of the [B, fetch_k] scores, not of the [B, fetch_k, D]
        rows, crosses ranks.
      rescore_rows: instead of `rescore_key`, a callable
        `(banks_local, local_idx) -> [B, m, D]` rows (e.g. the int8 +
        residual reconstruction).

    Returns (values [B, k] f32, global indices [B, k] int32), the same on
    every rank; ties to the lowest global index.
    """
    banks = dict(banks or {})
    if index_emb is not None:
        banks.setdefault("emb", index_emb)
    rows_per_shard = next(iter(banks.values())).shape[0]
    shard_id = mesh.coords[ROWS_AXIS]
    group = mesh.groups[ROWS_AXIS]
    fk = max(top_k, fetch_k)
    do_rescore = rescore_rows is not None or rescore_key is not None
    if rescore_rows is None and rescore_key is not None:
        rescore_rows = lambda bl, ix: bl[rescore_key][ix]  # noqa: E731
    if valid_mask is None:
        valid_mask = torch.ones(rows_per_shard, dtype=torch.bool, device=query_emb.device)

    def default_select(q, banks_local, mask_local, k_out, m_out):
        emb_local = banks_local["emb"]
        scores = dots(q.to(emb_local.dtype), emb_local)
        scores = torch.where(mask_local[None, :], scores, float("-inf"))
        return stable_top_k(scores, min(max(k_out, m_out), scores.shape[1]))

    select = local_select or default_select

    b = query_emb.shape[0]
    lo, per = _batch_slice(mesh, batch_axis, b)
    q = query_emb[lo:lo + per]
    if q.shape[0] < per:  # the last slice of a ragged batch: zero queries
        q = torch.nn.functional.pad(q, (0, 0, 0, per - q.shape[0]))

    v_loc, i_loc = select(q, banks, valid_mask, top_k, fk)
    i_glob = torch.where(
        i_loc >= 0, i_loc.to(torch.int32) + shard_id * rows_per_shard, -1
    ).to(torch.int32)
    # The candidates cross ranks: [s, B, m] -> rank-major [B, s * m].
    v_all = _collective("all_gather", v_loc.to(torch.float32), group)
    i_all = _collective("all_gather", i_glob, group)
    v_cat = v_all.permute(1, 0, 2).reshape(per, -1)
    i_cat = i_all.permute(1, 0, 2).reshape(per, -1)
    keep = top_k if not do_rescore else min(fk, v_cat.shape[1])
    v_m, pos = stable_top_k(v_cat, keep)
    i_m = torch.gather(i_cat, 1, pos)
    if do_rescore:
        # Each rank scores the merged candidates it holds; one all-reduce
        # of the [B, m] scores assembles them: B*m*4 bytes, not B*m*D*4.
        local = i_m - shard_id * rows_per_shard
        valid = (i_m >= 0) & (v_m > -1e29)
        own = valid & (local >= 0) & (local < rows_per_shard)
        safe = local.clamp(0, rows_per_shard - 1).to(torch.int64)
        exact = torch.where(own, candidate_dots(q, rescore_rows(banks, safe)), 0.0)
        exact = _collective("all_reduce", exact, group)
        exact = torch.where(valid, exact, -1e30)
        v_m, sp = stable_top_k(exact, top_k)
        i_m = torch.gather(i_m, 1, sp)
    if batch_axis is not None:
        bgroup = mesh.groups[batch_axis]
        v_m = _collective("all_gather", v_m.contiguous(), bgroup).reshape(-1, v_m.shape[1])[:b]
        i_m = _collective("all_gather", i_m.contiguous(), bgroup).reshape(-1, i_m.shape[1])[:b]
    return v_m, i_m


def sharded_row_gather(
    mesh: Mesh, table: torch.Tensor, indices: torch.Tensor
) -> torch.Tensor:
    """Rows of a table split over the rows axis at global row ids (the same
    on every rank): each rank contributes the rows it holds, the others
    zero, and one all-reduce over the rows axis assembles them (a
    one-owner sum, so exact in any dtype).  `table` is this rank's block
    [N/s, ...]; `indices` [...] are global ids, and a negative id gives a
    zero row.  Returns [..., *table.shape[1:]] on every rank."""
    rows_per_shard = table.shape[0]
    local = indices.to(torch.int64) - mesh.coords[ROWS_AXIS] * rows_per_shard
    own = (local >= 0) & (local < rows_per_shard) & (indices >= 0)
    vals = table[local.clamp(0, rows_per_shard - 1)]
    own = own.reshape(own.shape + (1,) * (vals.ndim - own.ndim))
    vals = torch.where(own, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return _collective("all_reduce", vals, mesh.groups[ROWS_AXIS])


def pad_rows(array, multiple: int, pad_value=0):
    """Pad axis 0 to a multiple (for even sharding); returns (padded,
    n_orig)."""
    n = array.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return array, n
    pad_width = [(0, target - n)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width, constant_values=pad_value), n
