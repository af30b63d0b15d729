"""ShardedQueryEngine — the engine over index rows split across ranks.

Counterpart of `hcrag_tpu/parallel/sharded_engine.py`, one process per
rank.  Layout on each rank:

  * the embedding banks (`emb`, `emb_int8` + `emb_scale`, `emb_f32`,
    `emb_res8` + `emb_res_scale`): this rank's block of rows, rows
    [r * n/s, (r + 1) * n/s) of the bank padded to s x the engine's row
    multiple, so every block is whole tiles (or supertiles);
  * the per-row tables (type ids, entity bits and counts, graph ids) and a
    row-validity mask: whole on every rank, padded to the bank's rows;
  * the graph tables: whole on every rank, or split over the rows axis
    with `shard_graph=True`;
  * queries: the same on every rank; each rank selects over its block with
    the engine's own kernels (`QueryEngine._local_select`), the candidates
    are merged across ranks (`sharded_ops.sharded_top_k`), and the exact
    rescore is distributed.

The call rule is SPMD: every rank constructs the engine from the same
`DenseIndex` and calls `query_batch` (and every other method) with the same
arguments, in the same order; every rank then returns the same, whole
result.  No rank broadcasts its arguments to the others: a rank trusts its
own, as each rank of a DDP job does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.ops.expand import dedup_and_cap
from hcrag_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    ROWS_AXIS,
    make_row_mesh,
)
from hcrag_tpu_torch.parallel.sharded_ops import sharded_row_gather, sharded_top_k
from hcrag_tpu_torch.query.engine import QueryEngine


#: Engine attributes of the row-split banks, and of the graph tables that
#: `shard_graph` splits too.
_SPLIT_BANKS = ("d_emb", "d_emb_int8", "d_emb_scale", "d_emb_f32", "d_emb_res8",
                "d_emb_res_scale")
_GRAPH_TABLES = ("d_neighbors", "d_neighbors_hop2", "d_g_type_ids", "d_g_row")


def _pad_to(t: torch.Tensor, n: int, value) -> torch.Tensor:
    """`t` padded along axis 0 to n rows of `value`."""
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_full((n - t.shape[0], *t.shape[1:]), value)])


class ShardedQueryEngine(QueryEngine):
    """`QueryEngine` over index rows split across the ranks of a mesh (one
    process per rank; SPMD calls, see the module's docstring)."""

    def __init__(
        self,
        index: DenseIndex,
        graph: Optional[CsrGraph] = None,
        *,
        mesh=None,
        embedder=None,
        ell_max_degree: Optional[int] = None,
        shard_queries: bool = False,
        shard_graph: bool = False,
        **kernel_opts,
    ):
        """`kernel_opts` go to `QueryEngine` (`quantize_int8`, `int8_only`,
        `int8_residual`, `int8_rescore`, `int8_f32_rescore`,
        `exact_rescore`, `pallas_super`, ...): each rank runs the same
        kernels over its block.  The device is the mesh's (`make_row_mesh()`
        by default: CUDA, this rank's card).

        `shard_queries=True` on a (batch, rows) mesh splits the query batch
        over the batch axis: each batch group selects for its slice, and
        every rank still returns the whole batch.  `shard_graph=True` splits
        the graph tables (neighbor ELL, per-node type ids, node -> row
        links) over the rows axis instead of holding them whole; the
        expansion then gathers each hop across ranks.

        As in the JAX engine, an int8 engine keeps no f32 rows: with
        `int8_f32_rescore` its rescore reads the bf16 rows all the same,
        while `int8_f32_rescore` stays set (and `resolved_kernel_config`
        reports an f32 rescore bank)."""
        self.shard_graph = bool(shard_graph)
        self.mesh = mesh if mesh is not None else make_row_mesh()
        self.batch_axis = (
            BATCH_AXIS if shard_queries and BATCH_AXIS in self.mesh.shape else None
        )
        self._n_shards = self.mesh.shape[ROWS_AXIS]
        self._shard = self.mesh.coords[ROWS_AXIS]
        super().__init__(
            index, graph, embedder=embedder, ell_max_degree=ell_max_degree,
            device=self.mesh.device, **kernel_opts,
        )
        if self.d_neighbors is not None and self.shard_graph:
            # Pad the node axis to the shard count (pad nodes have -1
            # neighbors and -1 row links, so they are inert) and keep this
            # rank's block of every graph table.
            def block(t, value):
                t = _pad_to(t, -(-t.shape[0] // self._n_shards) * self._n_shards, value)
                per = t.shape[0] // self._n_shards
                return t[self._shard * per:(self._shard + 1) * per].clone()

            self._n_graph_padded = -(-self.d_neighbors.shape[0] // self._n_shards) * self._n_shards
            self.d_neighbors = block(self.d_neighbors, -1)
            self.d_neighbors_hop2 = block(self.d_neighbors_hop2, -1)
            self.d_g_type_ids = block(self.d_g_type_ids, 0)
            self.d_g_row = block(self.d_g_row, -1)

    @property
    def split_attrs(self) -> frozenset:
        """The attributes of the device tensors held as blocks of rows, one
        per coordinate of the rows axis: the embedding banks, and the graph
        tables with `shard_graph`.  Every other device tensor is whole on
        each rank."""
        return frozenset(_SPLIT_BANKS + (_GRAPH_TABLES if self.shard_graph else ()))

    def _row_pad_multiple(self) -> int:
        # Shards x the tile (or supertile) multiple: every rank's block is
        # whole tiles, so its kernels never pad.
        return self._n_shards * super()._row_pad_multiple()

    def _init_emb_banks(self, emb_host: np.ndarray, n_bank: int) -> None:
        """This rank's block of every bank, placed (and, for the int8 banks,
        quantized on the device) from its own rows only.  As the JAX engine
        does, an int8 engine builds no f32 rows (see `__init__`)."""
        per = n_bank // self._n_shards
        local = emb_host[self._shard * per:(self._shard + 1) * per]
        f32_rescore = self.int8_f32_rescore
        self.int8_f32_rescore = False
        super()._init_emb_banks(local, per)
        self.int8_f32_rescore = f32_rescore

    def _upload_index(self) -> None:
        """The base upload, then the per-row tables padded to the bank's
        rows (pad rows: type 0, no entities, no graph node) and the
        row-validity mask: the selection's indices range over the padded
        rows, and a filler index (-1) reads the last, padded row."""
        super()._upload_index()
        n = self._n_bank
        self.d_type_ids = _pad_to(self.d_type_ids, n, 0)
        self.d_bits = _pad_to(self.d_bits, n, 0)
        self.d_counts = _pad_to(self.d_counts, n, 0)
        self.d_graph_ids = _pad_to(self.d_graph_ids, n, -1)
        self._row_valid = torch.arange(n, device=self.device) < self._n_rows

    def _bank(self):
        bank = super()._bank()
        bank["row_valid"] = self._row_valid
        return bank

    def _gather_graph(self, table, idx):
        if not self.shard_graph:
            return table[idx]
        return sharded_row_gather(self.mesh, table, idx)

    def _expand_impl(self, bank, seeds, depth: int, max_expanded: int):
        """With the graph split over ranks: each hop is one batched gather
        across ranks, then `dedup_and_cap` over all hops' candidates.  The
        same nodes in the same order as the unsplit expansion: its frontier
        dedup only masks repeats (it never reorders), and a repeated node's
        second-hop block brings the same ids at later positions, so the
        first-occurrence order, and so the cap, are unchanged."""
        if not self.shard_graph:
            return super()._expand_impl(bank, seeds, depth, max_expanded)
        b = seeds.shape[0]
        cand = seeds
        hops = []
        for hop in range(depth):
            table = bank["neighbors"] if hop == 0 else bank["neighbors_hop2"]
            safe = torch.where(cand >= 0, cand, 0)
            nb = self._gather_graph(table, safe)  # [B, F, M]
            nb = torch.where((cand >= 0)[..., None], nb, -1)
            cand = nb.reshape(b, -1)
            hops.append(cand)
        return dedup_and_cap(torch.cat(hops, dim=1), self._n_graph_padded, max_expanded)

    def _gather_emb_rows(self, indices, bank):
        """Rows at global row ids from this rank's blocks, assembled across
        ranks (`sharded_row_gather`); int8-only residency dequantizes the
        gathered rows (+ the residual level)."""
        gather = lambda key: sharded_row_gather(self.mesh, bank[key], indices)  # noqa: E731
        if "emb" in bank:
            return gather("emb")
        rows = gather("emb_int8").to(torch.float32) * gather("emb_scale")[..., None]
        if "emb_res8" in bank:
            rows = rows + (
                gather("emb_res8").to(torch.float32) * gather("emb_res_scale")[..., None]
            )
        return rows

    def _topk_impl(self, q_emb, type_mask, top_k: int, bank):
        # The filter arrives over the unpadded rows; pad it, AND the row
        # validity, and keep this rank's block.
        mask = _pad_to(type_mask, self._n_bank, False) & bank["row_valid"]
        per = self._n_bank // self._n_shards
        mask = mask[self._shard * per:(self._shard + 1) * per]
        banks = {
            key: bank[key]
            for key in ("emb", "emb_int8", "emb_scale", "emb_f32", "emb_res8", "emb_res_scale")
            if key in bank
        }
        m = self._rescore_m()
        rescore_rows = None
        if m:
            if not self.quantize_int8:
                rescore_rows = lambda bl, ix: bl["emb_f32"][ix]  # noqa: E731
            elif self.int8_residual:
                def rescore_rows(bl, ix):
                    return (
                        bl["emb_int8"][ix].to(torch.float32) * bl["emb_scale"][ix][..., None]
                        + bl["emb_res8"][ix].to(torch.float32)
                        * bl["emb_res_scale"][ix][..., None]
                    )
            else:
                rescore_rows = lambda bl, ix: bl["emb"][ix]  # noqa: E731
        return sharded_top_k(
            self.mesh, q_emb, None, top_k, mask,
            batch_axis=self.batch_axis,
            banks=banks,
            local_select=self._local_select,
            fetch_k=max(top_k, m) if m else 0,
            rescore_rows=rescore_rows,
        )
