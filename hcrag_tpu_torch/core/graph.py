"""CsrGraph — the property graph as host arrays.

Counterpart of `hcrag_tpu/core/graph.py` (the part the batched query step
needs: `CsrGraph.from_edges`, `CsrGraph.to_ell`, `CsrGraph.neighbors_of`
and `EllAdjacency`).  The
graph is built and lowered on the host with numpy; the engine uploads the
padded ELL neighbor tables to the device.

  * ``row_ptr``  [G+1] int32 — CSR offsets over symmetrized edges
  * ``col_idx``  [E]   int32 — neighbor node ids
  * ``edge_type``[E]   int8  — EDGE_TYPES id per edge
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hcrag_tpu_torch.core.types import EDGE_TYPES


@dataclasses.dataclass
class EllAdjacency:
    """Padded neighbor table for static-shape expansion."""

    neighbors: np.ndarray  # [G, max_deg] int32, -1 padding
    etypes: np.ndarray  # [G, max_deg] int8, -1 padding
    degrees: np.ndarray  # [G] int32 (true degree, may exceed max_deg)


@dataclasses.dataclass
class CsrGraph:
    row_ptr: np.ndarray  # [G+1] int32
    col_idx: np.ndarray  # [E] int32
    edge_type: np.ndarray  # [E] int8
    node_labels: List[str]  # label per node ("Product", "Document", ...)
    node_keys: List  # identity key (product_id, filename, ...)
    node_texts: List[str]  # display/scoring text per node
    node_to_row: np.ndarray  # [G] int32 embedding row, -1 if none
    #: Directed edge counts by type as created by the build rules, before
    #: symmetrization.
    directed_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: Edge-type vocabulary `edge_type` ids index into.  None means the
    #: fixed AdventureWorks EDGE_TYPES.
    edge_type_vocab: Optional[List[str]] = None

    @property
    def type_names(self) -> List[str]:
        return self.edge_type_vocab if self.edge_type_vocab is not None else EDGE_TYPES

    @property
    def num_nodes(self) -> int:
        return len(self.node_labels)

    def neighbors_of(self, node: int) -> Tuple[np.ndarray, np.ndarray]:
        """(neighbor ids, edge types) of `node`'s edges in creation order."""
        sl = slice(self.row_ptr[node], self.row_ptr[node + 1])
        return self.col_idx[sl], self.edge_type[sl]

    @classmethod
    def from_edges(
        cls,
        num_nodes: int,
        src: np.ndarray,
        dst: np.ndarray,
        etype: np.ndarray,
        *,
        node_labels: Sequence[str],
        node_keys: Sequence,
        node_texts: Sequence[str],
        node_to_row: Optional[np.ndarray] = None,
        symmetrize: bool = True,
        edge_type_names: Optional[Sequence[str]] = None,
    ) -> "CsrGraph":
        """Build CSR from a directed edge list.

        With ``symmetrize=True`` each directed edge also appears reversed
        (undirected traversal), and duplicate (src, dst, type) triples are
        dropped keeping the first.  A node's edges keep their creation order,
        which fixes the expansion order.
        """
        type_names = (
            list(edge_type_names) if edge_type_names is not None else EDGE_TYPES
        )
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        etype = np.asarray(etype, dtype=np.int8)
        type_hist = np.bincount(etype.astype(np.int64), minlength=len(type_names))
        directed_counts: Dict[str, int] = {
            type_names[i]: int(c) for i, c in enumerate(type_hist) if c > 0
        }
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            etype = np.concatenate([etype, etype])
            key = (src * num_nodes + dst) * len(type_names) + etype
            _, first = np.unique(key, return_index=True)
            first.sort()
            src, dst, etype = src[first], dst[first], etype[first]
        order = np.argsort(src, kind="stable")
        src, dst, etype = src[order], dst[order], etype[order]
        counts = np.bincount(src, minlength=num_nodes)
        row_ptr = np.zeros(num_nodes + 1, dtype=np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        if node_to_row is None:
            node_to_row = np.full(num_nodes, -1, dtype=np.int32)
        return cls(
            row_ptr=row_ptr,
            col_idx=dst.astype(np.int32),
            edge_type=etype,
            node_labels=list(node_labels),
            node_keys=list(node_keys),
            node_texts=list(node_texts),
            node_to_row=np.asarray(node_to_row, dtype=np.int32),
            directed_counts=directed_counts,
            edge_type_vocab=(
                list(edge_type_names) if edge_type_names is not None else None
            ),
        )

    def to_ell(
        self,
        edge_type_whitelist: Optional[Sequence[str]] = None,
        max_degree: Optional[int] = None,
    ) -> EllAdjacency:
        """Lower (optionally edge-type-filtered) adjacency to padded ELL.

        ``max_degree`` caps the per-node neighbor count (first-created edges
        win); None sizes the table to the largest filtered degree.  Whitelist
        names absent from this graph's vocabulary are skipped.
        """
        g = self.num_nodes
        if edge_type_whitelist is not None:
            names = self.type_names
            allowed = np.zeros(len(names), dtype=bool)
            for name in edge_type_whitelist:
                if name in names:
                    allowed[names.index(name)] = True
            keep = allowed[self.edge_type]
        else:
            keep = np.ones_like(self.edge_type, dtype=bool)

        # Edges are CSR-sorted by source, so the kept subset stays sorted;
        # an edge's slot is its kept-rank minus its node's first kept-rank.
        edge_src = np.repeat(
            np.arange(g, dtype=np.int64),
            np.diff(self.row_ptr).astype(np.int64),
        )
        kept_src = edge_src[keep]
        kept_dst = self.col_idx[keep].astype(np.int32)
        kept_type = self.edge_type[keep]
        degrees_all = np.bincount(kept_src, minlength=g).astype(np.int32)
        node_start = np.zeros(g, dtype=np.int64)
        np.cumsum(degrees_all[:-1], out=node_start[1:])
        slot = np.arange(kept_src.shape[0], dtype=np.int64) - node_start[kept_src]

        md = (
            int(max_degree)
            if max_degree is not None
            else int(degrees_all.max(initial=0))
        )
        md = max(md, 1)
        sel = slot < md
        neighbors = np.full((g, md), -1, dtype=np.int32)
        etypes = np.full((g, md), -1, dtype=np.int8)
        neighbors[kept_src[sel], slot[sel]] = kept_dst[sel]
        etypes[kept_src[sel], slot[sel]] = kept_type[sel]
        return EllAdjacency(neighbors=neighbors, etypes=etypes, degrees=degrees_all)
