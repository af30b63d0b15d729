"""PropertyGraphStore — host-side store for LLM/heuristic-extracted graphs.

Counterpart of `hcrag_tpu/core/property_graph.py`, with the same JSON
layout (a store saved by either package loads in the other).  The JAX
package's module is the replacement for the reference's LlamaIndex property-graph path
(`graph_builder.py:453-513`: ``PropertyGraphIndex.from_documents`` over a
``SimplePropertyGraphStore``/``Neo4jPropertyGraphStore``).  The reference
delegates storage to LlamaIndex/Neo4j; here the store is a plain host-side
entity/triple table whose *device* form is the same `CsrGraph`/ELL layout the
AdventureWorks graph uses — so extracted graphs flow into the identical
expansion kernels and sharded layouts as the hand-built schema.

Design split (mirrors the build's overall host/device contract):
  * host side: entity dedup, label/property bookkeeping, triple upsert,
    JSON save/load (replaces `graph_builder.py:503-513`'s pickle).
  * device side: `to_csr()` lowers to CSR with a *discovered* edge-type
    vocabulary (capped so the int8 edge-type lane is never overflowed), plus
    node->embedding-row links for retrieval integration.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

#: int8 edge-type ids must stay in range; rarely-seen relation types beyond
#: the cap collapse into the catch-all so extraction never hard-fails on a
#: pathological vocabulary.
MAX_RELATION_TYPES = 120
CATCHALL_RELATION = "RELATED_TO"


@dataclasses.dataclass
class EntityNode:
    """A deduplicated graph entity (LlamaIndex ``EntityNode`` analogue)."""

    name: str
    label: str = "entity"
    properties: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Triple:
    """A (subject, predicate, object) path with optional entity types.

    The unit of extraction, as in LlamaIndex's kg extractors used at
    graph_builder.py:428-446.
    """

    subject: str
    predicate: str
    object: str
    subject_type: str = "entity"
    object_type: str = "entity"
    source_id: Optional[str] = None  # originating chunk/document id


def _norm_name(name: str) -> str:
    return " ".join(str(name).split()).strip()


def _norm_predicate(pred: str) -> str:
    out = "".join(c if c.isalnum() else "_" for c in str(pred).strip())
    out = "_".join(p for p in out.split("_") if p)
    return out.upper() or CATCHALL_RELATION


class PropertyGraphStore:
    """Entity + triple store with dedup-by-normalized-name semantics."""

    def __init__(self) -> None:
        self._nodes: Dict[str, EntityNode] = {}
        self._order: List[str] = []  # insertion order of node keys
        self._triples: List[Tuple[str, str, str]] = []  # (src_key, REL, dst_key)
        self._triple_seen: set = set()
        self._triple_sources: List[Optional[str]] = []

    # --- mutation -----------------------------------------------------------
    def upsert_node(
        self, name: str, label: str = "entity", properties: Optional[Dict] = None
    ) -> str:
        name = _norm_name(name)
        key = name.lower()
        if not key:
            raise ValueError("entity name must be non-empty")
        node = self._nodes.get(key)
        if node is None:
            self._nodes[key] = EntityNode(name=name, label=label, properties=dict(properties or {}))
            self._order.append(key)
        else:
            # First non-generic label wins; properties merge shallowly.
            if node.label == "entity" and label != "entity":
                node.label = label
            if properties:
                for k, v in properties.items():
                    node.properties.setdefault(k, v)
        return key

    def upsert_triple(self, triple: Triple) -> bool:
        """Insert a triple (and its endpoint entities).  Returns False for
        duplicates/self-loops — the dedup the reference gets from
        LlamaIndex's store upserts."""
        subj = _norm_name(triple.subject)
        obj = _norm_name(triple.object)
        if not subj or not obj or subj.lower() == obj.lower():
            return False
        pred = _norm_predicate(triple.predicate)
        s_key = self.upsert_node(subj, triple.subject_type)
        o_key = self.upsert_node(obj, triple.object_type)
        sig = (s_key, pred, o_key)
        if sig in self._triple_seen:
            return False
        self._triple_seen.add(sig)
        self._triples.append(sig)
        self._triple_sources.append(triple.source_id)
        return True

    # --- inspection ---------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self._order)

    @property
    def num_triples(self) -> int:
        return len(self._triples)

    def get_node(self, name: str) -> Optional[EntityNode]:
        return self._nodes.get(_norm_name(name).lower())

    def nodes(self) -> List[EntityNode]:
        return [self._nodes[k] for k in self._order]

    def triples(self) -> List[Tuple[str, str, str]]:
        """(subject_name, PREDICATE, object_name) in insertion order."""
        return [
            (self._nodes[s].name, p, self._nodes[o].name)
            for s, p, o in self._triples
        ]

    def relation_types(self) -> List[str]:
        """Distinct predicates in first-seen order."""
        seen: Dict[str, None] = {}
        for _, p, _ in self._triples:
            seen.setdefault(p, None)
        return list(seen)

    def statistics(self) -> Dict:
        """Node/relationship counts — the property-graph analogue of the
        reference's graph statistics surface (knowledge_graph.py:423-447)."""
        by_label: Dict[str, int] = {}
        for node in self.nodes():
            by_label[node.label] = by_label.get(node.label, 0) + 1
        by_rel: Dict[str, int] = {}
        for _, p, _ in self._triples:
            by_rel[p] = by_rel.get(p, 0) + 1
        return {
            "total_nodes": self.num_nodes,
            "total_relationships": self.num_triples,
            "nodes_by_label": by_label,
            "relationships_by_type": by_rel,
        }

    # --- device lowering ----------------------------------------------------
    def to_csr(self, node_to_row: Optional[np.ndarray] = None):
        """Lower to the on-device `CsrGraph` layout.

        The discovered relation vocabulary becomes the edge-type table
        (capped at MAX_RELATION_TYPES by frequency; the tail collapses into
        RELATED_TO).  Extracted graphs thereby run through the exact
        expansion kernels / ELL sharding the AdventureWorks graph uses.
        """
        from hcrag_tpu_torch.core.graph import CsrGraph

        key_to_id = {k: i for i, k in enumerate(self._order)}
        freq: Dict[str, int] = {}
        for _, p, _ in self._triples:
            freq[p] = freq.get(p, 0) + 1
        ranked = sorted(freq, key=lambda p: (-freq[p], p))
        kept = ranked[:MAX_RELATION_TYPES]
        type_names = kept + (
            [CATCHALL_RELATION]
            if len(ranked) > MAX_RELATION_TYPES and CATCHALL_RELATION not in kept
            else []
        )
        if not type_names:
            # Zero triples: still emit the catch-all so the lowered graph
            # carries a non-empty DISCOVERED vocabulary (an empty list would
            # previously read as falsy and fall back to the AdventureWorks
            # EDGE_TYPES whitelist path in CsrGraph.from_edges).
            type_names = [CATCHALL_RELATION]
        type_id = {p: i for i, p in enumerate(type_names)}
        catch = type_id.get(CATCHALL_RELATION)

        src = np.array([key_to_id[s] for s, _, _ in self._triples], dtype=np.int64)
        dst = np.array([key_to_id[o] for _, _, o in self._triples], dtype=np.int64)
        etype = np.array(
            [type_id.get(p, catch) for _, p, _ in self._triples], dtype=np.int8
        )
        nodes = self.nodes()
        return CsrGraph.from_edges(
            self.num_nodes,
            src,
            dst,
            etype,
            node_labels=[n.label for n in nodes],
            node_keys=[n.name for n in nodes],
            node_texts=[self.node_text(n) for n in nodes],
            node_to_row=node_to_row,
            edge_type_names=type_names,
        ), type_names

    @staticmethod
    def node_text(node: EntityNode) -> str:
        """Display/embedding text for an entity — name plus salient
        properties, in the style the agent path assembles node text
        (neo4j_rag_langgraph.py:352-399)."""
        parts = [node.name]
        for k, v in list(node.properties.items())[:4]:
            parts.append(f"{k}: {v}")
        return " | ".join(parts)

    # --- persistence (replaces graph_builder.py:503-513 pickle) ------------
    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "nodes": [
                {"name": n.name, "label": n.label, "properties": n.properties}
                for n in self.nodes()
            ],
            "triples": [
                {
                    "subject": self._nodes[s].name,
                    "predicate": p,
                    "object": self._nodes[o].name,
                    "source_id": src_id,
                }
                for (s, p, o), src_id in zip(self._triples, self._triple_sources)
            ],
        }
        path.write_text(json.dumps(payload, indent=1))

    @classmethod
    def load(cls, path) -> "PropertyGraphStore":
        payload = json.loads(Path(path).read_text())
        store = cls()
        for n in payload["nodes"]:
            store.upsert_node(n["name"], n["label"], n.get("properties"))
        for t in payload["triples"]:
            store.upsert_triple(
                Triple(
                    subject=t["subject"],
                    predicate=t["predicate"],
                    object=t["object"],
                    source_id=t.get("source_id"),
                )
            )
        return store
