"""Structured graph queries — the text-to-Cypher capability over the CSR graph.

Counterpart of `hcrag_tpu/query/graph_query.py`.  The reference's v1 agent had an LLM generate raw Cypher and ran it against
Neo4j (`langgraphrag.py:136-189`, `generate_graph_query`/`run_graph_query`) —
a capability dropped in v2.  This module restores it safely: the LLM emits a
STRUCTURED query (a small pattern DSL instead of free-form Cypher), which a
host-side matcher executes against the CsrGraph.  Offline, a keyword
heuristic produces the same structure deterministically.

DSL semantics (one hop of a property-graph pattern):
  (label, key?, text_contains?) -[edge_type?]- (neighbor_label?)  LIMIT n
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.pipeline.llm import (
    LLMClient,
    _integer,
    _Model,
    _nullable,
    _optional_string,
)


@dataclasses.dataclass
class GraphQuery(_Model):
    """Structured one-hop graph pattern."""

    label: Optional[str] = None
    key: Optional[str] = None
    text_contains: Optional[str] = None
    edge_type: Optional[str] = None
    neighbor_label: Optional[str] = None
    limit: int = 10

    SCHEMA = {
        "description": "Structured one-hop graph pattern.",
        "properties": {
            "label": _nullable(
                "Label", "Node label filter: Product, Category, Document, Annotation"),
            "key": _nullable("Key", "Exact node key (product id or filename)"),
            "text_contains": _nullable(
                "Text Contains", "Substring that must appear in the node text"),
            "edge_type": _nullable("Edge Type", (
                "Relationship to follow: SAME_CATEGORY, SAME_MODEL, SIMILAR_PRICE,"
                " COMPATIBLE_PRODUCT, COMPLEMENTARY_PRODUCT, DESCRIBED_BY,"
                " ANNOTATION")),
            "neighbor_label": _nullable(
                "Neighbor Label", "Label filter applied to matched neighbors"),
            "limit": {"default": 10, "description": "Maximum matched nodes",
                      "title": "Limit", "type": "integer"},
        },
        "title": "GraphQuery",
        "type": "object",
    }
    FIELDS = {"label": _optional_string, "key": _optional_string,
              "text_contains": _optional_string, "edge_type": _optional_string,
              "neighbor_label": _optional_string, "limit": _integer}


_GEN_SYSTEM_PROMPT = """You translate natural-language questions about a product knowledge graph into a structured graph query.

The graph contains: Product nodes (bikes, frames, helmets, ... with price/color/category), Category nodes, Document nodes (PDF manuals and product sheets), Annotation nodes (figures/tables attached to documents).

Relationships: SAME_CATEGORY, SAME_MODEL, SIMILAR_PRICE, COMPATIBLE_PRODUCT, COMPLEMENTARY_PRODUCT (product-product), DESCRIBED_BY (product-document), ANNOTATION (annotation-document).

Produce the graph query that best answers the question."""


def generate_graph_query(
    question: str, client: Optional[LLMClient] = None
) -> GraphQuery:
    """LLM structured query generation with a deterministic keyword fallback
    (the reference's generate_graph_query, langgraphrag.py:136-178)."""
    client = client or LLMClient()
    if not client.offline:
        result = client.call(
            _GEN_SYSTEM_PROMPT,
            f"Question: {question}",
            GraphQuery,
            fallback=False,
        )
        if isinstance(result, GraphQuery):
            return result
    # Offline keyword heuristic.
    q = question.lower()
    gq = GraphQuery()
    if any(w in q for w in ("manual", "document", "pdf", "guide", "sheet")):
        gq.label = "Document"
    elif any(w in q for w in ("figure", "table", "annotation", "image")):
        gq.label = "Annotation"
    elif "categor" in q:
        gq.label = "Category"
    else:
        gq.label = "Product"
    if any(w in q for w in ("similar price", "same price", "price range")):
        gq.edge_type = "SIMILAR_PRICE"
    elif "same category" in q or "related" in q:
        gq.edge_type = "SAME_CATEGORY"
    elif "compatible" in q:
        gq.edge_type = "COMPATIBLE_PRODUCT"
    elif any(w in q for w in ("goes with", "complement", "accessor")):
        gq.edge_type = "COMPLEMENTARY_PRODUCT"
    elif any(w in q for w in ("described", "documentation for", "manual for")):
        gq.edge_type = "DESCRIBED_BY"
    # crude content filter: longest capitalized-ish token sequence
    for marker in ("about ", "for ", "of "):
        if marker in q:
            gq.text_contains = question[
                question.lower().index(marker) + len(marker):
            ].strip(" ?.")
            break
    return gq


def execute_graph_query(graph: CsrGraph, query: GraphQuery) -> List[Dict]:
    """Run the pattern against the CSR graph (run_graph_query analogue).

    Returns matched node dicts with their (optionally filtered) neighbors.
    """
    results: List[Dict] = []
    # Resolve against the graph's OWN vocabulary — a discovered-relation
    # property graph (core/property_graph.py) carries its vocab on the
    # CsrGraph; the AdventureWorks build defaults to EDGE_TYPES.
    type_names = graph.type_names
    etype_id = (
        type_names.index(query.edge_type)
        if query.edge_type in type_names
        else None
    )
    needle = (query.text_contains or "").lower()
    for node in range(graph.num_nodes):
        if len(results) >= max(query.limit, 1):
            break
        if query.label and graph.node_labels[node] != query.label:
            continue
        if query.key is not None and str(graph.node_keys[node]) != str(query.key):
            continue
        if needle and needle not in graph.node_texts[node].lower():
            continue
        entry: Dict = {
            "node_id": node,
            "label": graph.node_labels[node],
            "key": graph.node_keys[node],
            "text": graph.node_texts[node],
            "neighbors": [],
        }
        if etype_id is not None or query.neighbor_label:
            nbrs, types = graph.neighbors_of(node)
            for nb, t in zip(nbrs, types):
                if etype_id is not None and int(t) != etype_id:
                    continue
                if (
                    query.neighbor_label
                    and graph.node_labels[int(nb)] != query.neighbor_label
                ):
                    continue
                entry["neighbors"].append(
                    {
                        "node_id": int(nb),
                        "label": graph.node_labels[int(nb)],
                        "text": graph.node_texts[int(nb)],
                        "relationship": type_names[int(t)],
                    }
                )
        results.append(entry)
    return results


def answer_graph_question(
    graph: CsrGraph, question: str, client: Optional[LLMClient] = None
) -> Dict:
    """generate -> execute -> package (the v1 agent's graph-query stage)."""
    gq = generate_graph_query(question, client)
    matches = execute_graph_query(graph, gq)
    return {
        "question": question,
        "graph_query": gq.model_dump(),
        "matches": matches,
        "match_count": len(matches),
    }
