"""GraphRelevanceScorer — retrieval + expansion + relevance glue.

Counterpart of `hcrag_tpu/pipeline/integration.py` (the reference's
`graph_relevance_integration.py:24-459`): ties the dense engine, subgraph
expansion and the isRelevant scorer together without the agent loop,
including the scorer-comparison analytics.  Node-type mapping, keyword
entities (<=5), keyword intent, and the "connected nodes get similarity 0.0"
convention are kept.  Scoring runs on the engine's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hcrag_tpu_torch.core.types import NodeInput, QueryInput, ScorerType
from hcrag_tpu_torch.ingest.entities import (
    extract_entities_from_content,
    infer_query_intent,
    metadata_node_type,
)
from hcrag_tpu_torch.ops.expand import expansion_edges_host
from hcrag_tpu_torch.pipeline.isrelevant import isRelevant
from hcrag_tpu_torch.pipeline.llm import LLMClient
from hcrag_tpu_torch.query.engine import QueryEngine


class GraphRelevanceScorer:
    """Scores every graph node retrieved for a query with each requested
    scorer strategy (graph_relevance_integration.py:24-305)."""

    def __init__(self, engine: QueryEngine, client: Optional[LLMClient] = None):
        self.engine = engine
        self.client = client or LLMClient()

    # -- conversions (graph_relevance_integration.py:38-110) ---------------
    def convert_rag_result_to_node_input(
        self, result: Dict[str, Any], is_connected: bool = False
    ) -> NodeInput:
        content = result.get("content", "")
        metadata = result.get("metadata", {})
        similarity_score = result.get("similarity_score", 0.0)
        node_type = metadata_node_type(metadata)
        entities = extract_entities_from_content(content)
        graph_relations = {
            "similarity_score": similarity_score,
            "is_connected": is_connected,
            "metadata": metadata,
        }
        # Use the cached row embedding instead of re-encoding at query time
        # (the reference re-encodes every node, :77 — a flagged hot spot).
        row = self.engine.index.row_of_metadata(metadata)
        if row >= 0:
            emb = np.asarray(self.engine.index.emb[row], np.float32)
        else:
            emb = np.asarray(self.engine.embedder.encode([content])[0])
        return NodeInput(
            text=content,
            embeddings=emb,
            graph_relations=graph_relations,
            node_type=node_type,
            entities=entities,
        )

    def create_query_input(self, query: str) -> QueryInput:
        return QueryInput(
            text=query,
            embeddings=np.asarray(self.engine.embedder.encode([query])[0]),
            entities=extract_entities_from_content(query),
            intent=infer_query_intent(query),
        )

    # -- node collection (graph_relevance_integration.py:149-212) ----------
    def get_graph_nodes_for_query(
        self,
        query: str,
        top_k: int = 10,
        similarity_threshold: float = 0.25,
        expand_subgraph: bool = True,
    ) -> Tuple[List[NodeInput], Dict]:
        query_results = self.engine.process_query(
            query, top_k=top_k, similarity_threshold=similarity_threshold
        )
        nodes = [
            self.convert_rag_result_to_node_input(r, is_connected=False)
            for r in query_results["results"]
        ]
        if expand_subgraph and query_results["results"] and self.engine.graph:
            graph = self.engine.graph
            index = self.engine.index
            seeds = []
            for r in query_results["results"]:
                row = index.row_of_metadata(r["metadata"])
                if row < 0:
                    continue
                gid = int(index.graph_ids[row])
                if gid >= 0:
                    seeds.append(gid)
            seen = set()
            for _, dst, _ in expansion_edges_host(
                graph, seeds, max_nodes=top_k + 5
            ):
                if dst in seen:
                    continue
                seen.add(dst)
                connected_result = {
                    "content": graph.node_texts[dst],
                    "metadata": {"graph_node": dst,
                                 "label": graph.node_labels[dst]},
                    "similarity_score": 0.0,  # connected nodes: no similarity
                }
                nodes.append(
                    self.convert_rag_result_to_node_input(
                        connected_result, is_connected=True
                    )
                )
        return nodes, query_results

    # -- scoring (graph_relevance_integration.py:214-305) ------------------
    def score_query_against_graph(
        self,
        query: str,
        top_k: int = 10,
        similarity_threshold: float = 0.25,
        expand_subgraph: bool = True,
        scorer_types: Optional[List[ScorerType]] = None,
    ) -> Dict[str, Any]:
        if scorer_types is None:
            scorer_types = [
                ScorerType.COMPOSITE, ScorerType.PARALLEL, ScorerType.ROUTER,
            ]
        query_input = self.create_query_input(query)
        nodes, query_metadata = self.get_graph_nodes_for_query(
            query, top_k, similarity_threshold, expand_subgraph
        )
        if not nodes:
            return {
                "query": query,
                "query_input": query_input,
                "nodes_found": 0,
                "results": {},
                "error": "No nodes found for scoring",
            }
        results: Dict[str, List[Dict]] = {}
        for scorer_type in scorer_types:
            scored_nodes = []
            for i, node in enumerate(nodes):
                relevance_score = isRelevant(
                    query_input, node, scorer_type, client=self.client,
                    device=self.engine.device,
                )
                scored_nodes.append(
                    {
                        "node_index": i,
                        "relevance_score": relevance_score,
                        "node_type": node.node_type,
                        "is_connected": node.graph_relations.get(
                            "is_connected", False
                        ),
                        "similarity_score": node.graph_relations.get(
                            "similarity_score", 0.0
                        ),
                        "content_preview": (
                            node.text[:100] + "..."
                            if len(node.text) > 100
                            else node.text
                        ),
                        "entities": node.entities,
                        "node_data": node,
                    }
                )
            scored_nodes.sort(key=lambda x: x["relevance_score"], reverse=True)
            results[scorer_type.value] = scored_nodes
        return {
            "query": query,
            "query_input": query_input,
            "nodes_found": len(nodes),
            "query_metadata": query_metadata,
            "results": results,
        }

    # -- analytics (graph_relevance_integration.py:307-349) ----------------
    def compare_scorer_performance(self, query: str, top_k: int = 10) -> Dict:
        out = self.score_query_against_graph(
            query, top_k=top_k,
            scorer_types=list(ScorerType),
        )
        comparison: Dict[str, Any] = {"query": query, "scorers": {}}
        for scorer_name, scored in out.get("results", {}).items():
            if not scored:
                continue
            scores = [s["relevance_score"] for s in scored]
            comparison["scorers"][scorer_name] = {
                "top_score": max(scores),
                "mean_score": float(np.mean(scores)),
                "std_score": float(np.std(scores)),
                "top_node_type": scored[0]["node_type"],
                "top_content": scored[0]["content_preview"],
            }
        return comparison
