"""EnhancedRAG — the retrieve -> rank -> optimize -> generate pipeline.

Counterpart of `hcrag_tpu/pipeline/enhanced.py`: the reference's
`EnhancedKnowledgeGraphRAG` (enhanced_rag_system.py:41-358) over the query
engine.  Its constants: candidate over-fetch top_k*2 at 0.7x threshold,
combined = 0.7*relevance + 0.3*similarity, greedy token budgeting at ~4
chars/token with a 500-token reserve, intent-specialized system prompts,
max_tokens 500 / temperature 0.7.  Retrieval is `process_query` on the
engine, and the relevance scoring runs on the engine's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from hcrag_tpu_torch import config as cfg
from hcrag_tpu_torch.core.types import (
    NodeInput,
    QueryInput,
    QueryIntent,
    ScorerType,
)
from hcrag_tpu_torch.ingest.entities import (
    extract_entities_simple,
    infer_query_intent_docfirst,
    metadata_node_type,
)
from hcrag_tpu_torch.pipeline.isrelevant import batch_isRelevant
from hcrag_tpu_torch.pipeline.llm import LLMClient
from hcrag_tpu_torch.query.engine import QueryEngine


@dataclasses.dataclass
class RAGResponse:
    """Structured response (enhanced_rag_system.py:30-38)."""

    query: str
    answer: str
    context_used: List[Dict[str, Any]]
    relevance_scores: List[float]
    metadata: Dict[str, Any]
    processing_time: float


_SYSTEM_PROMPTS = {
    QueryIntent.PRODUCT_SEARCH: (
        "You are a helpful product search assistant. Use the provided product "
        "information to answer the user's query about finding products."
    ),
    QueryIntent.DOCUMENT_REQUEST: (
        "You are a documentation assistant. Use the provided documents and "
        "manuals to help the user find the information they need."
    ),
    QueryIntent.TECHNICAL_SUPPORT: (
        "You are a technical support specialist. Use the provided technical "
        "information to help troubleshoot and solve the user's problem."
    ),
    QueryIntent.COMPARISON_REQUEST: (
        "You are a product comparison specialist. Use the provided "
        "information to help compare different products or options."
    ),
    QueryIntent.SPECIFICATION_INQUIRY: (
        "You are a technical specifications expert. Use the provided "
        "technical details to answer the user's specification questions."
    ),
}


class EnhancedRAG:
    """Complete RAG pipeline over a QueryEngine."""

    def __init__(
        self,
        engine: QueryEngine,
        *,
        client: Optional[LLMClient] = None,
        max_context_tokens: int = cfg.MAX_CONTEXT_TOKENS,
    ):
        self.engine = engine
        self.client = client or LLMClient()
        self.max_context_tokens = max_context_tokens

    @staticmethod
    def _estimate_tokens(text: str) -> int:
        """~4 chars/token (enhanced_rag_system.py:83-85)."""
        return len(text) // cfg.CHARS_PER_TOKEN

    def _node_input_from_result(self, result: Dict) -> NodeInput:
        """RAG result -> NodeInput (enhanced_rag_system.py:166-197), with the
        row's cached embedding instead of a re-encode."""
        metadata = result["metadata"]
        node_type = metadata_node_type(metadata)
        if node_type == "unknown":
            node_type = "specification"  # enhanced variant default (:183)
        row = self.engine.index.row_of_metadata(metadata)
        if row >= 0:
            emb = np.asarray(self.engine.index.emb[row], np.float32)
        else:
            emb = np.asarray(self.engine.embedder.encode([result["content"]])[0])
        return NodeInput(
            text=result["content"],
            embeddings=emb,
            graph_relations={"metadata": metadata},
            node_type=node_type,
            entities=extract_entities_simple(result["content"]),
        )

    def retrieve_and_rank(
        self,
        query: str,
        top_k: int = 20,
        similarity_threshold: float = 0.25,
        scorer_type: ScorerType = ScorerType.COMPOSITE,
    ) -> Tuple[List[Dict], Optional[QueryInput]]:
        """Over-fetch, score with isRelevant, blend 0.7/0.3, cut to top_k
        (enhanced_rag_system.py:110-164)."""
        rag_results = self.engine.process_query(
            query,
            top_k=top_k * 2,
            similarity_threshold=similarity_threshold * 0.7,
        )
        if not rag_results["results"]:
            return [], None
        query_input = QueryInput(
            text=query,
            embeddings=rag_results["query_embedding"],
            entities=extract_entities_simple(query),
            intent=infer_query_intent_docfirst(query),
        )
        node_inputs = [
            self._node_input_from_result(r) for r in rag_results["results"]
        ]
        relevance = batch_isRelevant(
            query_input, node_inputs, scorer_type, client=self.client,
            device=self.engine.device,
        )
        scored = []
        for result, node_input, rel in zip(
            rag_results["results"], node_inputs, relevance
        ):
            combined = (
                rel * cfg.COMBINED_RELEVANCE_WEIGHT
                + result["similarity_score"] * cfg.COMBINED_SIMILARITY_WEIGHT
            )
            scored.append(
                {
                    "content": result["content"],
                    "metadata": result["metadata"],
                    "similarity_score": result["similarity_score"],
                    "relevance_score": rel,
                    "combined_score": combined,
                    "node_input": node_input,
                }
            )
        scored.sort(key=lambda x: x["combined_score"], reverse=True)
        return scored[:top_k], query_input

    def optimize_context(
        self, scored_nodes: List[Dict], query_input: QueryInput
    ) -> List[Dict]:
        """Greedy token-budget selection (enhanced_rag_system.py:199-223)."""
        selected: List[Dict] = []
        total = 0
        available = self.max_context_tokens - cfg.CONTEXT_TOKEN_RESERVE
        for node in scored_nodes:
            tokens = self._estimate_tokens(node["content"])
            if total + tokens <= available:
                selected.append(node)
                total += tokens
            else:
                break
        return selected

    def generate_response(
        self, query: str, context_nodes: List[Dict], query_input: QueryInput
    ) -> str:
        """LLM generation with intent prompts (enhanced_rag_system.py:225-278)."""
        context_parts = [
            f"[Source {i}] (Relevance: {node['combined_score']:.2f})\n"
            f"{node['content']}\n"
            for i, node in enumerate(context_nodes, 1)
        ]
        context_text = "\n".join(context_parts)
        system_prompt = _SYSTEM_PROMPTS.get(
            query_input.intent, _SYSTEM_PROMPTS[QueryIntent.PRODUCT_SEARCH]
        )
        full_prompt = (
            "Based on the following information, please answer the user's "
            "question.\n\nCONTEXT INFORMATION:\n"
            f"{context_text}\n\nUSER QUESTION: {query}\n\n"
            "Please provide a helpful, accurate response based on the context "
            "provided. If the context doesn't contain enough information to "
            "fully answer the question, please say so and provide what "
            "information is available."
        )

        def offline_fallback():
            # Mirrors the reference's error-path answer shape
            # (enhanced_rag_system.py:278).
            if context_nodes:
                return (
                    f"I found {len(context_nodes)} relevant pieces of "
                    "information, but encountered an error generating the "
                    "response. The most relevant information relates to: "
                    f"{context_nodes[0]['content'][:200]}..."
                )
            return "No relevant information found."

        return self.client.call(
            system_prompt,
            full_prompt,
            max_tokens=500,
            temperature=0.7,
            fallback=offline_fallback,
        )

    def query(
        self,
        query: str,
        top_k: int = 10,
        similarity_threshold: float = 0.25,
        scorer_type: ScorerType = ScorerType.COMPOSITE,
        include_debug: bool = False,
    ) -> RAGResponse:
        """Full pipeline (enhanced_rag_system.py:280-358)."""
        start = time.time()
        try:
            scored_nodes, query_input = self.retrieve_and_rank(
                query, top_k, similarity_threshold, scorer_type
            )
            if not scored_nodes:
                return RAGResponse(
                    query=query,
                    answer="I couldn't find any relevant information for your query.",
                    context_used=[],
                    relevance_scores=[],
                    metadata={"error": "No relevant nodes found"},
                    processing_time=time.time() - start,
                )
            context = self.optimize_context(scored_nodes, query_input)
            answer = self.generate_response(query, context, query_input)
            metadata = {
                "query_intent": query_input.intent.value,
                "nodes_retrieved": len(scored_nodes),
                "nodes_used": len(context),
                "scorer_type": scorer_type.value,
                "top_relevance_score": scored_nodes[0]["combined_score"],
            }
            if include_debug:
                metadata["debug"] = {
                    "all_scores": [
                        (n["combined_score"], n["content"][:100])
                        for n in scored_nodes[:5]
                    ],
                    "query_entities": query_input.entities,
                }
            return RAGResponse(
                query=query,
                answer=answer,
                context_used=[
                    {
                        "content": n["content"],
                        "metadata": n["metadata"],
                        "relevance_score": n["combined_score"],
                    }
                    for n in context
                ],
                relevance_scores=[n["combined_score"] for n in context],
                metadata=metadata,
                processing_time=time.time() - start,
            )
        except Exception as e:  # pipeline-level failure wrapper (:349-358)
            return RAGResponse(
                query=query,
                answer=f"An error occurred processing your query: {e}",
                context_used=[],
                relevance_scores=[],
                metadata={"error": str(e)},
                processing_time=time.time() - start,
            )
