"""QueryInterface — multi-mode query surface with keyword-rule auto selection.

Counterpart of `hcrag_tpu/query/interface.py`, the reference's
`QueryInterface` (query_interface.py:114-449): four
query engines over one store — ``vector`` / ``keyword`` / ``context`` /
``default`` — a keyword-rule auto selector (`_select_best_mode`,
query_interface.py:272-292, rules preserved verbatim), and the reference's
result dict shape ``{question, answer, mode, source_nodes, metadata}``
(query_interface.py:251-258) including the failure shape
(query_interface.py:264-270).

Mode mapping onto the engine (the reference delegates to four LlamaIndex
retrievers; here each mode is a different composition of the engine's
step, which runs on the engine's device):

  * ``vector``  — dense cosine top-k (VectorStoreIndex retriever analogue).
  * ``keyword`` — token-overlap retrieval over row texts
    (LLMSynonymRetriever analogue: exact/overlapping term match, no
    embedding), vectorized over a prebuilt token-set table.
  * ``context`` — dense top-k + k-hop graph expansion + composite relevance
    (VectorContextRetriever analogue: vector hits enriched with graph
    context).
  * ``default`` — the engine's `process_query` pipeline (parse -> retrieve
    -> threshold), the PropertyGraphIndex default engine analogue.

Answers synthesize via the LLM client when an endpoint is configured and
fall back to a deterministic extractive summary offline (the framework's
standard degradation contract, SURVEY §5.3).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")

#: query_interface.py:277-289 — the auto-selection keyword rules, verbatim.
_VECTOR_WORDS = ["similar", "like", "related", "compare", "difference", "semantic"]
_KEYWORD_WORDS = ["find", "search", "locate", "show", "list", "what is"]
_CONTEXT_WORDS = ["analyze", "explain", "why", "how", "relationship", "pattern"]


def select_best_mode(question: str) -> str:
    """query_interface.py:272-292 — first matching rule wins, else default."""
    q = question.lower()
    if any(w in q for w in _VECTOR_WORDS):
        return "vector"
    if any(w in q for w in _KEYWORD_WORDS):
        return "keyword"
    if any(w in q for w in _CONTEXT_WORDS):
        return "context"
    return "default"


class QueryInterface:
    MODES = ("vector", "keyword", "context", "default")

    def __init__(self, engine, llm=None, top_k: int = 5):
        self.engine = engine
        self.top_k = top_k
        if llm is None:
            from hcrag_tpu_torch.pipeline.llm import LLMClient

            llm = LLMClient()
        self.llm = llm
        # Keyword mode: per-row token sets over the index texts, built once.
        self._row_tokens = [
            frozenset(_TOKEN_RE.findall(t.lower())) for t in engine.index.texts
        ]
        self._bank_norm = None  # lazy, for encoder-confidence features

    # --- encoder-confidence gate ---------------------------------------------
    def _encoder_confidence(self, question: str) -> Optional[Dict]:
        """Calibrated in-domain probability for the distilled encoder on
        this query (models/confidence.py), or None when the engine uses a
        non-trainable encoder / the bank is too large for the host-side
        feature pass.  The reference's true MiniLM checkpoint
        (embedding_generator.py:18-21) needs no gate; the distilled
        stand-in must not silently serve off-domain queries."""
        emb = self.engine.embedder
        if not hasattr(emb, "load_params") or self.engine.index.n > 100_000:
            return None
        try:
            from hcrag_tpu_torch.models.confidence import encoder_confidence

            if self._bank_norm is None:
                bank = np.asarray(self.engine.index.emb, np.float32)
                self._bank_norm = bank / np.maximum(
                    np.linalg.norm(bank, axis=1, keepdims=True), 1e-12
                )
            return encoder_confidence(emb, self._bank_norm, question)
        except Exception:
            # The gate must never break query serving.
            return None

    # --- mode engines -------------------------------------------------------
    def _embed(self, question: str) -> np.ndarray:
        q = np.asarray(self.engine.embedder.encode([question])[0], np.float32)
        return q / max(float(np.linalg.norm(q)), 1e-12)

    def _vector(self, question: str) -> List[Dict]:
        return self.engine.find_similar_content(
            self._embed(question), top_k=self.top_k, similarity_threshold=0.0
        )

    def _keyword(self, question: str) -> List[Dict]:
        """Term-overlap retrieval: |q ∩ row| / |q|, ties to lower row.

        Host-side Python over the token-set table — right-sized for the
        generic-ingestion corpora this mode serves (hundreds to tens of
        thousands of rows, like the reference's LLMSynonymRetriever); at
        index scale (1M+) use vector/context modes, whose work is on
        device."""
        q_tokens = set(_TOKEN_RE.findall(question.lower()))
        if not q_tokens:
            return []
        scores = np.array(
            [len(q_tokens & row) / len(q_tokens) for row in self._row_tokens]
        )
        order = np.argsort(-scores, kind="stable")[: self.top_k]
        return [
            {
                "content": self.engine.index.texts[i],
                "metadata": self.engine.index.metadata[i],
                "similarity_score": float(scores[i]),
            }
            for i in order
            if scores[i] > 0
        ]

    def _context(self, question: str) -> List[Dict]:
        """Vector hits + their expanded graph context, relevance-ranked."""
        res = self.engine.query_batch(
            self._embed(question)[None, :], top_k=self.top_k,
            expansion_depth=1,
        )
        out: List[Dict] = []
        for rank in range(res.top_indices.shape[1]):
            i = int(res.top_indices[0, rank])
            if i < 0:
                continue
            out.append(
                {
                    "content": self.engine.index.texts[i],
                    "metadata": self.engine.index.metadata[i],
                    "similarity_score": float(res.top_scores[0, rank]),
                }
            )
        graph = self.engine.graph
        if graph is not None:
            count = int(np.asarray(res.expanded_counts)[0])
            for j in range(count):
                node = int(np.asarray(res.expanded_nodes)[0, j])
                if node < 0:
                    continue
                out.append(
                    {
                        "content": graph.node_texts[node],
                        "metadata": {
                            "type": "graph_context",
                            "label": graph.node_labels[node],
                            "key": graph.node_keys[node],
                        },
                        "similarity_score": 0.0,
                    }
                )
        return out

    def _default(self, question: str) -> List[Dict]:
        out = self.engine.process_query(
            question, top_k=self.top_k, similarity_threshold=0.0
        )
        return out["results"]

    # --- answer synthesis ---------------------------------------------------
    def _answer(self, question: str, hits: List[Dict]) -> str:
        if not hits:
            return "No matching content found for this question."
        context = "\n".join(
            f"Resource {i + 1}: {h['content'][:300]}"
            for i, h in enumerate(hits[:5])
        )
        fallback = (
            f"Based on {len(hits)} matching resources, the most relevant "
            f"content is: {hits[0]['content'][:200]}"
        )
        return self.llm.call(
            "Answer the question using only the provided resources. "
            "Be concise and factual.",
            f"Question: {question}\n\nResources:\n{context}",
            fallback=fallback,
            max_tokens=500,
        )

    # --- the reference surface ----------------------------------------------
    def query(self, question: str, mode: str = "auto") -> Dict[str, Any]:
        """query_interface.py:223-270, incl. mode fallback + failure shape."""
        if mode == "auto":
            mode = select_best_mode(question)
        runner = {
            "vector": self._vector,
            "keyword": self._keyword,
            "context": self._context,
            "default": self._default,
        }.get(mode)
        if runner is None:
            mode_used = "default"
            runner = self._default
        else:
            mode_used = mode
        try:
            hits = runner(question)
            metadata: Dict[str, Any] = {
                "top_score": hits[0]["similarity_score"] if hits else 0.0,
                "results": hits,
            }
            # Low-confidence downgrade: when the distilled encoder's
            # calibrated in-domain probability falls below the gate, the
            # embedding-driven hits are unreliable — blend in keyword
            # (embedding-free) retrieval ahead of them and flag the result
            # visibly.
            if mode_used != "keyword":
                conf = self._encoder_confidence(question)
                if conf is not None:
                    metadata["encoder_confidence"] = conf
                    from hcrag_tpu_torch import config as _cfg

                    if conf["score"] < _cfg.ENCODER_CONFIDENCE_THRESHOLD:
                        metadata["low_confidence"] = True
                        metadata["fallback_mode"] = "keyword"
                        kw = self._keyword(question)
                        seen = {h["content"] for h in kw}
                        hits = kw + [
                            h for h in hits if h["content"] not in seen
                        ]
                        metadata["results"] = hits
                        metadata["top_score"] = (
                            hits[0]["similarity_score"] if hits else 0.0
                        )
                        mode_used = f"{mode_used}+keyword_fallback"
            return {
                "question": question,
                "answer": self._answer(question, hits),
                "mode": mode_used,
                "source_nodes": len(hits),
                "metadata": metadata,
            }
        except Exception as e:  # the reference returns, never raises
            return {
                "question": question,
                "answer": f"Query failed: {e}",
                "mode": mode_used,
                "source_nodes": 0,
                "metadata": {},
            }

    def explore_graph(self) -> Dict[str, Any]:
        """Graph-structure stats (query_interface.py:294-362 analogue)."""
        stats = self.engine.get_content_statistics()
        out = {
            "total_nodes": stats["total_entries"],
            "node_types": sorted(stats["content_types"]),
        }
        if self.engine.graph is not None:
            g = self.engine.graph.statistics()
            out["total_nodes"] = self.engine.graph.num_nodes
            out["total_relationships"] = sum(g["relationships"].values())
            out["node_types"] = sorted(g["nodes"])
            out["relationship_types"] = sorted(g["relationships"])
        return out

    def suggest_queries(
        self, graph_stats: Optional[Dict] = None
    ) -> List[str]:
        """query_interface.py:364-393 — generic + per-type suggestions."""
        if not graph_stats:
            graph_stats = self.explore_graph()
        suggestions = [
            "What are the main entities in this data?",
            "What relationships exist between different entities?",
            "Show me the most important connections in the graph",
            "What patterns can you identify in the data?",
            "Summarize the key information in this dataset",
        ]
        for node_type in graph_stats.get("node_types", [])[:3]:
            suggestions.append(f"Tell me about {node_type} entities")
            suggestions.append(f"What are the properties of {node_type}?")
        for rel_type in graph_stats.get("relationship_types", [])[:3]:
            suggestions.append(f"Show me examples of {rel_type} relationships")
        return suggestions
