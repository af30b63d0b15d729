"""Agentic retrieval pipeline: the reference's LangGraph workflow as a
driver loop.

Counterpart of `hcrag_tpu/pipeline/agent.py`: a deterministic driver over
state-update functions, wired as

  analyze_query -> sample_nodes -> score_semantic_similarity ->
  expand_subgraph -> score_all_nodes_with_isrelevant -> evaluate_context
  -> (sufficient -> generate_answer | revision -> revise_question -> loop)

with the reference's constants: 20 sampled nodes, the 0.60 semantic gate,
per-node 1-hop expansion over all edge types (first 3 neighbors), the top-15
final cut, the 0.7 high-relevance short-circuit, at most 2 revisions, a
recursion limit of 15, and every LLM fallback.  Query embeddings are real
(the engine's embedder) and node sampling is seeded by
`config.random_seed` (`random.Random`, so both packages sample the same
ids).  The scoring stages run on the engine's device (`engine.device`).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from hcrag_tpu_torch import config as cfg
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import (
    NodeInput,
    QueryInput,
    QueryIntent,
    ScorerType,
)
from hcrag_tpu_torch.ingest.entities import (
    extract_entities_from_content,
    infer_query_intent,
)
from hcrag_tpu_torch.pipeline.isrelevant import (
    batch_isRelevant,
    batch_semantic_similarity,
)
from hcrag_tpu_torch.pipeline.llm import (
    Decision,
    EntityExtractionResponse,
    LLMClient,
    QueryIntentResponse,
)
from hcrag_tpu_torch.query.engine import QueryEngine

# --- LLM-backed query analysis (with deterministic fallbacks) ---------------

_INTENT_SYSTEM_PROMPT = """You are an expert in user intent analysis. Your task is to classify user questions into one of the following categories:

1. **product_search**: User is looking for specific products, often with criteria like price, color, features
2. **document_request**: User wants documents, manuals, guides, instructions
3. **technical_support**: User has technical problems, seeks help, troubleshooting
4. **comparison_request**: User wants to compare products or options
5. **specification_inquiry**: User seeks technical specifications, detailed features

Analyze the question and return the most appropriate intent with confidence and reasoning."""

_NER_SYSTEM_PROMPT = """You are an expert in named entity recognition for product search queries. Extract relevant entities (colors, product types, materials, brands, specifications, categories) from user questions that would be useful for matching against product data. Avoid generic words like "find", "show", "search". Return entities in their most useful form (e.g., "mountain bike" not just "mountain")."""


def analyze_query_intent(question: str, client: LLMClient) -> QueryIntent:
    """LLM intent classification; keyword routing when offline,
    PRODUCT_SEARCH on failure."""
    if client.offline:
        return infer_query_intent(question)
    resp = client.call(
        _INTENT_SYSTEM_PROMPT,
        f"Analyze this question and determine the intent: '{question}'",
        QueryIntentResponse,
    )
    if isinstance(resp, QueryIntentResponse):
        return QueryIntent.from_string(resp.intent)
    return QueryIntent.PRODUCT_SEARCH


def extract_entities_from_query(question: str, client: LLMClient) -> List[str]:
    """LLM entity extraction capped at 10 entities; keyword vocabulary
    extraction when offline, [] on failure."""
    if client.offline:
        return extract_entities_from_content(question)[: cfg.MAX_QUERY_ENTITIES]
    resp = client.call(
        _NER_SYSTEM_PROMPT,
        f"Extract relevant entities from this query: '{question}'",
        EntityExtractionResponse,
        timeout=15,
        fallback=False,
    )
    if not isinstance(resp, EntityExtractionResponse):
        return []
    entities = []
    seen = set()
    for e in resp.entities:
        e = e.strip().lower()
        if e and len(e) > 1 and e not in seen:
            seen.add(e)
            entities.append(e)
    return entities[: cfg.MAX_QUERY_ENTITIES]


# --- agent ------------------------------------------------------------------


@dataclasses.dataclass
class AgentResult:
    question: str
    final_answer: str
    query_input: Optional[QueryInput]
    final_relevant_nodes: List[NodeInput]
    semantic_scored_nodes: List[NodeInput]
    expanded_nodes: List[Dict]
    expanded_scored_nodes: List[NodeInput]
    expanded_subgraph: List[Dict]
    revision_history: List[str]
    decision: str
    node_trace: List[str]
    #: Calibrated in-domain probability of the distilled encoder for the
    #: (final) question, when the engine uses one (models/confidence.py);
    #: None for non-trainable encoders.  Low values mean the semantic gate
    #: ran over embeddings of unknown fidelity.
    encoder_confidence: Optional[Dict] = None


class RetrievalAgent:
    """The evaluate/revise agent over a QueryEngine + CsrGraph."""

    def __init__(
        self,
        engine: QueryEngine,
        graph: Optional[CsrGraph] = None,
        *,
        client: Optional[LLMClient] = None,
        config=None,
    ):
        self.engine = engine
        self.graph = graph if graph is not None else engine.graph
        self.client = client or LLMClient(config)
        self.config = config or cfg.GLOBAL_CONFIG

    # -- node: analyze_query (neo4j_rag_langgraph.py:405-411) --------------
    def analyze_query(self, state: Dict) -> Dict:
        question = state["question"]
        intent = analyze_query_intent(question, self.client)
        entities = extract_entities_from_query(question, self.client)
        embeddings = np.asarray(self.engine.embedder.encode([question])[0])
        out = {
            "query_input": QueryInput(
                text=question, embeddings=embeddings, entities=entities,
                intent=intent,
            )
        }
        # Encoder-confidence signal for distilled encoders: recorded in the
        # state (and surfaced on AgentResult) so a low-fidelity encode of
        # the question is visible instead of silently gating semantics on
        # it.  A failure of this optional signal leaves it out, as in JAX.
        emb = self.engine.embedder
        if hasattr(emb, "load_params") and self.engine.index.n <= 100_000:
            try:
                from hcrag_tpu_torch.models.confidence import encoder_confidence

                bank = np.asarray(self.engine.index.emb, np.float32)
                bank_norm = bank / np.maximum(
                    np.linalg.norm(bank, axis=1, keepdims=True), 1e-12
                )
                out["encoder_confidence"] = encoder_confidence(
                    emb, bank_norm, question, query_emb=embeddings[None, :]
                )
            except Exception:
                pass
        return out

    # -- node: sample_nodes (neo4j_rag_langgraph.py:310-349, 414-422) ------
    def sample_nodes(self, state: Dict) -> Dict:
        g = self.graph
        if g is None or g.num_nodes == 0:
            return {"sampled_nodes": []}
        rng = random.Random(self.config.random_seed)
        # With-replacement uniform sampling, like the reference's per-sample
        # random SKIP queries (duplicates possible).
        ids = [rng.randint(0, g.num_nodes - 1) for _ in range(cfg.SAMPLE_LIMIT)]
        return {"sampled_nodes": ids}

    def _node_input(self, node_id: int) -> NodeInput:
        """Graph node -> NodeInput (neo4j_rag_langgraph.py:352-399) with real
        embeddings from the linked index row (or text-hash embedding)."""
        g = self.graph
        text = g.node_texts[node_id] or "Unknown content"
        row = int(g.node_to_row[node_id])
        if row >= 0:
            emb = np.asarray(self.engine.index.emb[row], np.float32)
        else:
            emb = np.asarray(self.engine.embedder.encode([text])[0])
        node_type = g.node_labels[node_id].lower()
        entities = extract_entities_from_content(text)
        ni = NodeInput(
            text=text,
            embeddings=emb,
            graph_relations={"node_id": node_id, "label": g.node_labels[node_id],
                             "key": g.node_keys[node_id]},
            node_type=node_type,
            entities=entities,
        )
        ni.score = 0.0
        return ni

    # -- node: score_semantic_similarity (…langgraph.py:425-473) -----------
    def score_semantic_similarity(self, state: Dict) -> Dict:
        sampled = state.get("sampled_nodes", [])
        query_input = state["query_input"]
        candidates = [self._node_input(i) for i in sampled]
        if not candidates:
            return {"semantic_scored_nodes": []}
        scores = batch_semantic_similarity(
            query_input, candidates, device=self.engine.device
        )
        for node, s in zip(candidates, scores):
            node.score = s
        ranked = sorted(candidates, key=lambda x: x.score, reverse=True)
        gated = [n for n in ranked if n.score >= cfg.SEMANTIC_GATE]
        return {"semantic_scored_nodes": gated}

    # -- node: expand_subgraph (…langgraph.py:476-537) ---------------------
    def expand_subgraph(self, state: Dict) -> Dict:
        g = self.graph
        expanded_subgraph: List[Dict] = []
        expanded_nodes: List[Dict] = []
        seen = set()
        if g is not None:
            for node in state.get("semantic_scored_nodes", []):
                node_id = node.graph_relations.get("node_id")
                if node_id is None:
                    continue
                nbrs, types = g.neighbors_of(int(node_id))
                # ANY edge type, first 3 neighbors (LIMIT 3,
                # neo4j_rag_langgraph.py:497).
                for nb, t in list(zip(nbrs, types))[
                    : cfg.EXPANSION_NEIGHBOR_LIMIT
                ]:
                    rec = {
                        "source": int(node_id),
                        "target": int(nb),
                        "relation_type": int(t),
                    }
                    expanded_subgraph.append(rec)
                    if int(nb) not in seen:
                        seen.add(int(nb))
                        expanded_nodes.append({"node_id": int(nb)})
        return {
            "expanded_subgraph": expanded_subgraph,
            "expanded_nodes": expanded_nodes,
        }

    # -- node: score_all_nodes_with_isrelevant (…langgraph.py:540-620) -----
    def score_all_nodes(self, state: Dict) -> Dict:
        semantic_nodes = state.get("semantic_scored_nodes", [])
        expanded = state.get("expanded_nodes", [])
        query_input = state["query_input"]
        expanded_inputs = [self._node_input(d["node_id"]) for d in expanded]
        all_nodes = semantic_nodes + expanded_inputs
        if not all_nodes:
            return {"expanded_scored_nodes": [], "final_relevant_nodes": []}
        try:
            scores = batch_isRelevant(
                query_input,
                all_nodes,
                self.config.scorer_type,
                self.config.batch_size,
                self.config.composite_weights,
                client=self.client,
                device=self.engine.device,
            )
            for node, s in zip(all_nodes, scores):
                node.score = s
            final = sorted(all_nodes, key=lambda x: x.score, reverse=True)[
                : cfg.FINAL_TOP_K
            ]
            return {
                "expanded_scored_nodes": expanded_inputs,
                "final_relevant_nodes": final,
            }
        except Exception:
            # The reference's fallback: the top-5 semantic nodes.
            return {
                "expanded_scored_nodes": [],
                "final_relevant_nodes": semantic_nodes[:5],
            }

    # -- node: evaluate_context (…langgraph.py:623-687) --------------------
    def evaluate_context(self, state: Dict) -> Dict:
        final_nodes = state.get("final_relevant_nodes", [])
        revision_history = state.get("revision_history", [])
        if len(revision_history) >= cfg.MAX_REVISIONS:
            return {"decision": "sufficient"}
        high = [n for n in final_nodes if getattr(n, "score", 0) > cfg.HIGH_RELEVANCE]
        if len(high) >= 1:
            return {"decision": "sufficient"}
        query_input = state["query_input"]
        context_summary = (
            f"Total relevant nodes: {len(final_nodes)}\n"
            f"High relevance nodes (>0.7): {len(high)}\n"
            f"Query intent: {query_input.intent.value}"
        )
        top_text = "\n".join(
            f"- {n.text[:100]}... (score: {getattr(n, 'score', 0):.3f})"
            for n in final_nodes[:5]
        )
        system_prompt = (
            "You are a supervisor of a knowledge graph-based RAG system. "
            "Evaluate whether the collected context is sufficient to answer "
            "the user's question.\n\nIf the context seems complete and "
            "relevant for the intent, respond 'sufficient'. If the context "
            "is poor or irrelevant, respond 'revision'.\n\nIMPORTANT: Bias "
            "towards 'sufficient' unless the context is completely irrelevant."
        )
        user_prompt = (
            f"Question: {state['question']}\n"
            f"Intent detected: {query_input.intent.value}\n"
            f"Revision history: {revision_history}\n\n"
            f"Context analysis from knowledge graph:\n{context_summary}\n\n"
            f"Top 5 relevant nodes:\n{top_text}\n\n"
            "Evaluate whether the context is sufficient to answer the question."
        )
        decision = self.client.call(
            system_prompt, user_prompt, Decision, timeout=15,
            fallback=Decision(decision="sufficient", reasoning="fallback"),
        )
        d = decision.decision if isinstance(decision, Decision) else "sufficient"
        if d not in ("sufficient", "revision"):
            d = "sufficient"
        return {"decision": d}

    # -- node: revise_question (…langgraph.py:690-731) ---------------------
    def revise_question(self, state: Dict) -> Dict:
        query_input = state["query_input"]
        system_prompt = (
            "You are an expert in knowledge graph search. The previous "
            "question did not produce sufficient results from the knowledge "
            "graph.\nReformulate the question for a different approach.\n\n"
            "Generate only the reformulated question."
        )
        user_prompt = (
            f"Original Question: {state['question']}\n"
            f"Current intent: {query_input.intent.value}\n"
            f"Entities found: {query_input.entities}\n"
            f"Revision history: {state.get('revision_history', [])}\n\n"
            "Reformulate the question to get better results from the "
            "knowledge graph:"
        )
        fallback_q = f"Show me information about: {state['question']}"
        new_q = self.client.call(system_prompt, user_prompt, fallback=fallback_q)
        if not isinstance(new_q, str) or not new_q.strip():
            new_q = fallback_q
        history = list(state.get("revision_history", []))
        history.append(state["question"])
        return {"question": new_q.strip(), "revision_history": history}

    # -- node: generate_answer (…langgraph.py:734-796) ---------------------
    def _answer_prompts(self, state: Dict):
        """Build the (system, user, offline_fallback) triple for the final
        generation call — factored out so ImprovedRetrievalAgent can stream
        through the SAME prompts (call_stream) instead of re-deriving them."""
        final_nodes = state.get("final_relevant_nodes", [])
        query_input = state["query_input"]
        expanded_subgraph = state.get("expanded_subgraph", [])
        context_text = "\n\n".join(
            f"Resource {i + 1} (relevance: {getattr(n, 'score', 0):.3f}):\n{n.text}"
            for i, n in enumerate(final_nodes)
        )
        if expanded_subgraph:
            context_text += (
                f"\n\nKnowledge graph connections: {len(expanded_subgraph)} "
                "relations found"
            )
        system_prompt = (
            f"You are an AI assistant that uses a knowledge graph to answer "
            f"questions. \nYou specialize in {query_input.intent.value}. \n\n"
            "Answer the user's question based on the provided context, which "
            "has been extracted from a knowledge graph and evaluated for "
            "relevance.\n\nInstructions:\n"
            "1. Use only information from the provided context\n"
            "2. Indicate confidence level in your response\n"
            "3. If context is insufficient, be honest about it\n"
            "4. Structure the response clearly and helpfully\n"
            "5. Mention that information comes from a knowledge graph"
        )
        user_prompt = (
            f"Question: {state['question']}\n"
            f"Intent: {query_input.intent.value}\n"
            f"Relevant entities: {', '.join(query_input.entities)}\n\n"
            f"--- CONTEXT FROM KNOWLEDGE GRAPH ---\n{context_text}\n"
            "--- END CONTEXT ---\n\n"
            "Provide a complete and accurate answer based on the knowledge "
            "graph:"
        )

        def offline_answer():
            # Deterministic offline summary with the reference's fallback
            # structure (neo4j_rag_langgraph.py:789-795).
            return (
                "Based on the knowledge graph, the most relevant resources "
                f"for '{state['question']}' are:\n\n{context_text[:1000]}\n\n"
                "(Generated offline from knowledge-graph context; no LLM "
                "endpoint configured.)"
            )

        return system_prompt, user_prompt, offline_answer

    def generate_answer(self, state: Dict) -> Dict:
        system_prompt, user_prompt, offline_answer = self._answer_prompts(state)
        answer = self.client.call(system_prompt, user_prompt, fallback=offline_answer)
        if not isinstance(answer, str) or not answer.strip():
            answer = "No answer generated"
        return {"final_answer": answer.strip()}

    # -- driver loop (workflow wiring, …langgraph.py:801-838) --------------
    def run(
        self,
        question: str,
        recursion_limit: int = cfg.RECURSION_LIMIT,
        on_step: Optional[Callable[[str, Dict], None]] = None,
    ) -> AgentResult:
        state: Dict = {
            "question": question,
            "revision_history": [],
            "sampled_nodes": [],
            "semantic_scored_nodes": [],
            "expanded_nodes": [],
            "expanded_scored_nodes": [],
            "final_relevant_nodes": [],
            "expanded_subgraph": [],
            "decision": "",
            "final_answer": "",
        }
        trace: List[str] = []
        steps = 0

        def apply(name: str, fn) -> None:
            nonlocal steps
            steps += 1
            trace.append(name)
            state.update(fn(state))
            if on_step:
                on_step(name, state)

        while steps < recursion_limit:
            apply("analyze_query", self.analyze_query)
            apply("sample_nodes", self.sample_nodes)
            apply("score_semantic_similarity", self.score_semantic_similarity)
            apply("expand_subgraph", self.expand_subgraph)
            apply("score_all_nodes_with_isrelevant", self.score_all_nodes)
            apply("evaluate_context", self.evaluate_context)
            if state["decision"] == "revision" and steps < recursion_limit:
                apply("revise_question", self.revise_question)
                continue
            apply("generate_answer", self.generate_answer)
            break
        else:
            apply("generate_answer", self.generate_answer)

        return AgentResult(
            question=state["question"],
            final_answer=state["final_answer"],
            query_input=state.get("query_input"),
            final_relevant_nodes=state.get("final_relevant_nodes", []),
            semantic_scored_nodes=state.get("semantic_scored_nodes", []),
            expanded_nodes=state.get("expanded_nodes", []),
            expanded_scored_nodes=state.get("expanded_scored_nodes", []),
            expanded_subgraph=state.get("expanded_subgraph", []),
            revision_history=state.get("revision_history", []),
            decision=state.get("decision", ""),
            node_trace=trace,
            encoder_confidence=state.get("encoder_confidence"),
        )
