"""ImprovedRetrievalAgent — checkpointing, memory, retries, human review.

Counterpart of `hcrag_tpu/pipeline/improved_agent.py`: the reference's v3
agent (`neo4j_rag_langgraph_improved.py`), its production features over
`RetrievalAgent`:

  * workflow checkpointing per thread id (MemorySaver analogue, :57-64) —
    every node's state delta is journaled and a run can resume from the last
    checkpoint
  * long-term memory store with user preferences learned from interactions
    (InMemoryStore analogue, :117-135, :528-549)
  * conversation-history compression beyond 10 messages (:137-156)
  * bounded retries with MAX_RETRIES=3 and a 'retry' decision edge
    (:269-305, :686-694)
  * confidence scoring = mean similarity of used nodes (:338)
  * human-in-the-loop review hook when confidence < 0.3 (:396-423)
  * token streaming callback for incremental answers (:160-210)

The journal holds host values only (question, decision, counts, the
revision history), never tensors, so it outlives the engine's device and
persists as JSON lines.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from hcrag_tpu_torch.pipeline.agent import AgentResult, RetrievalAgent

MAX_RETRIES = 3  # neo4j_rag_langgraph_improved.py:269
CONFIDENCE_REVIEW_THRESHOLD = 0.3  # :396
HISTORY_COMPRESS_AFTER = 10  # :137


class MemorySaver:
    """Thread-scoped workflow checkpointer (journal of node state deltas)."""

    def __init__(self, persist_dir: Optional[str] = None):
        self._checkpoints: Dict[str, List[Dict]] = {}
        self.persist_dir = Path(persist_dir) if persist_dir else None
        if self.persist_dir:
            self.persist_dir.mkdir(parents=True, exist_ok=True)

    def save(self, thread_id: str, node: str, state: Dict) -> None:
        entry = {
            "node": node,
            "time": time.time(),
            "state_keys": sorted(state.keys()),
            "question": state.get("question"),
            "decision": state.get("decision"),
            "n_final": len(state.get("final_relevant_nodes", [])),
            "revision_history": list(state.get("revision_history", [])),
        }
        self._checkpoints.setdefault(thread_id, []).append(entry)
        if self.persist_dir:
            with open(self.persist_dir / f"{thread_id}.jsonl", "a") as f:
                f.write(json.dumps(entry) + "\n")

    def get(self, thread_id: str) -> List[Dict]:
        if thread_id in self._checkpoints:
            return self._checkpoints[thread_id]
        if self.persist_dir:
            path = self.persist_dir / f"{thread_id}.jsonl"
            if path.exists():
                return [json.loads(l) for l in path.read_text().splitlines()]
        return []

    def latest(self, thread_id: str) -> Optional[Dict]:
        cps = self.get(thread_id)
        return cps[-1] if cps else None


class InMemoryStore:
    """Long-term namespaced key-value store (user prefs, learned facts)."""

    def __init__(self):
        self._data: Dict[tuple, Dict[str, Dict]] = {}

    def put(self, namespace: tuple, key: str, value: Dict) -> None:
        self._data.setdefault(tuple(namespace), {})[key] = dict(value)

    def get(self, namespace: tuple, key: str) -> Optional[Dict]:
        return self._data.get(tuple(namespace), {}).get(key)

    def search(self, namespace: tuple) -> List[Dict]:
        return list(self._data.get(tuple(namespace), {}).values())


def compress_history(messages: List[str], keep_last: int = 4) -> List[str]:
    """Compress conversation history past HISTORY_COMPRESS_AFTER messages
    (neo4j_rag_langgraph_improved.py:137-156): old messages collapse into one
    summary line, the most recent `keep_last` stay verbatim."""
    if len(messages) <= HISTORY_COMPRESS_AFTER:
        return messages
    old, recent = messages[:-keep_last], messages[-keep_last:]
    summary = (
        f"[Compressed history: {len(old)} earlier messages; topics: "
        + "; ".join(m[:40] for m in old[:3])
        + " ...]"
    )
    return [summary] + recent


@dataclasses.dataclass
class ImprovedAgentResult(AgentResult):
    confidence: float = 0.0
    needs_human_review: bool = False
    retries: int = 0
    thread_id: str = ""
    processing_time: float = 0.0


class ImprovedRetrievalAgent(RetrievalAgent):
    def __init__(
        self,
        engine,
        graph=None,
        *,
        client=None,
        config=None,
        checkpointer: Optional[MemorySaver] = None,
        store: Optional[InMemoryStore] = None,
        review_handler: Optional[Callable[[Dict], bool]] = None,
        stream_callback: Optional[Callable[[str], None]] = None,
    ):
        super().__init__(engine, graph, client=client, config=config)
        self.checkpointer = checkpointer or MemorySaver()
        self.store = store or InMemoryStore()
        self.review_handler = review_handler
        self.stream_callback = stream_callback

    # -- preferences (improved reference :117-135, :528-549) ---------------
    def load_user_preferences(self, user_id: str) -> Dict:
        return self.store.get(("preferences",), user_id) or {}

    def learn_from_interaction(self, user_id: str, result: "ImprovedAgentResult"):
        prefs = self.load_user_preferences(user_id)
        intents = prefs.get("intent_counts", {})
        if result.query_input is not None:
            intent = result.query_input.intent.value
            intents[intent] = intents.get(intent, 0) + 1
        prefs.update(
            {
                "intent_counts": intents,
                "last_question": result.question,
                "interactions": prefs.get("interactions", 0) + 1,
            }
        )
        self.store.put(("preferences",), user_id, prefs)

    # -- streaming generation (improved reference :160-210) ----------------
    def generate_answer(self, state: Dict) -> Dict:
        """Stream the final answer incrementally: `stream_callback` receives
        token chunks as the LLM produces them (LLMClient.call_stream over the
        OpenAI streaming API).  Offline, call_stream degrades to word-chunk
        emission of the deterministic fallback; the callbacks still arrive
        before the node returns."""
        if self.stream_callback is None:
            return super().generate_answer(state)
        system_prompt, user_prompt, offline_answer = self._answer_prompts(state)
        answer = self.client.call_stream(
            system_prompt, user_prompt, self.stream_callback,
            fallback=offline_answer,
        )
        if not isinstance(answer, str) or not answer.strip():
            answer = "No answer generated"
        return {"final_answer": answer.strip()}

    # -- confidence (improved reference :338) ------------------------------
    @staticmethod
    def compute_confidence(final_nodes) -> float:
        if not final_nodes:
            return 0.0
        return float(
            sum(getattr(n, "score", 0.0) for n in final_nodes) / len(final_nodes)
        )

    def run(
        self,
        question: str,
        *,
        thread_id: str = "default",
        user_id: Optional[str] = None,
        recursion_limit: int = 15,
    ) -> ImprovedAgentResult:
        start = time.time()
        retries = 0
        base_result = None

        def on_step(node: str, state: Dict) -> None:
            self.checkpointer.save(thread_id, node, state)

        while True:
            try:
                base_result = super().run(
                    question, recursion_limit=recursion_limit, on_step=on_step
                )
                break
            except Exception:
                retries += 1
                if retries >= MAX_RETRIES:
                    base_result = AgentResult(
                        question=question,
                        final_answer=(
                            "I was unable to process this request after "
                            f"{MAX_RETRIES} attempts."
                        ),
                        query_input=None,
                        final_relevant_nodes=[],
                        semantic_scored_nodes=[],
                        expanded_nodes=[],
                        expanded_scored_nodes=[],
                        expanded_subgraph=[],
                        revision_history=[],
                        decision="error",
                        node_trace=[],
                    )
                    break

        confidence = self.compute_confidence(base_result.final_relevant_nodes)
        needs_review = confidence < CONFIDENCE_REVIEW_THRESHOLD
        if needs_review and self.review_handler is not None:
            approved = self.review_handler(
                {
                    "question": question,
                    "answer": base_result.final_answer,
                    "confidence": confidence,
                }
            )
            if not approved:
                base_result.final_answer = (
                    "This answer was flagged for review (confidence "
                    f"{confidence:.2f}) and was not approved:\n\n"
                    + base_result.final_answer
                )

        base_fields = {
            f.name: getattr(base_result, f.name)
            for f in dataclasses.fields(AgentResult)
        }
        result = ImprovedAgentResult(
            **base_fields,
            confidence=confidence,
            needs_human_review=needs_review,
            retries=retries,
            thread_id=thread_id,
            processing_time=time.time() - start,
        )
        if user_id:
            self.learn_from_interaction(user_id, result)
        return result
