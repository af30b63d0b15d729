"""Extensible class-based scorer framework: pluggable metrics and combiners.

Counterpart of `hcrag_tpu/pipeline/scorer_designs.py`: the abstract
`RelevanceMetric` with five metric classes (semantic similarity, LLM judge,
entity match, node-type priority and graph centrality), the weighted
`CompositeScorer` (0.3 / 0.25 / 0.2 / 0.15 / 0.1 by default), the v0
prototype's per-(intent, node-type) weights as a dense tensor
(`v0_weight_tensor`, `canonical_dynamic_weight_tensor` for
`QueryEngine.query_batch(dynamic_weight_tensor=...)`) and its
weighted-average `DynamicWeightScorer`.

The metrics that run tensor ops (semantic similarity, entity match, node-type
priority) take a `device=` (CUDA unless named, as `pipeline/isrelevant.py`
does); the default scorers hand theirs to every metric they build, so a
caller passes its engine's device once.  The LLM judge and the graph
centrality are host code.
"""

from __future__ import annotations

import abc
import enum
from typing import Dict, List, Optional, Sequence

import numpy as np

from hcrag_tpu_torch.core.types import (
    INTENT_ORDER,
    NODE_TYPES,
    NodeInput,
    QueryInput,
    QueryIntent,
)
from hcrag_tpu_torch.pipeline.isrelevant import (
    batch_entity_match,
    batch_llm_judge,
    batch_node_type_priority,
    batch_semantic_similarity,
)


class RelevanceMetric(abc.ABC):
    """One scoring dimension over a (query, node batch)."""

    name: str = "metric"

    @abc.abstractmethod
    def score_batch(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> List[float]:
        ...


class SemanticSimilarityMetric(RelevanceMetric):
    name = "semantic_similarity"

    def __init__(self, device=None):
        self.device = device

    def score_batch(self, query, nodes):
        return batch_semantic_similarity(query, list(nodes), device=self.device)


class LLMJudgeMetric(RelevanceMetric):
    name = "llm_judge"

    def __init__(self, client=None):
        self.client = client

    def score_batch(self, query, nodes):
        return batch_llm_judge(query, list(nodes), self.client)


class EntityMatchMetric(RelevanceMetric):
    name = "entity_match"

    def __init__(self, device=None):
        self.device = device

    def score_batch(self, query, nodes):
        return batch_entity_match(query, list(nodes), device=self.device)


class NodeTypePriorityMetric(RelevanceMetric):
    name = "node_type_priority"

    def __init__(self, device=None):
        self.device = device

    def score_batch(self, query, nodes):
        return batch_node_type_priority(query, list(nodes), device=self.device)


class GraphCentralityMetric(RelevanceMetric):
    """Degree centrality min(degree/50, 1), blended 50/50 with the mean
    relationship weight when the node carries one (relevance_scorer.py:241-269).

    Degree resolution order mirrors the reference's `graph_relations`
    contract: explicit `incoming`/`outgoing` lists are summed
    (relevance_scorer.py:249-252); a scalar `degree` or a `neighbors` list
    are accepted as the vectorized pipeline's equivalents.  When a
    `relationship_weights` dict is present and non-empty, the final score is
    `(degree_score + mean(weights)) / 2` (relevance_scorer.py:260-264)."""

    name = "graph_centrality"

    def __init__(self, scale: float = 50.0):
        self.scale = scale

    def score_batch(self, query, nodes):
        out = []
        for node in nodes:
            rel = node.graph_relations
            if "incoming" in rel or "outgoing" in rel:
                degree = len(rel.get("incoming", [])) + len(
                    rel.get("outgoing", [])
                )
            else:
                degree = rel.get("degree")
                if degree is None:
                    degree = len(rel.get("neighbors", []))
            score = min(float(degree) / self.scale, 1.0)
            weights = rel.get("relationship_weights", {})
            if weights:
                weighted = sum(weights.values()) / len(weights)
                score = (score + weighted) / 2.0
            out.append(score)
        return out


def v0_content_boost(content_length: int, content_quality: float) -> float:
    """The v0 semantic scorer's content-quality boost
    (relevance_scorer_design.py:136-148): x1.1 for substantial content
    (length > 100), x1.15 for high-quality content (quality > 0.8);
    multiplicative, applied to the base similarity, final score capped at
    1.0 by the caller."""
    boost = 1.0
    if content_length > 100:
        boost *= 1.1
    if content_quality > 0.8:
        boost *= 1.15
    return boost


class V0SemanticSimilarityMetric(RelevanceMetric):
    """v0's SemanticSimilarityScorer.score
    (relevance_scorer_design.py:115-148): base similarity = the node's
    precomputed `score` when > 0, else a fresh non-negative dot product;
    then the content boosts of `v0_content_boost`, capped at 1.0.

    `content_length` defaults to len(node.text); `content_quality` is read
    from `graph_relations["content_quality"]` (the NodeContext field's home
    in the vectorized pipeline, default 0.0 = no boost).

    Note: the v0 fresh path is a RAW dot product (:129), not the canonical
    metric's cosine — embeddings are assumed pre-normalized upstream."""

    name = "semantic_similarity"

    def score_batch(self, query, nodes):
        nodes = list(nodes)
        q = np.asarray(query.embeddings, dtype=np.float32)
        fresh = np.stack(
            [np.asarray(n.embeddings, np.float32) for n in nodes]
        ) @ q
        out = []
        for i, node in enumerate(nodes):
            base = node.score if node.score > 0 else max(0.0, float(fresh[i]))
            rel = node.graph_relations
            length = int(rel.get("content_length", len(node.text)))
            quality = float(rel.get("content_quality", 0.0))
            out.append(min(1.0, base * v0_content_boost(length, quality)))
        return out


#: v1 default weights (relevance_scorer.py:338-344).
V1_COMPOSITE_WEIGHTS: Dict[str, float] = {
    "semantic_similarity": 0.3,
    "llm_judge": 0.25,
    "entity_match": 0.2,
    "node_type_priority": 0.15,
    "graph_centrality": 0.1,
}


# ---------------------------------------------------------------------------
# v0 dynamic per-(intent, node-type) weights (relevance_scorer_design.py)
# ---------------------------------------------------------------------------


class DesignQueryIntent(enum.Enum):
    """The v0 prototype's intent taxonomy (relevance_scorer_design.py:22-29).

    Differs from the canonical `QueryIntent`: v0 splits COMPATIBILITY out of
    comparison and calls technical support TROUBLESHOOTING."""

    PRODUCT_SEARCH = "product_search"
    DOCUMENT_REQUEST = "document_request"
    COMPARISON = "comparison"
    COMPATIBILITY = "compatibility"
    TROUBLESHOOTING = "troubleshooting"
    SPECIFICATION = "specification"


class DesignNodeType(enum.Enum):
    """The v0 prototype's node taxonomy (relevance_scorer_design.py:32-39)."""

    PRODUCT = "product"
    DOCUMENT = "document"
    CATEGORY = "category"
    JSON_TABLE = "json_table"
    PDF_CHUNK = "pdf_chunk"
    ANNOTATION = "annotation"


DESIGN_INTENT_ORDER: List[DesignQueryIntent] = list(DesignQueryIntent)
#: Node-type axis order; index len(DesignNodeType) (== 6) is the catch-all
#: "unknown" column (no type-conditional bumps apply, matching get_weight's
#: fallthrough to the base weight for types outside the rules).
DESIGN_TYPE_ORDER: List[DesignNodeType] = list(DesignNodeType)
DESIGN_UNKNOWN_TYPE = len(DESIGN_TYPE_ORDER)

#: Component axis order == the v0 `RelevanceScorer.components` dict order
#: (relevance_scorer_design.py:514-520).
V0_COMPONENT_ORDER: List[str] = [
    "semantic_similarity",
    "llm_judge",
    "entity_match",
    "graph_centrality",
    "data_type_priority",
]

#: Canonical intent -> v0 intent (the two taxonomies' common semantics).
_CANONICAL_TO_DESIGN_INTENT: Dict[QueryIntent, DesignQueryIntent] = {
    QueryIntent.PRODUCT_SEARCH: DesignQueryIntent.PRODUCT_SEARCH,
    QueryIntent.DOCUMENT_REQUEST: DesignQueryIntent.DOCUMENT_REQUEST,
    QueryIntent.TECHNICAL_SUPPORT: DesignQueryIntent.TROUBLESHOOTING,
    QueryIntent.COMPARISON_REQUEST: DesignQueryIntent.COMPARISON,
    QueryIntent.SPECIFICATION_INQUIRY: DesignQueryIntent.SPECIFICATION,
}

#: Canonical NODE_TYPES string -> v0 node type (None = no v0 analogue, maps
#: to the unknown column).
_CANONICAL_TO_DESIGN_TYPE: Dict[str, Optional[DesignNodeType]] = {
    "product": DesignNodeType.PRODUCT,
    "category": DesignNodeType.CATEGORY,
    "specification": DesignNodeType.JSON_TABLE,
    "document": DesignNodeType.DOCUMENT,
    "annotation": DesignNodeType.ANNOTATION,
    "unknown": None,
}


def v0_component_weight(
    component: str,
    intent: DesignQueryIntent,
    node_type: Optional[DesignNodeType],
) -> float:
    """The v0 per-component `get_weight` rules, transcribed number-for-number
    (relevance_scorer_design.py:151-163, 257-265, 374-385, 419-427, 500-502).
    `node_type=None` means a type outside the v0 taxonomy — only the
    intent-conditional bumps apply (the reference's rule fallthrough)."""
    I, T = DesignQueryIntent, DesignNodeType
    if component == "semantic_similarity":
        if intent == I.DOCUMENT_REQUEST:
            return 0.3 + 0.1
        if node_type in (T.PDF_CHUNK, T.ANNOTATION):
            return 0.3 + 0.05
        return 0.3
    if component == "llm_judge":
        if intent in (I.COMPARISON, I.TROUBLESHOOTING):
            return 0.25 + 0.1
        return 0.25
    if component == "entity_match":
        if intent == I.PRODUCT_SEARCH and node_type == T.PRODUCT:
            return 0.2 + 0.15
        if intent == I.DOCUMENT_REQUEST and node_type in (
            T.DOCUMENT, T.PDF_CHUNK,
        ):
            return 0.2 + 0.1
        return 0.2
    if component == "graph_centrality":
        if intent in (I.COMPATIBILITY, I.COMPARISON):
            return 0.15 + 0.05
        return 0.15
    if component == "data_type_priority":
        return 0.1
    raise KeyError(component)


def v0_weight_tensor() -> np.ndarray:
    """Materialize the v0 get_weight rules as a dense
    [5 components, 6 intents, 7 node types] tensor (last type column =
    unknown).  One gather per (intent, type) replaces the reference's
    per-node Python dispatch — the tensor form of the same rules."""
    w = np.zeros(
        (len(V0_COMPONENT_ORDER), len(DESIGN_INTENT_ORDER),
         len(DESIGN_TYPE_ORDER) + 1),
        dtype=np.float32,
    )
    for ci, comp in enumerate(V0_COMPONENT_ORDER):
        for ii, intent in enumerate(DESIGN_INTENT_ORDER):
            for ti, ntype in enumerate(DESIGN_TYPE_ORDER):
                w[ci, ii, ti] = v0_component_weight(comp, intent, ntype)
            w[ci, ii, DESIGN_UNKNOWN_TYPE] = v0_component_weight(
                comp, intent, None
            )
    return w


def canonical_dynamic_weight_tensor() -> np.ndarray:
    """The v0 dynamic weights projected onto the CANONICAL fused-reduction
    axes — [4 metrics (sem, llm, ent, typ), NUM_INTENTS, NUM_NODE_TYPES] —
    for `QueryEngine.query_batch(dynamic_weight_tensor=...)`.

    Metric mapping: the fused step's four metric columns correspond to v0's
    semantic_similarity / llm_judge / entity_match / data_type_priority
    components; v0's graph_centrality has no fused column (it was dropped
    from the canonical isRelevant) and is carried only by the host-side
    `DynamicWeightScorer`.  Intents/types map via the documented taxonomy
    correspondences."""
    from hcrag_tpu_torch.core.types import INTENT_ORDER, NODE_TYPES

    comps = ["semantic_similarity", "llm_judge", "entity_match",
             "data_type_priority"]
    w = np.zeros(
        (4, len(INTENT_ORDER), len(NODE_TYPES)), dtype=np.float32
    )
    for ci, comp in enumerate(comps):
        for ii, intent in enumerate(INTENT_ORDER):
            v0_intent = _CANONICAL_TO_DESIGN_INTENT[intent]
            for ti, tname in enumerate(NODE_TYPES):
                v0_type = _CANONICAL_TO_DESIGN_TYPE[tname]
                w[ci, ii, ti] = v0_component_weight(comp, v0_intent, v0_type)
    return w


class DynamicWeightScorer:
    """v0's `RelevanceScorer` combiner: per-(intent, node-type) component
    weights, weighted-AVERAGE combination, and a score-consistency
    confidence (relevance_scorer_design.py:509-595).

    Component scores come from the maintained vectorized metrics (the same
    ones `CompositeScorer` uses) rather than the prototype's per-node
    heuristics — the v0-specific surface this class preserves is the
    DYNAMIC WEIGHT dispatch and the combination math.
    """

    def __init__(self, metrics: Optional[Sequence[RelevanceMetric]] = None, *,
                 device=None):
        self.metrics = list(metrics) if metrics is not None else [
            SemanticSimilarityMetric(device),
            LLMJudgeMetric(),
            EntityMatchMetric(device),
            GraphCentralityMetric(),
            NodeTypePriorityMetric(device),
        ]
        self._weight_tensor = v0_weight_tensor()
        # metric name -> v0 component row of the tensor
        self._name_to_row = {
            "semantic_similarity": 0,
            "llm_judge": 1,
            "entity_match": 2,
            "graph_centrality": 3,
            "node_type_priority": 4,  # == v0 data_type_priority
            "data_type_priority": 4,
        }

    @staticmethod
    def _design_intent(query: QueryInput) -> DesignQueryIntent:
        if isinstance(query.intent, DesignQueryIntent):
            return query.intent
        return _CANONICAL_TO_DESIGN_INTENT.get(
            query.intent, DesignQueryIntent.PRODUCT_SEARCH
        )

    @staticmethod
    def _type_col(node: NodeInput) -> int:
        t = node.node_type.strip().lower()
        for ti, ntype in enumerate(DESIGN_TYPE_ORDER):
            if ntype.value == t:
                return ti
        mapped = _CANONICAL_TO_DESIGN_TYPE.get(t)
        if mapped is not None:
            return DESIGN_TYPE_ORDER.index(mapped)
        return DESIGN_UNKNOWN_TYPE

    def node_weights(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> np.ndarray:
        """[len(nodes), n_metrics] per-node component weights."""
        ii = DESIGN_INTENT_ORDER.index(self._design_intent(query))
        cols = np.array([self._type_col(n) for n in nodes], dtype=np.int32)
        rows = np.array(
            [self._name_to_row[m.name] for m in self.metrics], dtype=np.int32
        )
        return self._weight_tensor[rows[:, None], ii, cols[None, :]].T

    def score_batch(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> List[float]:
        if not nodes:
            return []
        w = self.node_weights(query, nodes)  # [N, M]
        s = np.stack(
            [np.asarray(m.score_batch(query, list(nodes)), dtype=np.float64)
             for m in self.metrics],
            axis=1,
        )  # [N, M]
        total = np.maximum(w.sum(axis=1), 1e-12)
        return [float(x) for x in (w * s).sum(axis=1) / total]

    def explain(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> List[Dict[str, float]]:
        """Per-node breakdown incl. the v0 confidence
        (1 - std of component scores, clipped to [0, 1] —
        relevance_scorer_design.py:584-589)."""
        if not nodes:
            return []
        w = self.node_weights(query, nodes)
        per_metric = {
            m.name: np.asarray(m.score_batch(query, list(nodes)))
            for m in self.metrics
        }
        s = np.stack([per_metric[m.name] for m in self.metrics], axis=1)
        total = np.maximum(w.sum(axis=1), 1e-12)
        combined = (w * s).sum(axis=1) / total
        if s.shape[1] <= 1:
            # v0 reports a fixed moderate confidence with a single component
            # (relevance_scorer_design.py:585-590), not 1 - std == 1.0.
            conf = np.full(s.shape[0], 0.5)
        else:
            conf = np.clip(1.0 - np.std(s, axis=1), 0.0, 1.0)
        out = []
        for i in range(len(nodes)):
            row = {name: float(v[i]) for name, v in per_metric.items()}
            row.update(
                {f"weight_{m.name}": float(w[i, j])
                 for j, m in enumerate(self.metrics)}
            )
            row["composite"] = float(combined[i])
            row["confidence"] = float(conf[i])
            out.append(row)
        return out


class CompositeScorer:
    """Weighted combination of arbitrary metrics."""

    def __init__(
        self,
        metrics: Optional[Sequence[RelevanceMetric]] = None,
        weights: Optional[Dict[str, float]] = None,
        *,
        device=None,
    ):
        self.metrics = list(metrics) if metrics is not None else [
            SemanticSimilarityMetric(device),
            LLMJudgeMetric(),
            EntityMatchMetric(device),
            NodeTypePriorityMetric(device),
            GraphCentralityMetric(),
        ]
        self.weights = dict(weights or V1_COMPOSITE_WEIGHTS)
        total = sum(self.weights.get(m.name, 0.0) for m in self.metrics)
        if abs(total - 1.0) > 0.001:
            raise ValueError(f"Metric weights must sum to 1.0, got {total}")

    def score_batch(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> List[float]:
        if not nodes:
            return []
        acc = np.zeros(len(nodes), dtype=np.float64)
        for metric in self.metrics:
            w = self.weights.get(metric.name, 0.0)
            if w == 0.0:
                continue
            acc += w * np.asarray(metric.score_batch(query, nodes))
        return [float(x) for x in acc]

    def explain(
        self, query: QueryInput, nodes: Sequence[NodeInput]
    ) -> List[Dict[str, float]]:
        """Per-node metric breakdown (the v0 design's reasoning traces,
        relevance_scorer_design.py)."""
        per_metric = {
            m.name: m.score_batch(query, list(nodes)) for m in self.metrics
        }
        out = []
        for i in range(len(nodes)):
            row = {name: scores[i] for name, scores in per_metric.items()}
            row["composite"] = sum(
                self.weights.get(name, 0.0) * row[name] for name in per_metric
            )
            out.append(row)
        return out
