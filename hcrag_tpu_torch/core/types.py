"""Core types of the engine: intents, scorer strategies, weights and the
static tables the query step gathers from.

Counterpart of `hcrag_tpu/core/types.py` (the names the query step and its
host API read).  Everything here is plain Python and numpy; the engine uploads the
tables it needs to its device once.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

import numpy as np


class QueryIntent(enum.Enum):
    """User query intent classes."""

    PRODUCT_SEARCH = "product_search"
    DOCUMENT_REQUEST = "document_request"
    TECHNICAL_SUPPORT = "technical_support"
    COMPARISON_REQUEST = "comparison_request"
    SPECIFICATION_INQUIRY = "specification_inquiry"

    @property
    def index(self) -> int:
        return INTENT_ORDER.index(self)

    @classmethod
    def from_string(cls, s: str) -> "QueryIntent":
        """The intent named `s` (case and surrounding space ignored);
        PRODUCT_SEARCH for a name that is not an intent."""
        s = s.strip().lower()
        for intent in cls:
            if intent.value == s:
                return intent
        return cls.PRODUCT_SEARCH


INTENT_ORDER: List[QueryIntent] = [
    QueryIntent.PRODUCT_SEARCH,
    QueryIntent.DOCUMENT_REQUEST,
    QueryIntent.TECHNICAL_SUPPORT,
    QueryIntent.COMPARISON_REQUEST,
    QueryIntent.SPECIFICATION_INQUIRY,
]

NUM_INTENTS = len(INTENT_ORDER)


class ScorerType(enum.Enum):
    """Relevance scoring strategy."""

    COMPOSITE = "composite"
    PARALLEL = "parallel"
    ROUTER = "router"
    ROUTER_ALL = "router_all"
    ROUTER_TWO_SEM_LLM = "router_two_sem_llm"
    ROUTER_TWO_ENT_TYPE = "router_two_ent_type"
    ROUTER_SINGLE_SEM = "router_single_sem"
    ROUTER_SINGLE_LLM = "router_single_llm"
    ROUTER_SINGLE_ENT = "router_single_ent"
    ROUTER_SINGLE_TYPE = "router_single_type"


#: Canonical node-type order of every device-side table; ``unknown`` is the
#: catch-all bucket.
NODE_TYPES: List[str] = [
    "product",
    "category",
    "specification",
    "document",
    "annotation",
    "unknown",
]

NUM_NODE_TYPES = len(NODE_TYPES)
UNKNOWN_TYPE_ID = NODE_TYPES.index("unknown")

_NODE_TYPE_TO_ID: Dict[str, int] = {t: i for i, t in enumerate(NODE_TYPES)}


def node_type_id(node_type: str) -> int:
    """Map a free-form node-type string onto the canonical table index;
    unlisted types collapse to ``unknown``."""
    return _NODE_TYPE_TO_ID.get(node_type.strip().lower(), UNKNOWN_TYPE_ID)


#: The intent x node-type priority matrix, row order = ``INTENT_ORDER``,
#: column order = ``NODE_TYPES``.
PRIORITY_MATRIX: np.ndarray = np.array(
    [
        #  product category spec  document annotation unknown
        [1.0, 0.8, 0.6, 0.3, 0.2, 0.1],  # PRODUCT_SEARCH
        [0.4, 0.2, 0.7, 1.0, 0.6, 0.1],  # DOCUMENT_REQUEST
        [0.6, 0.3, 0.9, 1.0, 0.7, 0.1],  # TECHNICAL_SUPPORT
        [1.0, 0.6, 0.8, 0.4, 0.3, 0.1],  # COMPARISON_REQUEST
        [0.7, 0.3, 1.0, 0.5, 0.6, 0.1],  # SPECIFICATION_INQUIRY
    ],
    dtype=np.float32,
)


@dataclasses.dataclass
class CompositeWeights:
    """Weights of the COMPOSITE scorer: they sum to 1 (+-0.001) and none is
    negative."""

    semantic_similarity: float = 0.3
    llm_judge: float = 0.45
    entity_match: float = 0.15
    node_type_priority: float = 0.10

    def __post_init__(self) -> None:
        total = (
            self.semantic_similarity
            + self.llm_judge
            + self.entity_match
            + self.node_type_priority
        )
        if abs(total - 1.0) > 0.001:
            raise ValueError(f"Weights must sum to 1.0, got {total}")
        for field_name in (
            "semantic_similarity",
            "llm_judge",
            "entity_match",
            "node_type_priority",
        ):
            weight = getattr(self, field_name)
            if weight < 0:
                raise ValueError(
                    f"Weight {field_name} must be non-negative, got {weight}"
                )

    @classmethod
    def create_balanced(cls) -> "CompositeWeights":
        return cls(0.25, 0.25, 0.25, 0.25)

    @classmethod
    def create_semantic_focused(cls) -> "CompositeWeights":
        return cls(0.6, 0.2, 0.1, 0.1)

    @classmethod
    def create_llm_focused(cls) -> "CompositeWeights":
        return cls(0.2, 0.6, 0.1, 0.1)

    @classmethod
    def create_entity_focused(cls) -> "CompositeWeights":
        return cls(0.2, 0.2, 0.4, 0.2)

    @classmethod
    def from_dict(cls, weights: Dict[str, float]) -> "CompositeWeights":
        """Weights by field name; a missing name keeps its default."""
        return cls(
            semantic_similarity=weights.get("semantic_similarity", 0.3),
            llm_judge=weights.get("llm_judge", 0.45),
            entity_match=weights.get("entity_match", 0.15),
            node_type_priority=weights.get("node_type_priority", 0.10),
        )

    def to_dict(self) -> Dict[str, float]:
        return {
            "semantic_similarity": self.semantic_similarity,
            "llm_judge": self.llm_judge,
            "entity_match": self.entity_match,
            "node_type_priority": self.node_type_priority,
        }

    def as_array(self) -> np.ndarray:
        """Metric order: [semantic, llm, entity, type]."""
        return np.array(
            [
                self.semantic_similarity,
                self.llm_judge,
                self.entity_match,
                self.node_type_priority,
            ],
            dtype=np.float32,
        )


DEFAULT_COMPOSITE_WEIGHTS = CompositeWeights()

#: Metric column order of every fused-scoring array: semantic similarity,
#: llm judge, entity match, node-type priority.
METRIC_ORDER = ("semantic", "llm", "entity", "type")
NUM_METRICS = len(METRIC_ORDER)

# Reduction modes of the fused scorer.
REDUCE_WEIGHTED_SUM = 0
REDUCE_MAX = 1


def scorer_spec(
    scorer_type: ScorerType,
    weights: Optional[CompositeWeights] = None,
) -> tuple[np.ndarray, int]:
    """Reduce every scorer strategy to a (weights[4] float32, reduction)
    pair: a weighted sum over the 4-metric vector, or its maximum
    (PARALLEL)."""
    w = (weights or DEFAULT_COMPOSITE_WEIGHTS).as_array()
    if scorer_type == ScorerType.COMPOSITE:
        return w, REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.PARALLEL:
        return np.ones(4, np.float32), REDUCE_MAX
    if scorer_type == ScorerType.ROUTER:
        return np.array([1, 1, 0, 1], np.float32) / 3.0, REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_ALL:
        return np.full(4, 0.25, np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_TWO_SEM_LLM:
        return np.array([0.5, 0.5, 0, 0], np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_TWO_ENT_TYPE:
        return np.array([0, 0, 0.5, 0.5], np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_SINGLE_SEM:
        return np.array([1, 0, 0, 0], np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_SINGLE_LLM:
        return np.array([0, 1, 0, 0], np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_SINGLE_ENT:
        return np.array([0, 0, 1, 0], np.float32), REDUCE_WEIGHTED_SUM
    if scorer_type == ScorerType.ROUTER_SINGLE_TYPE:
        return np.array([0, 0, 0, 1], np.float32), REDUCE_WEIGHTED_SUM
    return w, REDUCE_WEIGHTED_SUM


def scorer_needs_llm(scorer_type: ScorerType) -> bool:
    """Whether a strategy reads the (host-computed) LLM-judge column; the
    others score it as 0.0."""
    return scorer_type in {
        ScorerType.COMPOSITE,
        ScorerType.PARALLEL,
        ScorerType.ROUTER,
        ScorerType.ROUTER_ALL,
        ScorerType.ROUTER_TWO_SEM_LLM,
        ScorerType.ROUTER_SINGLE_LLM,
    }


#: Edge-type vocabulary of the AdventureWorks property graph.
EDGE_TYPES: List[str] = [
    "SAME_CATEGORY",
    "SAME_MODEL",
    "SIMILAR_PRICE",
    "COMPATIBLE_PRODUCT",
    "COMPLEMENTARY_PRODUCT",
    "DESCRIBED_BY",
    "ANNOTATION",
]

_EDGE_TYPE_TO_ID = {t: i for i, t in enumerate(EDGE_TYPES)}


def edge_type_id(name: str) -> int:
    return _EDGE_TYPE_TO_ID[name]


#: Relationship whitelist followed by subgraph expansion.
EXPANSION_EDGE_TYPES = ("ANNOTATION", "DESCRIBED_BY")


def edge_type_mask(names: Sequence[str]) -> int:
    """Bitmask over EDGE_TYPES of the named types."""
    mask = 0
    for n in names:
        mask |= 1 << edge_type_id(n)
    return mask


@dataclasses.dataclass
class QueryInput:
    """A structured query: text, embedding, entities and intent."""

    text: str
    embeddings: np.ndarray
    entities: List[str]
    intent: QueryIntent


@dataclasses.dataclass
class NodeInput:
    """A structured node: text, embedding, graph relations, node type and
    entities."""

    text: str
    embeddings: np.ndarray
    graph_relations: Dict
    node_type: str
    entities: List[str]
    score: float = 0.0
