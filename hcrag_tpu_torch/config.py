"""Retrieval constants and the runtime configuration.

Counterpart of `hcrag_tpu/config.py`: the retrieval and pipeline defaults,
`RuntimeConfig` (scorer strategy, composite weights, sampling seed, LLM-judge
chunk size and the LLM endpoint), the process default `GLOBAL_CONFIG` and
the setter functions over it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hcrag_tpu_torch.core.types import CompositeWeights, ScorerType

# --- retrieval and pipeline defaults ---------------------------------------
DEFAULT_TOP_K = 5
DEFAULT_SIMILARITY_THRESHOLD = 0.3
SEMANTIC_GATE = 0.60  # the agent keeps sampled nodes scoring at least this
HIGH_RELEVANCE = 0.7  # one final node above it makes the context sufficient
FINAL_TOP_K = 15  # nodes the agent keeps after scoring
SAMPLE_LIMIT = 20  # nodes the agent samples from the graph
EXPANSION_DEPTH = 1
MAX_CONNECTED_NODES = 20
EXPANSION_NEIGHBOR_LIMIT = 3  # neighbors the agent follows per node
MAX_REVISIONS = 2
RECURSION_LIMIT = 15  # agent steps per run
COMBINED_RELEVANCE_WEIGHT = 0.7
COMBINED_SIMILARITY_WEIGHT = 0.3
MAX_CONTEXT_TOKENS = 2000
CONTEXT_TOKEN_RESERVE = 500
CHARS_PER_TOKEN = 4
MAX_QUERY_ENTITIES = 10
EMBED_DIM = 384  # all-MiniLM-L6-v2 output dim

#: Calibrated probability below which a distilled-encoder query embedding is
#: treated as off-domain (`models/confidence.py`): `QueryInterface` blends in
#: keyword retrieval and flags the result, the agent records the signal.
ENCODER_CONFIDENCE_THRESHOLD = 0.5


def _env(name: str):
    return lambda: os.environ.get(name, "")


@dataclasses.dataclass
class RuntimeConfig:
    """Mutable engine configuration: the scorer strategy and weights, the
    agent's sampling seed (None: unseeded), the LLM-judge chunk size, and
    the LLM endpoint, an OpenAI-compatible chat-completions server at
    `llm_base_url` (empty = offline, the default), read from the
    HCRAG_LLM_BASE_URL, HCRAG_LLM_API_KEY and HCRAG_LLM_MODEL variables
    when the object is made."""

    scorer_type: ScorerType = ScorerType.COMPOSITE
    composite_weights: CompositeWeights = dataclasses.field(
        default_factory=CompositeWeights
    )
    random_seed: Optional[int] = None
    batch_size: int = 10
    llm_base_url: str = dataclasses.field(default_factory=_env("HCRAG_LLM_BASE_URL"))
    llm_api_key: str = dataclasses.field(default_factory=_env("HCRAG_LLM_API_KEY"))
    llm_model: str = dataclasses.field(default_factory=_env("HCRAG_LLM_MODEL"))
    llm_timeout_s: float = 30.0

    def reset(self) -> None:
        """Every field back to a fresh object's value (the endpoint fields
        read from the environment again)."""
        fresh = RuntimeConfig()
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(fresh, f.name))


#: Process-default configuration, used when callers do not pass their own.
GLOBAL_CONFIG = RuntimeConfig()


def set_scorer_type(scorer_type: ScorerType) -> None:
    GLOBAL_CONFIG.scorer_type = scorer_type


def set_composite_weights(weights: CompositeWeights) -> None:
    GLOBAL_CONFIG.composite_weights = weights


def set_random_seed(seed: int) -> None:
    GLOBAL_CONFIG.random_seed = seed


def set_batch_size(batch_size: int = 10) -> None:
    GLOBAL_CONFIG.batch_size = batch_size


def reset_global_config() -> None:
    GLOBAL_CONFIG.reset()
