"""Retrieval constants and the runtime configuration.

Counterpart of the retrieval defaults, `RuntimeConfig`'s LLM endpoint fields
and `GLOBAL_CONFIG` in `hcrag_tpu/config.py`.
"""

from __future__ import annotations

import dataclasses
import os

DEFAULT_TOP_K = 5
DEFAULT_SIMILARITY_THRESHOLD = 0.3
EXPANSION_DEPTH = 1
MAX_CONNECTED_NODES = 20
COMBINED_RELEVANCE_WEIGHT = 0.7
COMBINED_SIMILARITY_WEIGHT = 0.3
EMBED_DIM = 384  # all-MiniLM-L6-v2 output dim


def _env(name: str):
    return lambda: os.environ.get(name, "")


@dataclasses.dataclass
class RuntimeConfig:
    """The LLM endpoint: an OpenAI-compatible chat-completions server at
    `llm_base_url` (empty = offline, the default), read from the
    HCRAG_LLM_BASE_URL, HCRAG_LLM_API_KEY and HCRAG_LLM_MODEL variables
    when the object is made."""

    llm_base_url: str = dataclasses.field(default_factory=_env("HCRAG_LLM_BASE_URL"))
    llm_api_key: str = dataclasses.field(default_factory=_env("HCRAG_LLM_API_KEY"))
    llm_model: str = dataclasses.field(default_factory=_env("HCRAG_LLM_MODEL"))
    llm_timeout_s: float = 30.0


#: Process-default configuration, used when callers do not pass their own.
GLOBAL_CONFIG = RuntimeConfig()
