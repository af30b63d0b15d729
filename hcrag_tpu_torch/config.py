"""Retrieval constants the query step and its host API read.

Counterpart of the retrieval defaults in `hcrag_tpu/config.py`.
"""

from __future__ import annotations

DEFAULT_TOP_K = 5
DEFAULT_SIMILARITY_THRESHOLD = 0.3
EXPANSION_DEPTH = 1
MAX_CONNECTED_NODES = 20
COMBINED_RELEVANCE_WEIGHT = 0.7
COMBINED_SIMILARITY_WEIGHT = 0.3
EMBED_DIM = 384  # all-MiniLM-L6-v2 output dim
