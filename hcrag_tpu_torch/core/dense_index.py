"""DenseIndex — the embedding index as host arrays.

Counterpart of `hcrag_tpu/core/dense_index.py` (its fields, `n`, `dim`,
`type_mask` and `build`).  A struct of arrays that the engine uploads:

  * ``emb``           [N, D]  — L2-normalized embeddings (float32)
  * ``type_ids``      [N]     — canonical node-type id (NODE_TYPES)
  * ``entity_bits``   [N, W]  — multi-hot entity bitsets (uint32 words)
  * ``entity_counts`` [N]     — popcounts of entity_bits
  * ``graph_ids``     [N]     — linked property-graph node (-1 = none)

``metadata``, ``texts`` and the entity vocabulary stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from hcrag_tpu_torch.core.types import node_type_id
from hcrag_tpu_torch.core.vocab import EntityVocab
from hcrag_tpu_torch.ingest.entities import (
    extract_entities_from_content,
    metadata_node_type,
)


def _normalize_rows(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


@dataclasses.dataclass
class DenseIndex:
    """Struct-of-arrays dense retrieval index."""

    emb: np.ndarray  # [N, D] float32, L2-normalized
    type_ids: np.ndarray  # [N] int32
    entity_bits: np.ndarray  # [N, W] uint32
    entity_counts: np.ndarray  # [N] int32
    graph_ids: np.ndarray  # [N] int32, -1 if unlinked
    metadata: List[dict]
    texts: List[str]
    vocab: EntityVocab
    generation_info: Dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.emb.shape[0])

    @property
    def dim(self) -> int:
        return int(self.emb.shape[1])

    def type_mask(self, content_type: str) -> np.ndarray:
        """Row mask for a metadata content type ('database_table',
        'json_table', 'pdf_document') — the category-search prefilter."""
        return np.array(
            [m.get("type") == content_type for m in self.metadata], dtype=bool
        )

    @classmethod
    def build(
        cls,
        embeddings: np.ndarray,
        metadata: Sequence[dict],
        texts: Sequence[str],
        *,
        graph_ids: Optional[np.ndarray] = None,
        entity_extractor: Callable[[str], List[str]] = extract_entities_from_content,
        vocab: Optional[EntityVocab] = None,
        dtype=np.float32,
        generation_info: Optional[Dict] = None,
    ) -> "DenseIndex":
        """Assemble an index from raw embeddings and per-row metadata and
        texts: node types come from the metadata, entities from the text via
        `entity_extractor`, and the vocabulary is the union over all rows
        unless one is given."""
        emb = np.asarray(embeddings, dtype=np.float32)
        if emb.ndim != 2:
            raise ValueError(f"embeddings must be [N, D], got {emb.shape}")
        n = emb.shape[0]
        if len(metadata) != n or len(texts) != n:
            raise ValueError("metadata and texts need one entry per row")

        entity_lists = [entity_extractor(t) for t in texts]
        if vocab is None:
            vocab = EntityVocab.build(entity_lists)
        bits, _ = vocab.encode_batch(entity_lists)
        counts = np.sum(
            np.unpackbits(bits.view(np.uint8), axis=1), axis=1
        ).astype(np.int32)

        type_ids = np.array(
            [node_type_id(metadata_node_type(m)) for m in metadata], dtype=np.int32
        )
        if graph_ids is None:
            graph_ids = np.full(n, -1, dtype=np.int32)

        return cls(
            emb=_normalize_rows(emb).astype(dtype),
            type_ids=type_ids,
            entity_bits=bits,
            entity_counts=counts,
            graph_ids=np.asarray(graph_ids, dtype=np.int32),
            metadata=list(metadata),
            texts=list(texts),
            vocab=vocab,
            generation_info=dict(generation_info or {}),
        )
