"""DenseIndex — the embedding index as host arrays.

Counterpart of `hcrag_tpu/core/dense_index.py`: its fields, constructors
(`build`, `from_reference_pickle`), persistence (`save` / `load`, the same
`dense_index.npz` + `index_meta.json` layout, so a directory written by
either package loads in the other), incremental updates (`append`,
`delete_rows`, `mask_where`) and `content_statistics`.  A struct of arrays
that the engine uploads:

  * ``emb``           [N, D]  — L2-normalized embeddings (float32)
  * ``type_ids``      [N]     — canonical node-type id (NODE_TYPES)
  * ``entity_bits``   [N, W]  — multi-hot entity bitsets (uint32 words)
  * ``entity_counts`` [N]     — popcounts of entity_bits
  * ``graph_ids``     [N]     — linked property-graph node (-1 = none)

``metadata``, ``texts`` and the entity vocabulary stay on the host.
"""

from __future__ import annotations

import dataclasses
import json
import pickle
from pathlib import Path
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

    def row_of_metadata(self, metadata: dict) -> int:
        """The row whose metadata has this metadata's "id" (the first such
        row; a map built at first use), or -1."""
        cache = getattr(self, "_row_by_meta_id", None)
        if cache is None:
            cache = {}
            for i, m in enumerate(self.metadata):
                key = m.get("id")
                if key is not None and key not in cache:
                    cache[key] = i
            self._row_by_meta_id = cache
        return cache.get(metadata.get("id"), -1)

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

    @classmethod
    def from_reference_pickle(
        cls, path, *, dtype=np.float32, graph_ids: Optional[np.ndarray] = None
    ) -> "DenseIndex":
        """An index from a pickle of {embeddings, metadata, texts,
        generation_info} (the layout of `knowledge_graph_embeddings.pkl`).
        Unpickling runs code the file names: read only files this program
        or a trusted tool wrote."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        return cls.build(
            np.asarray(data["embeddings"], dtype=np.float32),
            data["metadata"],
            data["texts"],
            dtype=dtype,
            graph_ids=graph_ids,
            generation_info=data.get("generation_info", {}),
        )

    def save(self, directory) -> None:
        """Write `dense_index.npz` (the arrays, emb as f32) and
        `index_meta.json` (metadata, texts, vocabulary, generation info and
        the emb dtype's name) into `directory`."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            directory / "dense_index.npz",
            emb=np.asarray(self.emb, dtype=np.float32),
            type_ids=self.type_ids,
            entity_bits=self.entity_bits,
            entity_counts=self.entity_counts,
            graph_ids=self.graph_ids,
        )
        with open(directory / "index_meta.json", "w") as f:
            json.dump(
                {
                    "metadata": self.metadata,
                    "texts": self.texts,
                    "vocab": self.vocab.to_dict(),
                    "generation_info": self.generation_info,
                    "dtype": str(np.dtype(np.asarray(self.emb).dtype)),
                },
                f,
            )

    @classmethod
    def load(cls, directory, dtype=np.float32) -> "DenseIndex":
        """The index `save` wrote into `directory`, emb cast to `dtype`."""
        directory = Path(directory)
        with np.load(directory / "dense_index.npz") as arrays:
            fields = {k: arrays[k] for k in arrays.files}
        with open(directory / "index_meta.json") as f:
            meta = json.load(f)
        return cls(
            emb=fields["emb"].astype(dtype),
            type_ids=fields["type_ids"],
            entity_bits=fields["entity_bits"],
            entity_counts=fields["entity_counts"],
            graph_ids=fields["graph_ids"],
            metadata=meta["metadata"],
            texts=meta["texts"],
            vocab=EntityVocab.from_dict(meta["vocab"]),
            generation_info=meta.get("generation_info", {}),
        )

    def append(
        self,
        embeddings: np.ndarray,
        metadata: Sequence[dict],
        texts: Sequence[str],
        *,
        graph_ids: Optional[np.ndarray] = None,
        entity_extractor: Callable[[str], List[str]] = extract_entities_from_content,
    ) -> "DenseIndex":
        """Append rows in place (host arrays), normalized and cast to the
        index's emb dtype.  Their entities must already be in the
        vocabulary (others never match, as out-of-vocabulary query entities
        do not).  `QueryEngine.refresh_index()` uploads the result."""
        emb = np.asarray(embeddings, dtype=np.float32)
        n_new = emb.shape[0]
        if len(metadata) != n_new or len(texts) != n_new:
            raise ValueError("metadata and texts need one entry per row")
        bits, _ = self.vocab.encode_batch([entity_extractor(t) for t in texts])
        counts = np.sum(
            np.unpackbits(bits.view(np.uint8), axis=1), axis=1
        ).astype(np.int32)
        type_ids = np.array(
            [node_type_id(metadata_node_type(m)) for m in metadata], dtype=np.int32
        )
        if graph_ids is None:
            graph_ids = np.full(n_new, -1, dtype=np.int32)

        own_dtype = np.asarray(self.emb).dtype
        self.emb = np.concatenate(
            [np.asarray(self.emb), _normalize_rows(emb).astype(own_dtype)]
        )
        self.type_ids = np.concatenate([self.type_ids, type_ids])
        self.entity_bits = np.concatenate([self.entity_bits, bits])
        self.entity_counts = np.concatenate([self.entity_counts, counts])
        self.graph_ids = np.concatenate(
            [self.graph_ids, np.asarray(graph_ids, dtype=np.int32)]
        )
        self.metadata.extend(metadata)
        self.texts.extend(texts)
        if hasattr(self, "_row_by_meta_id"):
            del self._row_by_meta_id  # the lookup map is rebuilt at next use
        return self

    def delete_rows(self, rows: Sequence[int]) -> np.ndarray:
        """A row mask [N] that excludes `rows`: the rows stay in the arrays;
        pass the mask to queries or AND it into a type mask."""
        mask = np.ones(self.n, dtype=bool)
        mask[np.asarray(list(rows), dtype=np.int64)] = False
        return mask

    def mask_where(self, predicate: Callable[[dict], bool]) -> np.ndarray:
        """The row mask [N] of the rows whose metadata meets `predicate`."""
        return np.array([bool(predicate(m)) for m in self.metadata], dtype=bool)

    def content_statistics(self) -> Dict:
        """Row count, width, rows per content type and, for database rows,
        per table."""
        stats: Dict = {
            "total_entries": self.n,
            "embedding_dimensions": self.dim,
            "content_types": {},
            "database_tables": {},
        }
        for meta in self.metadata:
            t = meta.get("type", "unknown")
            stats["content_types"][t] = stats["content_types"].get(t, 0) + 1
            if t == "database_table":
                tab = meta.get("table_name", "unknown")
                stats["database_tables"][tab] = (
                    stats["database_tables"].get(tab, 0) + 1
                )
        return stats
