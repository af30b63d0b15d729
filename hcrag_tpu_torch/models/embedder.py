"""Text embedders.

Counterpart of `TextEmbedder`, `HashingEmbedder`, `embedder_from_index`
and `default_embedder` in `hcrag_tpu/models/embedder.py`.  `fit` and
`encode` run the native C++ library (`native/fasthash.cpp`) where it
builds, else the Python path (`encode_one`), which computes the same
features.  `HashingEmbedder` is a deterministic feature-hashed bag of
words + bigrams, L2-normalized, with optional IDF weights.  An index built from MiniLM
vectors gets the distilled MiniLM encoder (`models/minilm.py`), on the
caller's device, so that query text embeds into the rows' space.
"""

from __future__ import annotations

import re
from typing import List, Optional, Protocol, Sequence

import numpy as np

from hcrag_tpu_torch.config import EMBED_DIM


class TextEmbedder(Protocol):
    """An embedder: `dim` and a batched `encode(texts) -> [N, dim]`."""

    dim: int

    def encode(self, texts: Sequence[str]) -> np.ndarray: ...


_TOKEN_RE = re.compile(r"[a-z0-9]+")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = (1 << 64) - 1


def _stable_hash(token: str) -> int:
    """Stable 64-bit FNV-1a hash (independent of the process's hash seed)."""
    h = _FNV_OFFSET
    for byte in token.encode("utf-8"):
        h = ((h ^ byte) * _FNV_PRIME) & _FNV_MASK
    return h


class HashingEmbedder:
    """Deterministic feature-hashing sentence embedder with optional IDF.

    Tokens and adjacent bigrams are hashed into `dim` buckets with a +-1 sign
    bit; vectors are L2-normalized.  `fit(corpus)` learns per-bucket document
    frequencies; encoding then weights each feature by idf = log(1 + N/df).
    """

    def __init__(self, dim: int = EMBED_DIM, use_bigrams: bool = True):
        self.dim = dim
        self.use_bigrams = use_bigrams
        self.bucket_df: Optional[np.ndarray] = None  # [dim] document freq
        self.n_docs: int = 0

    def _features(self, text: str) -> List[str]:
        tokens = _TOKEN_RE.findall(text.lower())
        feats = list(tokens)
        if self.use_bigrams:
            feats.extend(f"{a}_{b}" for a, b in zip(tokens, tokens[1:]))
        return feats

    def fit(self, corpus: Sequence[str]) -> "HashingEmbedder":
        from hcrag_tpu_torch import native

        df = native.bucket_df(corpus, self.dim, use_bigrams=self.use_bigrams)
        if df is None:  # the Python path
            df = np.zeros(self.dim, dtype=np.int64)
            for text in corpus:
                for b in {_stable_hash(f) % self.dim for f in self._features(text)}:
                    df[b] += 1
        self.bucket_df = df
        self.n_docs = len(corpus)
        return self

    def _idf(self, bucket: int) -> float:
        if self.bucket_df is None:
            return 1.0
        return float(np.log1p(self.n_docs / (1.0 + self.bucket_df[bucket])))

    def encode_one(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dim, dtype=np.float32)
        for feat in self._features(text):
            h = _stable_hash(feat)
            bucket = h % self.dim
            sign = 1.0 if (h >> 32) & 1 else -1.0
            vec[bucket] += sign * self._idf(bucket)
        norm = np.linalg.norm(vec)
        return vec / norm if norm > 0 else vec

    def _idf_weights(self) -> Optional[np.ndarray]:
        if self.bucket_df is None:
            return None
        return np.log1p(self.n_docs / (1.0 + self.bucket_df.astype(np.float64)))

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        from hcrag_tpu_torch import native

        out = native.embed_batch(
            texts, self.dim, use_bigrams=self.use_bigrams, idf=self._idf_weights()
        )
        if out is not None:
            return out
        return np.stack([self.encode_one(t) for t in texts], axis=0)

    # --- persistence (rides in DenseIndex.generation_info) ----------------
    def state_dict(self) -> dict:
        return {
            "type": "hashing",
            "dim": self.dim,
            "use_bigrams": self.use_bigrams,
            "n_docs": self.n_docs,
            "bucket_df": (
                self.bucket_df.tolist() if self.bucket_df is not None else None
            ),
        }

    @classmethod
    def from_state(cls, state: dict) -> "HashingEmbedder":
        emb = cls(dim=state["dim"], use_bigrams=state.get("use_bigrams", True))
        if state.get("bucket_df") is not None:
            emb.bucket_df = np.asarray(state["bucket_df"], dtype=np.int64)
            emb.n_docs = state.get("n_docs", 0)
        return emb


def embedder_from_index(index, device=None):
    """The embedder an index was built with: its persisted hashing state;
    for an index of MiniLM vectors (`generation_info["model_name"]`), the
    distilled MiniLM encoder on `device` (CUDA unless named) where its files
    exist and its width matches; else an unfitted hashing embedder."""
    state = index.generation_info.get("embedder_state")
    if state and state.get("type") == "hashing":
        return HashingEmbedder.from_state(state)
    if "minilm" in str(index.generation_info.get("model_name", "")).lower():
        from hcrag_tpu_torch.models.minilm import load_distilled_embedder

        distilled = load_distilled_embedder(device=device)
        if distilled is not None and distilled.dim == index.dim:
            return distilled
    return default_embedder(index.dim)


def default_embedder(dim: int = EMBED_DIM) -> TextEmbedder:
    """The default embedder: the hashing embedder."""
    return HashingEmbedder(dim=dim)
