"""Entity vocabulary: free-string entity sets -> bitsets.

Counterpart of `hcrag_tpu/core/vocab.py`.  Exact set intersection on the
device needs a fixed vocabulary: every entity maps to a bit position and
every entity set to a multi-hot bitset of uint32 words.  Query entities not
in the vocabulary never match a node entity, but they still count toward
|query entities|, which the encoder reports as an out-of-vocabulary count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

WORD_BITS = 32


def _norm(entity: str) -> str:
    return entity.strip().lower()


@dataclasses.dataclass
class EntityVocab:
    """Entity -> bit mapping with bitset encoders."""

    entity_to_id: Dict[str, int]

    @classmethod
    def build(cls, entity_lists: Iterable[Sequence[str]]) -> "EntityVocab":
        seen: Dict[str, int] = {}
        for entities in entity_lists:
            for e in entities:
                e = _norm(e)
                if e and e not in seen:
                    seen[e] = len(seen)
        return cls(entity_to_id=seen)

    @property
    def size(self) -> int:
        return len(self.entity_to_id)

    @property
    def num_words(self) -> int:
        # At least one word so bitset arrays always have a trailing dim.
        return max(1, (self.size + WORD_BITS - 1) // WORD_BITS)

    def encode(self, entities: Sequence[str]) -> Tuple[np.ndarray, int]:
        """Encode one entity set -> (bits [num_words] uint32, oov_count),
        where oov_count is the number of distinct normalized entities that
        are not in the vocabulary."""
        bits = np.zeros(self.num_words, dtype=np.uint32)
        oov = 0
        seen = set()
        for e in entities:
            e = _norm(e)
            if not e or e in seen:
                continue
            seen.add(e)
            idx = self.entity_to_id.get(e)
            if idx is None:
                oov += 1
            else:
                bits[idx // WORD_BITS] |= np.uint32(1 << (idx % WORD_BITS))
        return bits, oov

    def encode_batch(
        self, entity_lists: Sequence[Sequence[str]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode many entity sets -> (bits [N, num_words], oov_counts [N])."""
        n = len(entity_lists)
        bits = np.zeros((n, self.num_words), dtype=np.uint32)
        oov = np.zeros(n, dtype=np.int32)
        for i, entities in enumerate(entity_lists):
            bits[i], oov[i] = self.encode(entities)
        return bits, oov

    def to_dict(self) -> Dict[str, int]:
        return dict(self.entity_to_id)

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "EntityVocab":
        return cls(entity_to_id={k: int(v) for k, v in d.items()})
