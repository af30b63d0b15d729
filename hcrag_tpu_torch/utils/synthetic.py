"""Seeded synthetic index and graph for tests, the smoke run and benchmarks.

Counterpart of `hcrag_tpu/utils/synthetic.py` and of the synthetic set-up of
`__graft_entry__.py` (`synthetic_setup` here).  For the same arguments the
arrays are byte-equal to the JAX package's: both draw from numpy's
`default_rng` in the same order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hcrag_tpu_torch.core.dense_index import DenseIndex
from hcrag_tpu_torch.core.graph import CsrGraph
from hcrag_tpu_torch.core.types import edge_type_id
from hcrag_tpu_torch.core.vocab import EntityVocab


def synthetic_embeddings(
    n: int, dim: int = 384, seed: int = 0, dtype=np.float32,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """L2-normalized random embeddings, generated in chunks, into `out`
    ([n, dim] of `dtype`, e.g. a memory-mapped file) where given."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, dim), dtype=dtype) if out is None else out
    chunk = 1 << 16
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        block = rng.standard_normal((stop - start, dim)).astype(np.float32)
        block /= np.linalg.norm(block, axis=1, keepdims=True)
        out[start:stop] = block.astype(dtype)
    return out


def synthetic_ell(n: int, max_degree: int = 4, seed: int = 1) -> np.ndarray:
    """Random padded neighbor table [n, max_degree] (self-loops moved to
    the next node)."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, n, size=(n, max_degree), dtype=np.int64)
    rows = np.arange(n)[:, None]
    nbrs = np.where(nbrs == rows, (nbrs + 1) % n, nbrs)
    return nbrs.astype(np.int32)


def synthetic_bank(
    n: int,
    dim: int = 384,
    *,
    vocab_size: int = 128,
    entities_per_node: int = 3,
    seed: int = 0,
    dtype=np.float32,
    emb_out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(emb, type_ids, entity_bits, entity_counts) for a synthetic corpus;
    the rows are drawn into `emb_out` where given."""
    rng = np.random.default_rng(seed + 2)
    emb = synthetic_embeddings(n, dim, seed, dtype, out=emb_out)
    type_ids = rng.integers(0, 6, size=n).astype(np.int32)
    words = (vocab_size + 31) // 32
    bits = np.zeros((n, words), dtype=np.uint32)
    ent_ids = rng.integers(0, vocab_size, size=(n, entities_per_node))
    for j in range(entities_per_node):
        np.bitwise_or.at(
            bits,
            (np.arange(n), ent_ids[:, j] // 32),
            (np.uint32(1) << (ent_ids[:, j] % 32).astype(np.uint32)),
        )
    counts = np.sum(
        np.unpackbits(bits.view(np.uint8), axis=1), axis=1
    ).astype(np.int32)
    return emb, type_ids, bits, counts


def synthetic_dense_index(
    n: int, dim: int = 384, *, seed: int = 0, dtype=np.float32
) -> DenseIndex:
    """A DenseIndex over synthetic data (metadata and texts are light
    placeholders; the arrays carry the load)."""
    emb, type_ids, bits, counts = synthetic_bank(n, dim, seed=seed, dtype=dtype)
    metadata = [
        {"id": f"syn_{i}", "type": "database_table", "table_name": "Synthetic",
         "row_index": i}
        for i in range(n)
    ]
    texts = [f"synthetic row {i}" for i in range(n)]
    vocab = EntityVocab({f"e{i}": i for i in range(bits.shape[1] * 32)})
    return DenseIndex(
        emb=emb,
        type_ids=type_ids,
        entity_bits=bits,
        entity_counts=counts,
        graph_ids=np.arange(n, dtype=np.int32),
        metadata=metadata,
        texts=texts,
        vocab=vocab,
        generation_info={"synthetic": True, "n": n, "dim": dim},
    )


def synthetic_setup(
    n_rows: int, dim: int, graph_degree: int = 4
) -> Tuple[DenseIndex, CsrGraph]:
    """Synthetic index plus a random graph over the same ids, with edges of
    the two whitelisted expansion types."""
    index = synthetic_dense_index(n_rows, dim, seed=0)
    index.graph_ids = np.arange(n_rows, dtype=np.int32)
    return index, synthetic_graph(n_rows, graph_degree)


def synthetic_graph(n_rows: int, graph_degree: int = 4) -> CsrGraph:
    """`synthetic_setup`'s graph alone: `graph_degree` random edges out of
    each of `n_rows` Product nodes, DESCRIBED_BY or ANNOTATION at random,
    symmetrized; node i is row i."""
    rng = np.random.default_rng(3)
    src = np.repeat(np.arange(n_rows), graph_degree)
    dst = rng.integers(0, n_rows, size=n_rows * graph_degree)
    ety = rng.choice(
        [edge_type_id("DESCRIBED_BY"), edge_type_id("ANNOTATION")],
        size=n_rows * graph_degree,
    )
    return CsrGraph.from_edges(
        n_rows,
        src,
        dst,
        ety,
        node_labels=["Product"] * n_rows,
        node_keys=list(range(n_rows)),
        node_texts=[f"n{i}" for i in range(n_rows)],
        node_to_row=np.arange(n_rows, dtype=np.int32),
    )
