"""The fused scoring kernel (B6) against the plain route over candidate banks.

    python -m hcrag_tpu_torch.benchmarks.scoring_ablation                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.scoring_ablation --device cpu   # a small size

Counterpart of `benchmarks/scoring_ablation.py`, over the same data (numpy
`default_rng(3)`, drawn in the JAX script's order for each bank: B=256
normalized queries of D=384, N normalized node rows, W=8 random 31-bit
entity words on each side with their popcounts, intents in [0, 5), node
types in [0, 6); weights (0.3, 0.45, 0.15, 0.10)), at N = 128, 1,024 and
8,192.  It prints, under the JAX keys, for each N:

  jnp_ms          the plain route: the metric stack of `ops/scoring.py`
                  (semantic, entity bitset match, intent x type priority,
                  a zero judge column) and the weighted sum, in PyTorch —
                  the counterpart of the JAX script's `jnp_path`;
  pallas_ms       kernel B6 (`ops/scoring_cuda.batch_relevance`), the
                  counterpart of `pallas_batch_relevance`;
  pallas_speedup  jnp_ms / pallas_ms;

each the mean of 30 calls between CUDA events, as the JAX script times 30
calls; and `pallas_graph_ms`, B6's device time from a CUDA-graph replay
(`utils.timing.graph_ms`), which leaves out the host's cost of issuing a
launch of a few microseconds.  On the CPU the host clock times plain
versions.  Nothing is written but `--out`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Sequence, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import device_name, device_of, finish, log, ms, parser
from hcrag_tpu_torch.core.types import PRIORITY_MATRIX
from hcrag_tpu_torch.ops import scoring_cuda as sc
from hcrag_tpu_torch.ops.scoring import (
    node_type_priority_scores,
    popcount_words,
    semantic_similarity_scores,
)
from hcrag_tpu_torch.utils.timing import graph_ms

B, D, W = 256, 384, 8
WEIGHTS = (0.3, 0.45, 0.15, 0.10)
NODES = (128, 1024, 8192)
CPU_SIZE = dict(nodes=(128, 1024), b=16, d=64)


def _popcounts(bits: np.ndarray) -> np.ndarray:
    return np.asarray([bin(int.from_bytes(row.tobytes(), "little")).count("1")
                       for row in bits], np.int32)


def draw(rng: np.random.Generator, n_nodes: int, b: int = B, d: int = D) -> Dict[str, np.ndarray]:
    """One bank's inputs, drawn in the JAX script's order."""
    q_emb = rng.standard_normal((b, d)).astype(np.float32)
    q_emb /= np.linalg.norm(q_emb, axis=1, keepdims=True)
    n_emb = rng.standard_normal((n_nodes, d)).astype(np.float32)
    n_emb /= np.linalg.norm(n_emb, axis=1, keepdims=True)
    q_bits = rng.integers(0, 2**31, (b, W)).astype(np.uint32)
    n_bits = rng.integers(0, 2**31, (n_nodes, W)).astype(np.uint32)
    return dict(q_emb=q_emb, q_bits=q_bits, q_counts=_popcounts(q_bits),
                intents=rng.integers(0, 5, b).astype(np.int32), n_emb=n_emb, n_bits=n_bits,
                n_counts=_popcounts(n_bits), n_types=rng.integers(0, 6, n_nodes).astype(np.int32))


def plain_route(q_emb, q_bits, q_counts, intents, n_emb, n_bits, n_counts, n_types, w):
    """The JAX script's `jnp_path` in PyTorch: [B, N] f32 scores."""
    sem = semantic_similarity_scores(q_emb, n_emb)
    inter = popcount_words(q_bits[:, None, :] & n_bits[None, :, :])
    ratio = inter.to(torch.float32) / torch.clamp(q_counts[:, None].to(torch.float32), min=1.0)
    ent = torch.where((q_counts == 0)[:, None],
                      torch.where((n_counts == 0)[None, :], 0.5, 0.1), ratio)
    typ = node_type_priority_scores(intents, n_types)
    metrics = torch.stack([sem, torch.zeros_like(sem), ent, typ], dim=-1)
    return torch.einsum("bnm,m->bn", metrics, w)


def variants(x: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, Callable]:
    """The two timed routes over one bank's inputs on `dev`."""
    t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v).to(dev)
         for k, v in x.items()}
    w = torch.tensor(WEIGHTS, dtype=torch.float32, device=dev)
    prio = torch.from_numpy(PRIORITY_MATRIX).to(dev)
    args = (t["q_emb"], t["q_bits"], t["q_counts"], t["intents"], t["n_emb"], t["n_bits"],
            t["n_counts"], t["n_types"])
    return {"jnp_ms": lambda: plain_route(*args, w),
            "pallas_ms": lambda: sc.batch_relevance(*args, w, prio)}


def run(device: Union[str, torch.device, None] = "cuda", nodes: Sequence[int] = NODES,
        b: int = B, d: int = D, steps: int = 30) -> Dict:
    dev = device_of(device)
    rng = np.random.default_rng(3)
    res: Dict = {}
    for n_nodes in nodes:
        calls = variants(draw(rng, n_nodes, b, d), dev)
        row = {key: ms(fn, dev, steps) for key, fn in calls.items()}
        row["pallas_speedup"] = row["jnp_ms"] / row["pallas_ms"]
        if dev.type == "cuda":
            row["pallas_graph_ms"] = graph_ms(calls["pallas_ms"], calls=10, replays=5)
        log(f"N={n_nodes}: plain route {row['jnp_ms']:.4f} ms, B6 {row['pallas_ms']:.4f} ms "
            f"({row['pallas_speedup']:.2f}x)")
        res[f"n{n_nodes}"] = row
    res["config"] = {"batch": b, "dim": d, "bitset_words": W}
    res["device"] = device_name(dev)
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
