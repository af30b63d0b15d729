"""The expansion-heavy step (top-100, depth 3) and its stages.

    python -m hcrag_tpu_torch.benchmarks.expansion_heavy                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.expansion_heavy --batch 64    # another batch
    python -m hcrag_tpu_torch.benchmarks.expansion_heavy --device cpu   # a small size

Counterpart of `benchmarks/expansion_heavy.py` (the configuration of
`chip_smoke.py`'s path X), over the same data: `utils.synthetic.
synthetic_setup(1,000,000, 384, graph_degree=8)` (the JAX script's
`_synthetic_setup`), the engine with `ell_max_degree=8, exact_rescore=32`
(bf16 selection, kernel B5 at per-tile k = 100 and kernel B2 over the
489 x 100 pool, then the f32 rescore), top_k = 100, depth 3, B = 256
queries (`--batch`: the JAX script's `EXP_B` variable) from
numpy `default_rng(7)`, which then draws the random seed sets [B, 100]
and the dedup's candidates [B, 58,400] in [-1, N).  It prints, under the
JAX keys (CUDA events, 10 calls after two warm-ups):

  full_step_qps                the step at depth 3 (`query_batch_device`);
  retrieval_only_qps           `retrieve_batch_device` at k = 100 alone;
  expansion_only_ms_per_batch  `ops/expand.expand_batch` at depth 3 over
                               the random seed sets (no early exit);
  dedup_only_ms_per_batch      `ops/expand._ordered_unique_mask` over the
                               random candidates (depth 3's width);
  full_step_depth1_qps         the step at depth 1;

and `ms`, each row in milliseconds.  As in JAX, the expansion and dedup
rows are worst-case stages over random inputs, not parts of the step,
whose early exit stops after one hop when the 100 seeds give more than 20
neighbours.  On the CPU the host clock times the plain versions.  Nothing
is written but `--out`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    device_name,
    device_of,
    finish,
    log,
    ms,
    parser,
    timed,
)
from hcrag_tpu_torch.ops import expand as ex

N, D, K, DEPTH, DEG, B = 1_000_000, 384, 100, 3, 8, 256
CPU_SIZE = dict(n=20_000, steps=2)


def setup(dev: torch.device, n: int = N, b: int = B, index=None, graph=None) -> Dict:
    """The engine over `index` and `graph` (`synthetic_setup(n, 384,
    graph_degree=8)` unless given) and the seeded operands on `dev`."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    if index is None:
        with timed(f"synthetic setup ({n}, degree {DEG})"):
            index, graph = synthetic_setup(n, D, graph_degree=DEG)
    n = index.n
    with timed("engine init"):
        engine = QueryEngine(index, graph, device=dev, ell_max_degree=DEG, exact_rescore=32)
    if engine.exact_rescore != 32:
        raise ValueError("the index must hold f32 rows: the rescore reads them")
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, index.dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    seeds = rng.integers(0, n, size=(b, K)).astype(np.int32)
    c = K * DEG + K * DEG**2 + K * DEG**3  # 58,400
    cand = rng.integers(-1, n, size=(b, c)).astype(np.int32)
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(engine=engine, q=put(q), seeds=put(seeds), cand=put(cand), n=n)


def variants(x: Dict) -> Dict[str, Callable]:
    engine, q = x["engine"], x["q"]
    step = lambda depth: engine.query_batch_device(q, top_k=K, expansion_depth=depth)  # noqa: E731
    return {
        "full_step": lambda: step(DEPTH),
        "retrieval_only": lambda: engine.retrieve_batch_device(q, top_k=K),
        "expansion_only": lambda: ex.expand_batch(
            engine.d_neighbors, x["seeds"], depth=DEPTH, max_nodes=20,
            hop2_neighbors=engine.d_neighbors_hop2),
        "dedup_only": lambda: ex._ordered_unique_mask(x["cand"], x["n"]),
        "full_step_depth1": lambda: step(1),
    }


def run(device: Union[str, torch.device, None] = "cuda", n: int = N, b: int = B,
        steps: int = 10, index=None, graph=None, data: Optional[Dict] = None) -> Dict:
    """Time every row (module docstring).  `index`, `graph` replace the
    synthetic set-up; `data` (`setup(...)`) replaces all of it."""
    dev = device_of(device)
    x = data if data is not None else setup(dev, n, b, index, graph)
    b = x["q"].shape[0]
    t = {key: ms(fn, dev, steps) for key, fn in variants(x).items()}
    res = {
        "full_step_qps": b / (t["full_step"] / 1e3),
        "retrieval_only_qps": b / (t["retrieval_only"] / 1e3),
        "expansion_only_ms_per_batch": t["expansion_only"],
        "dedup_only_ms_per_batch": t["dedup_only"],
        "full_step_depth1_qps": b / (t["full_step_depth1"] / 1e3),
        "ms": t,
    }
    log(f"full step {t['full_step']:.3f} ms; retrieval only (k={K}) {t['retrieval_only']:.3f}; "
        f"expand_batch {t['expansion_only']:.3f}; dedup (C={x['cand'].shape[1]}) "
        f"{t['dedup_only']:.3f}; depth 1 {t['full_step_depth1']:.3f}")
    res["device"] = device_name(dev)
    res["shapes"] = dict(n=x["n"], b=b, top_k=K, depth=DEPTH, degree=DEG,
                         dedup_width=x["cand"].shape[1], steps=steps)
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--batch", type=int, default=B, help="queries a batch (EXP_B; 256)")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, b=args.batch, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
