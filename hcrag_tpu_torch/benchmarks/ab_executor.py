"""Saturate `BatchedExecutor` of two source trees over one engine, in alternating turns.

    python -m hcrag_tpu_torch.benchmarks.ab_executor PARENT_DIR [--device cpu]

PARENT_DIR holds a checkout of the repository (for example a `git archive`
of the parent commit).  Its `hcrag_tpu_torch/query/executor.py` is loaded
beside this tree's under another module name, and both executors serve the
one engine this tree builds, so the comparison is of the serving loop
alone (trees whose engines differ need a process per turn, as `ab_step`
runs them).  The engine and the executor's settings are `chip_smoke.py`'s
path E: the 1,000,000 x 384 synthetic index with a degree-4 graph, int8
selection with an f32 rescore of 32 (kernels B1 and B2), batch 1024,
dispatch sizes 128 / 256 / 1024, pipeline depth 3, a 2 ms wait, top_k 10.

`TURNS` turns a tree run in the order parent, change, change, parent,
parent, change, ...  A turn makes a new executor, serves one batch of each
dispatch size, then drains 65,536 requests submitted at once in blocks of
4,096 (`serving_openloop.run_saturation`) `REPS` times, the set-up's
objects frozen (`gc.freeze`) as path E freezes them, and shuts the
executor down.  Every drain's results must equal the first drain's bit for
bit.  It prints a line per turn, then one JSON line: each tree's req/s by
turn and drain, its median, and the change's median over the parent's.
With `--device cpu`: 10,000 rows and 2,048 requests a drain.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

TURNS = 5  # turns a tree
REPS = 3  # drains a turn
BATCH, SIZES, DEPTH, WAIT_MS, TOP_K = 1024, (128, 256, 1024), 3, 2.0, 10
OPTIONS = dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True, select_lane_t=1)


def load_executor(tree: Path):
    """`hcrag_tpu_torch/query/executor.py` of `tree`, as a module of its own."""
    path = tree / "hcrag_tpu_torch" / "query" / "executor.py"
    spec = importlib.util.spec_from_file_location("_ab_parent_executor", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def turn(executor_cls, engine, queries: np.ndarray, n: int) -> tuple:
    """One turn: req/s of each drain and the first drain's indices and
    scores."""
    from hcrag_tpu_torch.benchmarks.serving_openloop import run_saturation

    ex = executor_cls(engine, batch_size=BATCH, batch_sizes=SIZES, pipeline_depth=DEPTH,
                      max_wait_ms=WAIT_MS, top_k=TOP_K)
    rps, first = [], None
    try:
        for s in SIZES:  # the first batch of each size builds and loads its kernels
            ex.submit_many(queries[:s])[-1].result(timeout=600)
        for _ in range(REPS):
            futs = []
            gc.collect()
            gc.freeze()
            try:
                rps.append(run_saturation(ex, queries, n, futs)["requests_per_s"])
            finally:
                gc.unfreeze()
            results = [f.result() for f in futs]
            drained = (np.stack([r[1] for r in results]), np.stack([r[0] for r in results]))
            if first is None:
                first = drained
            elif not all(np.array_equal(a, b) for a, b in zip(first, drained)):
                raise AssertionError("a drain's results differ from the turn's first")
    finally:
        ex.shutdown()
    return rps, first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu (a small size)")
    args = ap.parse_args(argv)

    import torch

    from hcrag_tpu_torch.device import resolve_device
    from hcrag_tpu_torch.query import executor as change
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    n_rows, n = (1_000_000, 65_536) if cuda else (10_000, 2_048)
    index, graph = synthetic_setup(n_rows, 384, graph_degree=4)
    engine = QueryEngine(index, graph, device=dev, ell_max_degree=8, **OPTIONS)
    rng = np.random.default_rng(7)  # path E's query pool
    queries = rng.standard_normal((n, 384)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    trees = {"parent": load_executor(args.parent.absolute()).BatchedExecutor,
             "change": change.BatchedExecutor}
    runs = {"parent": [], "change": []}
    ref = None
    order = [name for i in range(TURNS)
             for name in (("parent", "change") if i % 2 == 0 else ("change", "parent"))]
    for name in order:
        rps, first = turn(trees[name], engine, queries, n)
        if ref is None:
            ref = first
        elif not all(np.array_equal(a, b) for a, b in zip(ref, first)):
            raise AssertionError(f"{name}'s results differ from the first turn's")
        runs[name].append(rps)
        print(f"{name} {json.dumps(rps)}", flush=True)
    med = {name: float(np.median(r)) for name, r in runs.items()}
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "requests_a_drain": n, "rows": n_rows,
        **{name: {"turns_rps": r, "median_rps": med[name]} for name, r in runs.items()},
        "change_over_parent": med["change"] / med["parent"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
