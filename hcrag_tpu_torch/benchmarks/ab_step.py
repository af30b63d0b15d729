"""Time the engine step of path X in two source trees, in alternating processes.

    python -m hcrag_tpu_torch.benchmarks.ab_step PARENT_DIR CHANGE_DIR

Each directory holds a checkout of the repository (for example two
`git archive` trees).  `TURNS` turns a tree run in the order parent,
change, change, parent, parent, change, ..., each in a process of its own
that imports its tree alone (its working directory and `PYTHONPATH`), so
that a drift of the card's clock over the run weighs on both trees alike.
A turn builds `chip_smoke.py`'s path X: the 1,000,000 x 384 synthetic
index with a degree-8 graph, `exact_rescore=32`, top_k 100, B=256 (the
first 256 of the smoke's queries), then times `query_batch_device` at
depth 3 and at depth 1, REPS steps each after one warm-up, every step by
its own CUDA events.  The turn's code uses only calls that both trees have
(`synthetic_setup`, `synthetic_graph`, `QueryEngine`,
`query_batch_device`).

It prints a line per turn, then one JSON line: each tree's ms per step by
turn and depth, each turn's median, and the tree's median and quartiles
over all its steps.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPS = 5
TURNS = 5  # turns a tree
_TURN = r"""
import json, sys
import numpy as np
import torch
from hcrag_tpu_torch.query.engine import QueryEngine
from hcrag_tpu_torch.utils.synthetic import synthetic_graph, synthetic_setup

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
reps = int(sys.argv[1])
index, _ = synthetic_setup(1_000_000, 384, graph_degree=4)
graph = synthetic_graph(1_000_000, 8)
q = np.random.default_rng(7).standard_normal((256, 384)).astype(np.float32)
q /= np.linalg.norm(q, axis=1, keepdims=True)
engine = QueryEngine(index, graph, device="cuda", ell_max_degree=8, exact_rescore=32,
                     select_lane_t=1)
dq = torch.from_numpy(q).cuda()
out = {}
for depth in (3, 1):
    step = lambda: engine.query_batch_device(dq, top_k=100, expansion_depth=depth)
    step()
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    out[f"d{depth}"] = ms
print("TURN " + json.dumps(out), flush=True)
"""


def turn(tree: Path) -> dict:
    """One turn in `tree`: {"d3": [ms, ...], "d1": [ms, ...]}."""
    proc = subprocess.run(
        [sys.executable, "-c", _TURN, str(REPS)], cwd=tree,
        env=dict(os.environ, PYTHONPATH=str(tree)), capture_output=True, text=True,
        timeout=900,
    )
    if proc.returncode:
        raise RuntimeError(f"turn in {tree} failed:\n{proc.stderr[-3000:]}")
    line = next(l for l in proc.stdout.splitlines() if l.startswith("TURN "))
    return json.loads(line[len("TURN "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    args = ap.parse_args(argv)
    trees = {"parent": args.parent.absolute(), "change": args.change.absolute()}
    runs = {"parent": [], "change": []}
    order = [name for i in range(TURNS)
             for name in (("parent", "change") if i % 2 == 0 else ("change", "parent"))]
    for name in order:
        res = turn(trees[name])
        runs[name].append(res)
        print(f"{name} {json.dumps(res)}", flush=True)

    def stats(r, d):
        steps = [m for t in r for m in t[d]]
        return {"turn_medians_ms": [float(np.median(t[d])) for t in r],
                "median_ms": float(np.median(steps)),
                "quartiles_ms": [float(q) for q in np.percentile(steps, [25, 75])]}

    print(json.dumps({name: {"turns": r, **{d: stats(r, d) for d in ("d3", "d1")}}
                      for name, r in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
