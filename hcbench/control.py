"""Readings for the limits of `correct`, at a cell's own size.

    python3 -m hcbench.control --workloads kg1m_int8.batch8k,kg1m_int8.graph3 \
        --seeds 11,12,13 --seconds 2

For each seed, one set-up of each configuration (the cells' data, the
program), then for each named cell a short window at the cell's own load,
the numbers of the program's answers (the lower readings) and the numbers
of the control: the reference one precision step lower (the kind's
`lowered`) put in the program's place, on the same queries (the upper
readings).  One JSON line per seed and cell.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from hcbench.data import generator
from hcbench.spec import load_cell


def readings(cells, seed: int, seconds: float, device) -> list:
    """[{seed, workload, program, control}] for cells of one configuration."""
    kind, cfg = cells[0].kind, cells[0].config
    g = generator(seed, device)
    inputs = {k: v.cpu() for k, v in kind.make_inputs(cfg, g, device).items()}
    after_inputs = g.get_state()
    system = kind.System(cfg, inputs, device)
    kept = []
    for cell in cells:
        g.set_state(after_inputs)  # the queries a run of this cell would draw
        loop = kind.LOOPS[cell.traffic["loop"]](system, cell.traffic, g, seed, device,
                                                int(cfg["dim"]))
        loop.warm_up()
        loop.window(seconds)
        kept.append((cell, loop.kept_batches()))
        loop.close()
    del system, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = kind.Reference(cfg, inputs, device)
    low = kind.Reference(cfg, inputs, device, precision=kind.lowered(cfg["precision"]))
    out = []
    for cell, batches in kept:
        program, _ = kind.judge(ref, cell.traffic, batches)
        ctrl = [(q, kind.control_outputs(low, cell.traffic, q)) for q, _ in batches]
        control, _ = kind.judge(ref, cell.traffic, ctrl)
        out.append(dict(seed=seed, workload=cell.name, program=program, control=control))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workloads", required=True, help="comma-separated cells")
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    device = torch.device("cuda")
    cells = [load_cell(w, draft=True) for w in args.workloads.split(",")]
    groups = {}
    for c in cells:
        groups.setdefault(c.config_name, []).append(c)
    for seed in (int(s) for s in args.seeds.split(",")):
        for group in groups.values():
            t = time.monotonic()
            for row in readings(group, seed, args.seconds, device):
                row["seconds"] = time.monotonic() - t
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
