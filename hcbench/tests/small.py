"""The benchmark's cells at a size a CPU test run holds: 20,000 rows, small
batches, a short window.  Every other setting (widths, graph, engine,
precision, scoring, limits) is the cell's own."""

from __future__ import annotations

import time

import torch

from hcbench.spec import ROOT, load_benchmark, load_cell

ROWS = 20_000
SECONDS = 1.0
CPU = torch.device("cpu")


#: The cells of BENCHMARK.json.
CELLS = [w["name"] for w in load_benchmark()["workloads"]]


def small_cell(name: str, root=None):
    cell = load_cell(name, root=root or ROOT, draft=True)
    cell.config["rows"] = ROWS
    cell.traffic["batch"] = 32
    return cell


def run_small(cell, seed: int = 2**31 + 17, trace: bool = False):
    from hcbench.run import run_cell

    return run_cell(cell, seed, SECONDS, trace, CPU, time.monotonic())
