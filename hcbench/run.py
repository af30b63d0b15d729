"""Run one cell of the benchmark once and print its result line.

    python3 -m hcbench.run --workload kg1m_int8.batch8k --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for.  Set-up makes the cell's data from `--seed` on the card, builds
the program (`hcrag_tpu_torch`: its kernels are built into the checkout at
first use) and warms every shape the traffic uses; then the traffic runs
for `--seconds`.  `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer metrics from a profiled slice of the window.
Once the window has closed, what the timed path answered is judged
against the plain reference of the configuration's kind
(`hcbench/kinds/<kind>.py`).  The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`: each
number compared with its limit); the checks are also the last lines of
standard error.

Exit codes: 0 a result was printed; 2 no CUDA device, or fewer than the
cell asks for; 3 the program is missing; 4 the run loaded JAX, jaxlib,
flax or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: Top-level module names no run may load, compared whole: the program's
#: name begins with the last one.
BANNED = ("jax", "jaxlib", "flax", "hcrag_tpu")


def banned_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a cell's first run there builds (the program's own nvcc output
    goes to `hcrag_tpu_torch/_kernels_build/`, also in the checkout)."""
    base = root / ".hcbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def trace_slice(seconds: float):
    """(start, length) in seconds of the profiled part of a window."""
    return 0.25 * seconds, min(3.0, 0.5 * seconds)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """One run of `cell` on `device`; returns the result line's object and
    the run's side information.  What the cell feeds, drives and judges is
    its kind's (`cell.kind`)."""
    import torch

    from hcbench.check import verdict
    from hcbench.data import generator
    from hcbench.trace import Tracer

    kind, cfg, tr = cell.kind, cell.config, cell.traffic
    cuda = device.type == "cuda"
    phases, t = {}, time.monotonic()
    phases["start_s"] = t - t_start

    def phase(name):
        nonlocal t
        now = time.monotonic()
        phases[name] = now - t
        t = now

    g = generator(seed, device)
    inputs = {k: v.cpu() for k, v in kind.make_inputs(cfg, g, device).items()}
    if cuda:  # the peak below is the program's and its traffic's, not the draw's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    phase("data_s")
    system = kind.System(cfg, inputs, device)
    phase("program_s")
    loop = kind.LOOPS[tr["loop"]](system, tr, g, seed, device, int(cfg["dim"]))
    loop.warm_up()
    tracer = Tracer(device, *trace_slice(seconds)) if trace else None
    if tracer is not None:
        tracer.warm_up()
    gc.collect()
    gc.freeze()  # the set-up's objects are never scanned again in the window
    phase("warm_s")
    setup_s = time.monotonic() - t_start

    run = loop.window(seconds, tracer)
    run["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        run["trace"] = tracer.summary()
        run.update(kind.trace_info(cfg, tr))
    batches = loop.kept_batches()
    loop.close()
    del loop, system
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    numbers, info = kind.judge(kind.Reference(cfg, inputs, device), tr, batches)
    info["reference_s"] = time.monotonic() - t_ref
    info["setup_phases"] = phases
    correct, rows = verdict(numbers, cell.limits)

    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(run["attempted"]),
              "failed": int(run["failed"]), "metrics": metrics, "device": dev}
    summary = run.get("trace")
    if summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        info.update(trace_reduce_s=summary["reduce_s"], traced_steps=summary["steps"])
    info["steps"] = run["steps"]
    kind.finish_info(info)
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in rows}
    return {"result": result, "checks": rows, "info": info}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from hcbench.spec import load_cell

    cache_dirs(ROOT)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hcbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import hcrag_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"hcbench: the program is missing: {e}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START)
    found = banned_modules()
    if found:
        print(f"hcbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(json.dumps({"info": out["info"]}), flush=True)
    for r in out["checks"]:
        print(f"check {r['name']} {r['value']!r} limit {r['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
