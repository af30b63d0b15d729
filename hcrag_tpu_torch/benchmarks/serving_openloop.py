"""Open-loop serving load on `BatchedExecutor`.

    python -m hcrag_tpu_torch.benchmarks.serving_openloop                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.serving_openloop --device cpu   # a small size

Counterpart of `benchmarks/serving_openloop.py`, with the same knobs (env:
RATES="2000,5000,10000,20000" DURATION_S=3 SERVE_B=1024 SIZES="128,256,1024"
PIPE_DEPTH=3 MODE=retrieval SAT_N=65536 ENGINE) and the same JSON row.  It
drives the executor as a front end would: Poisson arrivals at a fixed
offered rate, each request's latency taken from its scheduled arrival to
its batch's resolve stamp (`SlotFuture.resolve_time`), so a late submitter
counts against the result.  For each offered rate: achieved req/s over the
span (first submission to last resolve), p50 / p95 / p99 latency, and the
mean dispatched batch fill so far; then one saturation row (every request
submitted at once through `submit_many`), the executor's ceiling, whose
queueing delay is no latency claim.

The index is `utils.synthetic.synthetic_setup` at 1,000,000 x 384 with a
degree-4 graph (20,000 rows with `--device cpu`).  ENGINE=int8f32 (the
default here) is `bench.py`'s mode: int8 selection, an f32 rescore of 32
(kernels B1 and B2); ENGINE=f32 is the default float engine (kernel B4);
ENGINE=bf16, the JAX harness's default, serves kernel B4 over the rows
rounded to bfloat16 with no rescore, as the JAX engine does over a bfloat16
host index (its `exact_rescore=32` is dropped there for want of f32 rows).
The port rounds on the device (`QueryEngine(bank_dtype="bfloat16")`), so no
host bfloat16 type (`ml_dtypes`) is needed.  The default stays int8f32,
the faster engine on the H100.  The row names the device it ran on; a CPU row times PyTorch's CPU kernels,
not the card.  Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch


#: QueryEngine options of each ENGINE (the JAX harness's bf16 engine keeps
#: its `exact_rescore=32`, which the bf16 bank drops, as JAX drops it).
ENGINE_OPTIONS = {
    "int8f32": dict(quantize_int8=True, int8_rescore=32, int8_f32_rescore=True),
    "f32": {},
    "bf16": dict(bank_dtype="bfloat16", exact_rescore=32),
}


def run_rate(ex, queries: np.ndarray, rate: float, duration_s: float,
             futures_out: Optional[List] = None, timeout: float = 600.0) -> dict:
    """Offer `rate` req/s of Poisson traffic (seeded by the rate) for
    `duration_s`; request i carries queries[i % len(queries)].  Returns the
    row's stats; `futures_out`, if given, receives the futures in request
    order.  Each request may take `timeout` seconds."""
    rng = np.random.default_rng(int(rate))
    n = int(rate * duration_s)
    sched = np.cumsum(rng.exponential(1.0 / rate, size=n))
    futs = [None] * n
    t0 = time.monotonic()
    i = 0
    while i < n:
        now = time.monotonic() - t0
        j = i
        while j < n and sched[j] <= now:
            j += 1
        if j > i:
            block = ex.submit_many(queries[i % len(queries):][: j - i])
            futs[i:i + len(block)] = block
            i += len(block)
        else:
            time.sleep(min(0.0005, max(0.0, sched[i] - now)))
    for f in futs:
        f.result(timeout=timeout)
    t_end = time.monotonic()
    lat_ms = np.array(
        [(f.resolve_time - (t0 + s)) * 1e3 for f, s in zip(futs, sched)]
    )
    p50, p95, p99 = np.percentile(lat_ms, [50, 95, 99])
    if futures_out is not None:
        futures_out.extend(futs)
    return {
        "offered_rps": rate,
        "achieved_rps": n / (t_end - t0),
        "latency_ms_p50": float(p50),
        "latency_ms_p95": float(p95),
        "latency_ms_p99": float(p99),
        "n_requests": n,
    }


def run_saturation(ex, queries: np.ndarray, n: int,
                   futures_out: Optional[List] = None, timeout: float = 600.0,
                   block: int = 4096) -> dict:
    """Ceiling throughput: submit all `n` requests at once (blocks of
    `block`), time the drain."""
    t0 = time.monotonic()
    futs = []
    for s in range(0, n, block):
        futs.extend(ex.submit_many(queries[s % len(queries):][: min(block, n - s)]))
    for f in futs:
        f.result(timeout=timeout)
    dt = time.monotonic() - t0
    if futures_out is not None:
        futures_out.extend(futs)
    return {"n_requests": n, "requests_per_s": n / dt}


def mean_fill(ex) -> float:
    return ex.requests_served / max(1, ex.batches_dispatched)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (a small index)")
    args = parser.parse_args(argv)

    from hcrag_tpu_torch.device import resolve_device
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.query.executor import BatchedExecutor
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    dev = resolve_device(args.device)
    n_rows = 1_000_000 if dev.type == "cuda" else 20_000
    index, graph = synthetic_setup(n_rows, 384, graph_degree=4)
    engine_cfg = os.environ.get("ENGINE", "int8f32")
    if engine_cfg not in ENGINE_OPTIONS:
        raise SystemExit(
            f"ENGINE must be one of {sorted(ENGINE_OPTIONS)}, got {engine_cfg!r}")
    engine = QueryEngine(index, graph, ell_max_degree=8, device=dev,
                         **ENGINE_OPTIONS[engine_cfg])

    rng = np.random.default_rng(7)
    queries = rng.standard_normal((65536, 384)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    serve_b = int(os.environ.get("SERVE_B", 1024))
    sizes = tuple(int(x) for x in os.environ.get("SIZES", "128,256,1024").split(","))
    mode = os.environ.get("MODE", "retrieval")
    rates = [float(x) for x in os.environ.get("RATES", "2000,5000,10000,20000").split(",")]
    duration = float(os.environ.get("DURATION_S", 3))
    depth = int(os.environ.get("PIPE_DEPTH", 3))
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    row = {
        "device": device_name,
        "engine": engine_cfg,
        "micro_batch_max": serve_b,
        "dispatch_sizes": list(sizes),
        "pipeline_depth": depth,
        "mode": mode,
        "rates": [],
    }
    ex = BatchedExecutor(
        engine, batch_size=serve_b, top_k=10, mode=mode,
        batch_sizes=sizes, pipeline_depth=depth, max_wait_ms=2.0,
    )
    try:
        for s in sizes:  # the first batch of each size builds and loads its kernels
            ex.submit_many(queries[:s])[-1].result(timeout=600)
        for rate in rates:
            stats = run_rate(ex, queries, rate, duration)
            stats["mean_batch_fill_so_far"] = mean_fill(ex)
            print(f"[openloop/{mode}] offered {rate:.0f} -> achieved "
                  f"{stats['achieved_rps']:.0f} req/s, p50 {stats['latency_ms_p50']:.2f} ms, "
                  f"p99 {stats['latency_ms_p99']:.2f} ms ({device_name})",
                  file=sys.stderr, flush=True)
            row["rates"].append(stats)
            time.sleep(0.5)  # drain between rates
        row["saturation"] = run_saturation(
            ex, queries, int(os.environ.get("SAT_N", 65536)))
    finally:
        ex.shutdown()
    row["note"] = (
        "Open-loop Poisson arrivals; latency = scheduled arrival -> batch "
        "resolve stamp (queueing + batching + service, submitter lateness "
        "included).  Saturation row = all-at-once backlog drain (throughput "
        "ceiling; its queueing delay is excluded from latency claims)."
    )
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
