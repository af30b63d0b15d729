"""The fixed cost of one call of the fused selection: t(N) = a + d*N.

    python -m hcrag_tpu_torch.benchmarks.dispatch_floor                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.dispatch_floor --device cpu   # a small size

Counterpart of `benchmarks/dispatch_floor.py`, over the same data (numpy
`default_rng(7)`: the queries [512, 384] first, then for each N its rows,
normalized and cast to bf16, every row valid).  It times the production
packed selection, `cosine_top_k(q, bank, mask, 10, tile_n=2048,
packed_select=True, merge_k=32)` (kernel B5, and kernel B2 where the pool
holds >= 4096 candidates: at N = 1,048,576 only), at N = 131,072,
262,144, 524,288 and 1,048,576, and fits t(N) = a + d*N by least squares
twice:

  * on the host clock, 10 calls back to back and one synchronize (the JAX
    script's measure): `per_call_ms`, `fit_dispatch_overhead_ms` (a: the
    host's cost of issuing a call, launches included, that no kernel change
    can reduce), `fit_device_ms_per_1M_rows` (d x 2^20) and
    `implied_min_read_gib_s_if_dma_bound` (the bf16 bank's bytes at 2^20
    rows over that time) — the JAX keys;
  * on CUDA events around the same calls (`utils.timing.device_time`):
    `per_call_event_ms`, `fit_event_overhead_ms`,
    `fit_event_ms_per_1M_rows`.  The two values of `a` differ by the host
    and launch cost that the events do not see.

On the CPU both fits read the host clock.  Nothing is written but `--out`.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    device_name,
    device_of,
    finish,
    log,
    ms,
    normal_rows,
    parser,
)
from hcrag_tpu_torch.ops import topk_cuda as tc

SIZES = (131_072, 262_144, 524_288, 1_048_576)
D, B, K, MERGE_K, TILE_N = 384, 512, 10, 32, 2048
CPU_SIZE = dict(sizes=(8192, 16_384, 32_768), d=64, b=16, steps=2)


def select(q: torch.Tensor, e: torch.Tensor, mask: torch.Tensor):
    """The timed call: B5 (+ B2 over pools of >= 4096) and the merge."""
    return tc.cosine_top_k(q, e, mask, K, tile_n=TILE_N, packed_select=True,
                           merge_k=MERGE_K)


def fit_line(ns: Sequence[int], ts_ms: Sequence[float]) -> Tuple[float, float]:
    """(a ms, d ms per row) of the least-squares line t = a + d*N, as the
    JAX script fits it (`np.polyfit(ns, ts, 1)`)."""
    d, a = np.polyfit(np.asarray(ns, np.float64), np.asarray(ts_ms, np.float64), 1)
    return float(a), float(d)


def host_ms(fn, dev: torch.device, steps: int) -> float:
    """Host milliseconds per call: `steps` calls back to back, then one
    synchronize, after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return 1e3 * (time.perf_counter() - t0) / steps


def run(device: Union[str, torch.device, None] = "cuda", sizes: Sequence[int] = SIZES,
        d: int = D, b: int = B, steps: int = 10) -> Dict:
    dev = device_of(device)
    rng = np.random.default_rng(7)
    q = normal_rows(rng, b, d, dev)
    host, event = {}, {}
    for n in sizes:
        e = normal_rows(rng, n, d, dev, dtype=torch.bfloat16)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
        fn = lambda: select(q, e, mask)  # noqa: E731
        host[n] = host_ms(fn, dev, steps)
        event[n] = ms(fn, dev, steps)
        log(f"N={n}: {host[n]:.3f} ms/call on the host clock, {event[n]:.3f} ms by events")
        del e, mask
    a, slope = fit_line(list(host), list(host.values()))
    a_ev, slope_ev = fit_line(list(event), list(event.values()))
    device_1m = slope * 1_048_576
    return {
        "per_call_ms": {str(n): t for n, t in host.items()},
        "fit_dispatch_overhead_ms": a,
        "fit_device_ms_per_1M_rows": device_1m,
        "implied_min_read_gib_s_if_dma_bound": 1_048_576 * d * 2 / (device_1m / 1e3) / 2**30,
        "per_call_event_ms": {str(n): t for n, t in event.items()},
        "fit_event_overhead_ms": a_ev,
        "fit_event_ms_per_1M_rows": slope_ev * 1_048_576,
        "note": ("t(N) = a + d*N over the production packed selection (B5, B2 from "
                 f"4096 candidates; B={b}, merge_k={MERGE_K}); host clock (the JAX "
                 "measure) and CUDA events"),
        "device": device_name(dev),
        "shapes": dict(b=b, d=d, k=K, merge_k=MERGE_K, tile_n=TILE_N, steps=steps),
    }


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
