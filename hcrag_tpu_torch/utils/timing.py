"""Named wall-clock spans, device timing and profiler traces.

Counterpart of `hcrag_tpu/utils/timing.py`:

  * `StageTimer`, `GLOBAL_TIMER` — named wall-clock spans for the host
    stages of a query;
  * `device_time` — mean seconds per call of a function on a named device:
    CUDA events for a CUDA device, the host clock for the CPU;
  * `graph_ms` — mean device milliseconds per call of a function replayed
    from a CUDA graph, for kernels that take less time than the host takes
    to launch them;
  * `trace_to` — a torch.profiler trace of a block of code, exported as a
    Chrome trace (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Union

import torch


class StageTimer:
    """Hierarchical named wall-clock spans."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        start = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.totals[full] += time.perf_counter() - start
            self.counts[full] += 1

    def report(self) -> str:
        lines = ["stage                                    total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:40s} {t:8.3f} {c:7d} {1000 * t / c:9.2f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k]}
            for k in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


#: Process-wide default timer (opt-in use).
GLOBAL_TIMER = StageTimer()


def device_time(fn, *args, iters: int = 10, warmup: int = 2,
                device: Union[str, torch.device]) -> float:
    """Mean seconds per call of fn(*args) over `iters` back-to-back calls,
    after `warmup` calls.  On a CUDA `device`, CUDA events on its current
    stream around the calls, then a synchronize: the device's time, not the
    enqueue's.  On the CPU, the host clock.  The caller names the device the
    work runs on; any other device type raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device_time times CUDA or CPU work, got {dev}")
    if iters < 1:
        raise ValueError(f"iters must be at least 1, got {iters}")
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cpu":
        start = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - start) / iters
    with torch.cuda.device(dev):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return begin.elapsed_time(end) / 1e3 / iters


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device milliseconds per call of fn(), `calls` calls captured
    back to back into one CUDA graph and the graph replayed `replays` times
    between CUDA events.  The replay launches no Python, so the time is the
    kernels' and the gaps between them, not the host's cost of launching
    (which exceeds a launch of a few microseconds).  fn runs on the current
    CUDA device, once first to warm up (builds, caches)."""
    if calls < 1 or replays < 1:
        raise ValueError(f"calls and replays must be at least 1, got {calls}, {replays}")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / (calls * replays)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with torch.profiler (host activity, and the card's
    kernels and copies when CUDA is available) and export it to
    `logdir`/trace.json as a Chrome trace.  Yields the profiler, whose
    `key_averages()` sums the time by operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
