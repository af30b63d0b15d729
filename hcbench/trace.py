"""A traced slice of a run's window, reduced to the device's busy time.

`Tracer` runs `torch.profiler` (CPU and CUDA activities) over one slice of
the measured window: it drains the device, starts the profiler, opens the
annotation `hcbench.window` and, at the slice's end, drains the device
again and closes both.  The slice is the annotation's host interval.
`summary()` reduces the trace:

  * busy_s:  the union of the device's operations (kernels, copies, sets)
    inside the slice; window_s its length; steps, the steps the loop
    issued inside it (`count_step`), all of which end inside it;
  * op_s: each device operation's time inside the slice, by its full name;
  * device_ops: the ten device operations that took most time, each
    named by the first 96 characters of its name;
  * idle_gaps: the ten longest stretches with no device operation, each
    named by the shortest host event (an operator, a runtime call, an
    annotation) that spans its middle, or `host_idle` where none does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "hcbench.window"


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every event of the trace;
    annotations mirrored on the device's timeline are left out (they are
    no device work)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
        if on_device and (e.name() == WINDOW or getattr(e, "is_user_annotation", bool)()):
            continue
        try:
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        except AttributeError:  # an older profiler: microseconds only
            start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append((e.name(), on_device, start, start + dur))
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events: List[Tuple[str, bool, float, float]], top: int = 10) -> Optional[Dict]:
    """The slice's summary from its events; None without the annotation."""
    win = [(a, b) for name, dev, a, b in events if name == WINDOW and not dev]
    if not win:
        return None
    w0, w1 = win[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, d, a, b in events if d and b > w0 and a < w1]
    busy = _merge([(a, b) for _, a, b in dev if b > a])
    by_name: Dict[str, float] = {}
    for n, a, b in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(n, a, b) for n, d, a, b in events if not d and n != WINDOW and b > a]
    idle = []
    for g0, g1 in gaps[:top]:
        mid = 0.5 * (g0 + g1)
        spans = [(b - a, n) for n, a, b in host if a <= mid <= b]
        idle.append([min(spans)[1] if spans else "host_idle", g1 - g0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_s=sum(b - a for a, b in busy), window_s=w1 - w0, op_s=by_name,
                device_ops=[[n[:96], s] for n, s in ops[:top]], idle_gaps=idle)


class Tracer:
    """Profiles `length_s` seconds of a window from `start_s` seconds into
    it; `tick(elapsed)` between steps opens and closes the slice, and
    `count_step()` after a step is issued counts it when the slice is open."""

    def __init__(self, device: torch.device, start_s: float, length_s: float):
        self.device = device
        self.start_s, self.length_s = start_s, length_s
        self._prof = self._span = None
        self._opened = 0.0
        self.done = False
        self.steps = 0
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._acts = acts

    def warm_up(self) -> None:
        """Start and stop the profiler once, so that its first start (the
        device tracer's set-up, a second or more) falls outside the window."""
        with torch.profiler.profile(activities=self._acts):
            torch.ones(8, device=self.device).sum().item()

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, elapsed: float) -> None:
        if self.done:
            return
        if self._prof is None and elapsed >= self.start_s:
            self._drain()
            self._prof = torch.profiler.profile(activities=self._acts)
            self._prof.start()
            self._span = torch.profiler.record_function(WINDOW)
            self._span.__enter__()
            self._opened = time.monotonic()
        elif self._prof is not None and time.monotonic() - self._opened >= self.length_s:
            self.close()

    def count_step(self) -> None:
        if self._prof is not None and not self.done:
            self.steps += 1

    def close(self) -> None:
        """End the slice (at the latest when the window ends)."""
        if self._prof is None or self.done:
            return
        self._drain()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self.done = True

    def summary(self) -> Optional[Dict]:
        if self._prof is None:
            return None
        t = time.monotonic()
        out = reduce_events(_events(self._prof))
        if out is not None:
            out.update(steps=self.steps, reduce_s=time.monotonic() - t)
        return out
