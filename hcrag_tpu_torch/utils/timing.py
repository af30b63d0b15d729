"""The port's recorder of spans and counters, device timing and profiler
traces.

Counterpart of `hcrag_tpu/utils/timing.py`, whose process-wide
`StageTimer` becomes the recorder:

  * the recorder: `span(name, **attrs)` and `count(name, n=1)` at the
    layer boundaries of the query step (the `engine.*` spans and
    `expand.*` counters of `query/engine.py` and `ops/expand.py`),
    `summary()` of what was recorded, `records()` of each span, `reset()`.
    It records only while a torch profiler runs or inside
    `with recording():`.  Otherwise `span` returns one shared no-op
    context and `count` returns at once: no device work and no sync.

    A recorded span holds its name, attrs, its start and end in
    `time.time_ns()` (the clock of the profiler's host events, so spans and
    the device trace share one timeline), its parent span's id and the id
    of the `engine.step` span around it.  Under a profiler it also opens a
    profiler range of its name (`_RecordFunctionFast`, ~1.6 us against
    `record_function`'s ~10), so the trace shows it, and the kernels
    launched inside it; the span itself touches no device.  Stacks are per thread; the store is
    a ring of the last 2**20 spans.  A count of a tensor adds its sum on
    its device, read by `summary()`.
  * `device_time` — mean seconds per call of a function on a named device:
    CUDA events for a CUDA device, the host clock for the CPU;
  * `graph_ms` — mean device milliseconds per call of a function replayed
    from a CUDA graph, for kernels that take less time than the host takes
    to launch them;
  * `trace_to` — a torch.profiler trace of a block of code, exported as a
    Chrome trace (chrome://tracing, Perfetto), with the recorder's
    `spans.json` beside it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Union

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
try:
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # an older torch
    _Range = torch.profiler.record_function

#: The span that is one call of the query step; its id is the step id of
#: every span inside it.
STEP = "engine.step"
#: Spans kept, newest last.
RING = 1 << 20


class _NoSpan:
    """The context `span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "step", "thread",
                 "start_ns", "end_ns", "_range")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self._range = None

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.parent = parent.id if parent is not None else None
        self.step = self.id if self.name == STEP else (parent.step if parent else None)
        self.thread = threading.get_ident()
        stack.append(self)
        # The host clock is read inside the profiler's range, next to the
        # range's own stamps.
        if _profiler_enabled():
            self._range = _Range(self.name)
            self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.rec._stack().pop()
        self.rec._spans.append(self)
        return False


class Recorder:
    """Spans and counters of the program's layers; see the module's
    docstring.  `RECORDER` is the process's own, behind the module's
    functions; a test may make its own."""

    def __init__(self):
        self._spans: collections.deque = collections.deque(maxlen=RING)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._on = 0
        self._counts: Dict[str, int] = {}
        self._device_counts: Dict[str, torch.Tensor] = {}

    def _stack(self) -> List[_Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    @contextlib.contextmanager
    def recording(self):
        """Record inside the block, with or without a profiler."""
        with self._lock:
            self._on += 1
        try:
            yield self
        finally:
            with self._lock:
                self._on -= 1

    def span(self, name: str, **attrs):
        """A context that records the block as the span `name`.
        `with span(...) as s` binds the span while recording, else None."""
        if not (self._on or _profiler_enabled()):
            return _NO_SPAN
        return _Span(self, name, attrs)

    def count(self, name: str, n=1) -> None:
        """Add `n` (an int, or a tensor's sum, added on its device) to the
        counter `name`."""
        if not (self._on or _profiler_enabled()):
            return
        if isinstance(n, torch.Tensor):
            total = n.sum(dtype=torch.int64)
            with self._lock:
                acc = self._device_counts.get(name)
                if acc is None:
                    self._device_counts[name] = total
                else:
                    acc.add_(total)
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def records(self) -> List[Dict]:
        """Every span in the ring, oldest first: id, parent, step, thread,
        name, attrs, start_ns, end_ns."""
        return [dict(id=s.id, parent=s.parent, step=s.step, thread=s.thread, name=s.name,
                     attrs=s.attrs, start_ns=s.start_ns, end_ns=s.end_ns)
                for s in list(self._spans)]

    def summary(self) -> Dict:
        """`steps` (the `engine.step` spans recorded), `spans` by name (`n`,
        `host_ms` in all, `self_ms` in all: host time less that of its
        child spans) and `counters`.  Reads the device counters: call it
        after the recorded work."""
        spans = list(self._spans)
        child_ns: Dict[int, int] = collections.defaultdict(int)
        for s in spans:
            if s.parent is not None:
                child_ns[s.parent] += s.end_ns - s.start_ns
        by_name: Dict[str, Dict] = {}
        for s in spans:
            d = by_name.setdefault(s.name, dict(n=0, host_ms=0.0, self_ms=0.0))
            host = s.end_ns - s.start_ns
            d["n"] += 1
            d["host_ms"] += host * 1e-6
            d["self_ms"] += (host - child_ns[s.id]) * 1e-6
        with self._lock:
            counters = dict(self._counts)
            device_counts = dict(self._device_counts)
        counters.update({k: int(v.item()) for k, v in device_counts.items()})
        return dict(steps=by_name.get(STEP, {}).get("n", 0), spans=by_name, counters=counters)

    def reset(self) -> None:
        """Forget every span and counter."""
        with self._lock:
            self._spans.clear()
            self._counts.clear()
            self._device_counts.clear()


#: The process's recorder.
RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
summary = RECORDER.summary
records = RECORDER.records
reset = RECORDER.reset
recording = RECORDER.recording


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
    `logdir`/trace.json as a Chrome trace, and the recorder's spans of the
    block to `logdir`/spans.json (`summary` and `spans`, see `records`;
    the recorder is reset first).  Yields the profiler, whose
    `key_averages()` sums the time by operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"summary": summary(), "spans": records()}, f)
