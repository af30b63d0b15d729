"""The traffic loops; a traffic file's `loop` key names one.

`closed`: batch callers.  The engine's whole step (`query_batch_device`)
runs back to back on batches of `batch` fresh queries, each batch drawn
from the seed on the device just before its step, with at most `in_flight`
steps queued on the device.  No batch is sent twice, so nothing that
remembers earlier answers can speed a run up.  Throughput counts the
queries of every step issued in the window over the time until the last
one completed.  A sample of `check_steps` steps (their queries and
answers), drawn from the seed by reservoir sampling over the whole window,
is kept for the check.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hcbench.data import unit_rows

#: The step's outputs, in `query_batch_device`'s order.
STEP_OUTPUTS = ("top_scores", "top_indices", "relevance", "combined",
                "expanded_nodes", "expanded_counts", "expanded_relevance")


def drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ClosedLoop:
    def __init__(self, system, traffic: Dict, g: torch.Generator, seed: int,
                 device: torch.device, dim: int):
        self.system, self.traffic, self.device = system, traffic, device
        self.g, self.dim = g, dim
        self.batch = int(traffic["batch"])
        self.keep_n = int(traffic["check_steps"])
        self.in_flight = int(traffic["in_flight"])
        self.rng = np.random.default_rng(seed)
        self.kept: Dict[int, Tuple[torch.Tensor, tuple]] = {}

    def queries(self) -> torch.Tensor:
        """The next batch of unit queries drawn from the seed's generator."""
        return unit_rows(self.g, self.batch, self.dim, self.device)

    def warm_up(self) -> None:
        """Every shape of the window, and the allocator grown to hold the
        kept sample beside the steps in flight."""
        held = [self.system.step(self.queries(), self.traffic)
                for _ in range(self.keep_n + self.in_flight)]
        drain(self.device)
        del held

    def window(self, seconds: float, tracer=None) -> Dict:
        events: collections.deque = collections.deque()
        issue: List[float] = []
        cuda = self.device.type == "cuda"
        t0 = time.monotonic()
        end, s = t0 + seconds, 0
        while True:
            now = time.monotonic()
            if now >= end:
                break
            if tracer is not None:
                tracer.tick(now - t0)
            if len(events) >= self.in_flight:
                events.popleft().synchronize()
            q = self.queries()
            a = time.monotonic()
            out = self.system.step(q, self.traffic)
            issue.append(time.monotonic() - a)
            if tracer is not None:
                tracer.count_step()
            if cuda:
                events.append(torch.cuda.Event())
                events[-1].record()
            slot = s if s < self.keep_n else int(self.rng.integers(0, s + 1))
            if slot < self.keep_n:
                self.kept[slot] = (q, out)
            s += 1
        if tracer is not None:
            tracer.close()
        drain(self.device)
        window_s = time.monotonic() - t0
        return dict(steps=s, completed_queries=s * self.batch, attempted=s * self.batch,
                    failed=0, window_s=window_s, issue_s=issue)

    def kept_batches(self) -> List[Tuple[torch.Tensor, Dict]]:
        return [(q.cpu(), {n: t.cpu() for n, t in zip(STEP_OUTPUTS, out)})
                for _, (q, out) in sorted(self.kept.items())]

    def close(self) -> None:
        self.kept.clear()


LOOPS = {"closed": ClosedLoop}
