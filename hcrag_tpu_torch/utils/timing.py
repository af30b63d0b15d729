"""Named wall-clock spans for the host stages of a query.

Counterpart of `StageTimer` and `GLOBAL_TIMER` in `hcrag_tpu/utils/timing.py`
(host-only: device time is measured with CUDA events or torch.profiler).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


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
