"""What the ported root benchmark scripts share.

Counterpart of the helpers of `benchmarks/session.py` that those scripts
use (`log`, `timed`), and of their command-line habits: each
script runs on the card unless `--device cpu` is passed (a small size
then), prints its result as one JSON line, and writes it to `--out` when
that is given.  Nothing here writes anywhere else.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.utils.timing import device_time


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class timed:
    """`with timed(label) as t:` logs the block's host seconds, kept in
    `t.dt`."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.dt = time.time() - self.t0
        log(f"[{self.label}] {self.dt:.2f}s")


def recall(ref: np.ndarray, got: np.ndarray) -> float:
    """Mean share of each row of `ref` [B, k] found in the same row of
    `got` [B, >= k]."""
    k = ref.shape[1]
    return float(np.mean([len(set(r.tolist()) & set(g.tolist())) / k
                          for r, g in zip(ref, got)]))


def brute_force_top_k(emb: np.ndarray, q: np.ndarray, k: int) -> np.ndarray:
    """Indices [B, k] of the f32 top-k of every query over `emb`, ties to
    the lower row, in row chunks of 2^19 (the reference's brute force,
    `main.py:831-845`)."""
    n = emb.shape[0]
    chunk = 1 << 19
    best_v = np.full((q.shape[0], k), -np.inf, np.float32)
    best_i = np.full((q.shape[0], k), -1, np.int64)
    for start in range(0, n, chunk):
        block = np.asarray(emb[start:start + chunk], np.float32)
        cat_v = np.concatenate([best_v, q @ block.T], axis=1)
        cat_i = np.concatenate(
            [best_i, np.arange(start, start + block.shape[0])[None, :].repeat(q.shape[0], 0)],
            axis=1)
        order = np.argsort(-cat_v, axis=1, kind="stable")[:, :k]
        best_v = np.take_along_axis(cat_v, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)
    return best_i


def ms(fn: Callable, dev: torch.device, steps: int, warmup: int = 2) -> float:
    """Milliseconds per call of fn(): CUDA events on the card, the host
    clock on the CPU (`utils.timing.device_time`)."""
    return 1e3 * device_time(fn, iters=steps, warmup=warmup, device=dev)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


RSS_PERIOD_S = 0.02  # `PeakRss`'s sampling period
DRAW_CHUNK = 1 << 18  # `normal_rows`'s rows a draw


def host_rss_gib() -> float:
    """This process's resident host memory now, in GiB (`/proc/self/statm`:
    every touched page of a file mapping counts, so a read-only index that
    several processes map is counted once in each)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def host_used_gib() -> Optional[float]:
    """The whole machine's host memory in use now, in GiB: MemTotal less
    MemAvailable of `/proc/meminfo` (every process, and the page cache of a
    mapped file once); None where /proc gives no MemAvailable."""
    with open("/proc/meminfo") as f:
        kib = {line.split(":")[0]: int(line.split()[1]) for line in f if ":" in line}
    if "MemAvailable" not in kib:
        return None
    return (kib["MemTotal"] - kib["MemAvailable"]) / 2**20


class PeakRss:
    """`with PeakRss() as rss:` keeps in `rss.peak` the largest resident
    size of this process (`host_rss_gib`) and in `rss.peak_used` the largest
    use of the machine's memory (`host_used_gib`, None where not given) seen
    while in the block, sampled every `RSS_PERIOD_S` seconds by a thread.
    No high-water mark of the process's own serves: `ru_maxrss` carries
    over that of the parent a rank was spawned from, and the card's machine
    reports no VmHWM (nor any shared, anonymous or file split of a
    process's pages)."""

    def _take(self) -> None:
        self.peak = max(self.peak, host_rss_gib())
        used = host_used_gib()
        if used is not None:
            self.peak_used = max(self.peak_used or 0.0, used)

    def _sample(self) -> None:
        while not self._stop.wait(RSS_PERIOD_S):
            self._take()

    def __enter__(self):
        self.peak, self.peak_used = 0.0, None
        self._take()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._take()


def normal_rows(rng: np.random.Generator, n: int, d: int, dev: torch.device,
                dtype=torch.float32, normalize: bool = True) -> torch.Tensor:
    """[n, d] standard normal rows of `rng`, drawn in `DRAW_CHUNK`-row
    chunks of one stream (the same values as one draw of [n, d]), each
    normalized in f32 unless told not to, placed on `dev` in `dtype`."""
    out = torch.empty((n, d), dtype=dtype, device=dev)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        rows = rng.standard_normal((hi - lo, d)).astype(np.float32)
        if normalize:
            rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        out[lo:hi] = torch.from_numpy(rows).to(dev).to(dtype)
    return out


def unit_queries(seed: int, b: int, d: int) -> np.ndarray:
    """`default_rng(seed)`'s first [b, d] normal draw, rows normalized: the
    JAX scripts' queries."""
    q = np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu (a small size)")
    p.add_argument("--out", default=None, help="also write the JSON result to this file")
    return p


def finish(result: Dict, out: Optional[str]) -> Dict:
    """Print `result` as one JSON line and write it to `out` if given."""
    line = json.dumps(result)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    return result


def device_of(device: Union[str, torch.device, None]) -> torch.device:
    """`resolve_device`, with TF32 refused for float32 products: the
    scripts compare f32 dots with the reference's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev
