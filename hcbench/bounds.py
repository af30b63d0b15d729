"""Roofline bounds on one NVIDIA H100, frozen for the benchmark.

A copy of the port's bound arithmetic (`bound_ms`, `_select` of its
`utils/bounds.py`), kept here so that no later change to the program moves
the yardstick.  A bound is the least time the card could take for a piece
of work: the larger of its operations over the published dense peak of
their type and its bytes (each input read once, each output written once)
over the memory rate.  Peaks: NVIDIA's H100 SXM data sheet at 700 W.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12
#: bytes of one bank element / query element by the selection's type
ELEM_BYTES = {"int8": (1, 1), "bf16": (2, 2), "f32": (4, 4)}


def bound_ms(ops: float, kind: str, nbytes: float) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for `ops` operations of
    type `kind` and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def select_work(b: int, n: int, d: int, kind: str, out_slots: int) -> Dict:
    """A fused cosine + per-tile select of b queries [b, d] over a bank
    [n, d] of type `kind` (plus one f32 scale per row and per query for
    int8), the row mask, and (value, index) pairs for `out_slots`
    candidates per query."""
    ebytes, qbytes = ELEM_BYTES[kind]
    ops = 2.0 * b * n * d
    nbytes = (qbytes * b * d + ebytes * n * d + n
              + (4 * (n + b) if kind == "int8" else 0) + 8 * b * out_slots)
    return dict(ops=ops, kind=kind, bytes=nbytes)


def select_bound_ms(b: int, n: int, d: int, kind: str, top_k: int,
                    tile_rows: int = 2048) -> float:
    """The least time of the selection of top_k over n rows for b queries:
    `select_work` with top_k candidates out of every tile of `tile_rows`."""
    work = select_work(b, n, d, kind, -(-n // tile_rows) * top_k)
    return bound_ms(work["ops"], work["kind"], work["bytes"])[0]
