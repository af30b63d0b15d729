"""Roofline bounds of the repository's TPU kernels on one NVIDIA H100.

    python -m hcrag_tpu_torch.utils.bounds

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output written
once) over the memory rate, and the operations it does over the card's peak
rate for their type (published H100 SXM dense peaks, 700 W).  The table
gives every kernel of the JAX package (B1-B8) at the shapes its path runs
(or, for the kernels still to port, would run); `chip_smoke.py` computes the
ported kernels' bounds from its own run's tensors with `bound_ms`.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

# The paths' shapes: 1,000,000 synthetic rows padded to 2048-row tiles (the
# density paths D1/D2: 10,000,000 rows), the MiniLM width, k=10 and the
# rescore oversample of 32; path R scores 8192 nodes with W=8 bit words.
N_PAD, D, K, M, TILE = 1_001_472, 384, 10, 32, 2048
TILES = N_PAD // TILE
N_PAD_10M = 10_000_384
NODES, WORDS = 8192, 8


def bound_ms(ops: float, kind: str, nbytes: float) -> Tuple[float, str]:
    """(least time in ms, "operations" or "bytes") for `ops` operations of
    type `kind` ("int8", "bf16" or "f32") and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / PEAK_OPS[kind], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def _select(b: int, ebytes: int, kind: str, qbytes: int, out_slots: int,
            n: int = N_PAD) -> Dict:
    """A fused cosine + per-tile select over the bank: q [b, D], the bank
    [n, D] (+ one f32 scale per row for int8), the row mask, and
    (value, index) pairs for `out_slots` candidates per query."""
    ops = 2.0 * b * n * D
    nbytes = (qbytes * b * D + ebytes * n * D + n
              + (4 * (n + b) if kind == "int8" else 0) + 8 * b * out_slots)
    return dict(ops=ops, kind=kind, bytes=nbytes)


def scoring_work(b: int, n: int, d: int, w: int, llm: bool) -> Dict:
    """Kernel B6 for b queries over n nodes: 2*b*n*d f32 operations for the
    dots; it reads the queries (f32 rows, bit words, count, intent), the
    weights and the 5 x 6 table, the nodes (f32 rows, bit words, count,
    type) and the llm column [b, n] if there is one, and writes [b, n]."""
    nbytes = 4 * (b * (d + w + 2) + 4 + 30 + n * (d + w + 2) + b * n * (2 if llm else 1))
    return dict(ops=2.0 * b * n * d, kind="f32", bytes=nbytes)


def table() -> List[Dict]:
    """One row per kernel: id, name, path and shapes, ops, bytes, bound."""
    b_int8, b_f1, b_f2 = 8192, 1024, 8192
    num_super, k_sub = -(-N_PAD // 8192), 16  # B7: 8192-row supertiles
    rows = [
        ("B1", "_topk_tile_kernel_int8 (fused two-level)",
         "int8 select, B=8192", _select(b_int8, 1, "int8", 1, TILES * K)),
        ("B2", "_merge_vals_kernel", "pool 489 x 10 -> 32, B=8192",
         dict(ops=0.0, kind="int8",
              bytes=4 * b_int8 * TILES * K + 32 * b_int8 * M + 8 * b_int8 * M)),
        ("B3", "_topk_tile_kernel_int8 (k-pass packed, exact)",
         "paths D1/D2: 10M-row int8 bank, B=2048",
         _select(2048, 1, "int8", 1, -(-N_PAD_10M // TILE) * K, n=N_PAD_10M)),
        ("B4", "_topk_tile_kernel", "path F1: f32 bank, B=1024",
         _select(b_f1, 4, "f32", 4, TILES * K)),
        ("B5", "_topk_tile_kernel_packed", "path F2: bf16 bank, B=8192",
         _select(b_f2, 2, "bf16", 2, TILES * K)),
        ("B6", "_scoring_kernel", "path R: one query, N=8192 nodes, W=8, llm column",
         scoring_work(1, NODES, D, WORDS, llm=True)),
        ("B6", "_scoring_kernel", "kernel phase: B=256, N=8192 nodes, W=8, llm column",
         scoring_work(256, NODES, D, WORDS, llm=True)),
        ("B7", "_topk_tile_kernel_packed_super", "path F2 with pallas_super=4",
         _select(b_f2, 2, "bf16", 2, num_super * k_sub)),
        ("B7", "_topk_tile_kernel_int8_super", "int8 select with pallas_super=4",
         _select(b_int8, 1, "int8", 1, num_super * k_sub)),
        ("B7", "_merge_super_candidates", "123 x 16 -> 32, B=8192",
         dict(ops=0.0, kind="int8",
              bytes=8 * b_int8 * num_super * k_sub + 8 * b_int8 * M)),
        ("B8", "make_matmul_only_acc", "bf16 bank, B=512",
         dict(ops=2.0 * 512 * N_PAD * D, kind="bf16",
              bytes=2 * 512 * D + 2 * N_PAD * D + 4 * 512 * 128)),
        ("B8", "make_matmul_only_wide", "bf16 bank, B=512",
         dict(ops=2.0 * 512 * N_PAD * D, kind="bf16",
              bytes=2 * 512 * D + 2 * N_PAD * D + 4 * 512 * 128 * TILES)),
        ("B8", "make_encode_level1", "bf16 bank, B=512",
         dict(ops=2.0 * 512 * N_PAD * D, kind="bf16",
              bytes=2 * 512 * D + 2 * N_PAD * D + 4 * 512 * 256)),
    ]
    out = []
    for kid, name, path, work in rows:
        ms, by = bound_ms(work["ops"], work["kind"], work["bytes"])
        out.append(dict(id=kid, kernel=name, path=path, ops=work["ops"],
                        ops_type=work["kind"], bytes=work["bytes"],
                        bound_ms=ms, bound_by=by))
    return out


if __name__ == "__main__":
    for row in table():
        print(json.dumps(row))
