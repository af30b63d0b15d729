"""Roofline bounds of the repository's TPU kernels on one NVIDIA H100.

    python -m hcrag_tpu_torch.utils.bounds

A kernel's bound is the least time the card could take for its work: the
larger of the bytes it must move (each input read once, each output written
once) over the memory rate, and the operations it does over the card's peak
rate for their type (published H100 SXM dense peaks, 700 W).  The table
gives every kernel of the JAX package (B1-B8) at the shapes its path runs
(or, for the kernels still to port, would run); `chip_smoke.py` computes the
ported kernels' bounds from its own run's tensors with `bound_ms`.  The
printout's last row is no kernel: the MiniLM distillation's train step
(path T), plain float32 products in PyTorch, bounded by
`minilm_train_work` (`train_row`).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
PEAK_BYTES = 3.35e12

# The paths' shapes: 1,000,000 synthetic rows padded to 2048-row tiles (the
# density paths D1/D2: 10,000,000 rows), the MiniLM width, k=10 and the
# rescore oversample of 32; path R scores 8192 nodes with W=8 bit words.
# The supertile paths S1-S3 pad to whole 8192-row supertiles and pick 16
# per supertile; path X selects top_k=100 for B=256.
N_PAD, D, K, M, TILE = 1_001_472, 384, 10, 32, 2048
TILES = N_PAD // TILE
N_PAD_10M = 10_000_384
NODES, WORDS = 8192, 8
SUPER, K_SUB = 8192, 16
N_SUPER, N_SUPER_10M = 1_007_616, 10_002_432  # 123 and 1,221 supertiles
X_B, X_K = 256, 100


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


def merge_work(b: int, pool: int, out_k: int) -> Dict:
    """Kernel B2 for b queries over a pool of `pool` candidates: it reads
    every value once, gathers out_k indices per query (one 32-byte sector
    each) and writes (value, index) pairs."""
    return dict(ops=0.0, kind="int8", bytes=4 * b * pool + 32 * b * out_k + 8 * b * out_k)


def minilm_train_work(batch: int, seq: int, hidden: int = 384, layers: int = 6,
                      heads: int = 12, ffn: int = 1536) -> Dict:
    """One AdamW step of the MiniLM distillation on batch x seq tokens
    (padded; the products run over every padded position).

    Operations (f32 on the CUDA cores: TF32 is refused): the forward's
    products, 2 x the layers' matmul weights (4 h^2 + 2 h ffn a layer) per
    token, plus attention's two products, 4 b s^2 h a layer; the backward
    takes twice the forward.  Bytes: the activations the backward reads,
    each written once by the forward and read once by the backward (a layer
    keeps per token its input, q, k, v, the attention output and its
    projection, both LayerNorms' outputs, h each, the FFN's input and GELU
    output, ffn each, and each head's softmax row, heads x s), plus the
    weights read twice, their gradients written and AdamW's read-modify-
    write of weights and two moments."""
    tokens = batch * seq
    weights = layers * (4 * hidden * hidden + 2 * hidden * ffn)
    forward = 2.0 * weights * tokens + layers * 4.0 * batch * seq * seq * hidden
    per_token = 8 * hidden + 2 * ffn + heads * seq
    activations = 4.0 * layers * tokens * per_token
    optimizer = 4.0 * weights * (2 + 1 + 3 * 2)
    return dict(ops=3.0 * forward, kind="f32", bytes=2 * activations + optimizer,
                tokens=tokens)


def table() -> List[Dict]:
    """One row per kernel and path: id, name, path and shapes, ops, bytes,
    bound.  A kernel's main path comes last among its rows."""
    b_int8, b_f1, b_f2 = 8192, 1024, 8192
    s1m, s10m = N_SUPER // SUPER, N_SUPER_10M // SUPER
    rows = [
        ("B1", "_topk_tile_kernel_int8 (fused two-level)",
         "int8 select, B=8192", _select(b_int8, 1, "int8", 1, TILES * K)),
        ("B2", "_merge_vals_kernel", "paths S1/S2: supertile pool 123 x 16 -> 32, B=8192",
         merge_work(b_int8, s1m * K_SUB, M)),
        ("B2", "_merge_vals_kernel", "path S3: supertile pool 1221 x 16 -> 32, B=2048",
         merge_work(2048, s10m * K_SUB, M)),
        ("B2", "_merge_vals_kernel", "path X: pool 489 x 100 -> 100, B=256",
         merge_work(X_B, TILES * X_K, X_K)),
        ("B2", "_merge_vals_kernel", "pool 489 x 10 -> 32, B=8192",
         merge_work(b_int8, TILES * K, M)),
        ("B3", "_topk_tile_kernel_int8 (k-pass packed, exact)",
         "paths D1/D2: 10M-row int8 bank, B=2048",
         _select(2048, 1, "int8", 1, -(-N_PAD_10M // TILE) * K, n=N_PAD_10M)),
        # A bound takes the peak of the operands' type: B4 over a bf16 bank
        # is held to the bf16 rate, though it sums in f32 on the CUDA cores.
        ("B4", "_topk_tile_kernel", "path K: bf16 bank, B=512",
         _select(512, 2, "bf16", 2, TILES * K)),
        ("B4", "_topk_tile_kernel", "path F1: f32 bank, B=1024",
         _select(b_f1, 4, "f32", 4, TILES * K)),
        ("B5", "_topk_tile_kernel_packed", "path X: bf16 bank, B=256, k=100",
         _select(X_B, 2, "bf16", 2, TILES * X_K)),
        ("B5", "_topk_tile_kernel_packed", "path F2: bf16 bank, B=8192",
         _select(b_f2, 2, "bf16", 2, TILES * K)),
        ("B6", "_scoring_kernel", "path R: one query, N=8192 nodes, W=8, llm column",
         scoring_work(1, NODES, D, WORDS, llm=True)),
        ("B6", "_scoring_kernel", "kernel phase: B=256, N=8192 nodes, W=8, llm column",
         scoring_work(256, NODES, D, WORDS, llm=True)),
        ("B7", "_topk_tile_kernel_packed_super",
         "path S1: pallas_super=8 (1024 x 8 rows), bf16 bank, B=8192",
         _select(b_f2, 2, "bf16", 2, s1m * K_SUB, n=N_SUPER)),
        ("B7", "_topk_tile_kernel_int8_super",
         "path S2: pallas_super=4 (2048 x 4 rows), int8 bank, B=8192",
         _select(b_int8, 1, "int8", 1, s1m * K_SUB, n=N_SUPER)),
        ("B7", "_topk_tile_kernel_int8_super",
         "path S3: pallas_super=4, 10M-row int8 bank, B=2048",
         _select(2048, 1, "int8", 1, s10m * K_SUB, n=N_SUPER_10M)),
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
    return [_row(*r) for r in rows]


def _row(kid: str, name: str, path: str, work: Dict) -> Dict:
    ms, by = bound_ms(work["ops"], work["kind"], work["bytes"])
    return dict(id=kid, kernel=name, path=path, ops=work["ops"], ops_type=work["kind"],
                bytes=work["bytes"], bound_ms=ms, bound_by=by)


def train_row() -> Dict:
    """Path T's MiniLM train step (no kernel) in the table's row format."""
    return _row("T", "MiniLM distillation train step (plain torch, no kernel)",
                "path T: B=128, max_len 192, 6 x 384 wide, FFN 1536",
                minilm_train_work(128, 192))


if __name__ == "__main__":
    for row in table() + [train_row()]:
        print(json.dumps(row))
