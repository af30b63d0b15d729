"""Split the time of the fused float top-k (kernel B5) into its stages.

    python -m hcrag_tpu_torch.benchmarks.kernel_sweep                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.kernel_sweep --device cpu   # a small size

Counterpart of `benchmarks/kernel_sweep.py`, over the same data (numpy
`default_rng(seed)`: normal rows padded to whole tiles and normalized, the
bank cast to bf16, f32 queries, every row valid; by default 1,001,472 x 384
rows and B=512) and under the same keys, in ms per call:

  matmul_only_acc    kernel B8a: every dot of the CUDA-core loop (B4's, and
                     B5's over an f32 bank), folded to a running max of each
                     tile's first 128 columns — the read + dot floor of that
                     loop;
  matmul_only_wide   kernel B8b: the same dots, each tile's first 128
                     columns written out ([B, tiles * 128] f32) — + writes;
  encode_level1      kernel B8c: the same dots under B5's packed key, with
                     the per-lane top-2 of every tile — + encode and level 1;
  full_two_level     `cosine_top_k(packed_select=True, merge_k=32)`: B5 and
                     B2.  The port's B5 computes the exact per-tile top-k
                     that both Pallas branches (two-level and k-pass)
                     share, so this row and the next run the same kernels;
  full_kpass         the same call;
  full_exact_kernel  `cosine_top_k(packed_select=False, merge_k=32)`: B4
                     over the bf16 bank, then a stable merge;
  two_level_2x256    full_two_level as two calls of B/2 queries each.

It adds `library_matmul`, one `torch.matmul` of the bf16 queries with the
bank: cuBLAS doing the same 2*B*N*D dots on the tensor cores, with no fold
(a [B, N] bf16 product); `b5_alone`, B5 without B2; and
`matmul_only_acc_tile128`, B8a over 128-row tiles, where every dot reaches
the output.  The int8 yardstick: `b1_alone`, kernel B1 over the same bank
and queries quantized on the device by the port's `quantize_bank` /
`quantize_queries`, and `library_int8_matmul`, one `torch._int_mm` of
the same int8 operands (the dots alone, a [B, N] int32 product);
`b1_over_library` sets the two side by side, as `b5_over_library` does for
B5.  B8a-c run the CUDA-core dot loop (`csrc/float_dot.cuh`) that
B4 and the f32 banks keep; B5 over this bf16 bank runs on the tensor cores,
with its selection in the loop's epilogue.  So `attribution` splits the
CUDA-core loop alone: its dots (matmul_only_acc), the writes (wide - acc)
and the encode and level-1 pass (encode - acc); B5 is a row of its own,
set beside the library's product (`b5_over_library`), and nothing is
subtracted across the two loops.  `acc_2048_over_128`, the ratio of B8a's
two times for the same dots, is near 1 when no dot is dropped.
`launches` gives, for each row, the kernel launches its timed calls made.
On the card the times are CUDA events (`utils.timing.device_time`); on the
CPU the wrappers run their plain versions and the host clock times them.
Nothing is written to disk.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from hcrag_tpu_torch.device import resolve_device
from hcrag_tpu_torch.ops import sweep_cuda as sc
from hcrag_tpu_torch.ops import topk_cuda as tc
from hcrag_tpu_torch.ops.quantize import quantize_bank, quantize_queries
from hcrag_tpu_torch.utils.timing import device_time

#: The rows of the JAX sweep, under its keys.
JAX_ROWS = ("matmul_only_acc", "matmul_only_wide", "encode_level1", "full_two_level",
            "full_kpass", "full_exact_kernel", "two_level_2x256")
MERGE_K = 32
WARMUP = 2
ROW_CHUNK = 1 << 18  # bank rows generated per step: 384 MB of float64 at D=384
#: `--device cpu`: a size the plain versions run in seconds.
CPU_SIZE = dict(n=8192, d=128, b=64, steps=2)


def _wrappers() -> Dict[str, object]:
    """The kernel wrappers the rows launch, whose `.launches` count them."""
    return {"matmul_only_acc": sc.matmul_only_acc, "matmul_only_wide": sc.matmul_only_wide,
            "encode_level1": sc.encode_level1, "float_packed_tile_topk": tc.float_packed_tile_topk,
            "packed_candidate_merge": tc.packed_candidate_merge,
            "float_tile_topk": tc.float_tile_topk, "int8_tile_topk": tc.int8_tile_topk}


def sweep_data(device: Union[str, torch.device], n: int = 1_000_000, d: int = 384,
               b: int = 512, tile_n: int = 2048, seed: int = 7
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX sweep's operands on `device`: (q [b, d] f32, e [n_pad, d]
    bf16), n_pad = n rounded up to whole tiles.  The rows are drawn first,
    in chunks of the same stream, each normalized in f32; then the queries."""
    dev = resolve_device(device)
    n_pad = -(-n // tile_n) * tile_n
    rng = np.random.default_rng(seed)
    e = torch.empty((n_pad, d), dtype=torch.bfloat16, device=dev)
    for lo in range(0, n_pad, ROW_CHUNK):
        hi = min(n_pad, lo + ROW_CHUNK)
        rows = rng.standard_normal((hi - lo, d)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        e[lo:hi] = torch.from_numpy(rows).to(dev).to(torch.bfloat16)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return torch.from_numpy(q).to(dev), e


def sweep(device: Union[str, torch.device], n: int = 1_000_000, d: int = 384, b: int = 512,
          top_k: int = 10, tile_n: int = 2048, seed: int = 7, steps: int = 10,
          data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> Dict:
    """Time every row (module docstring) `steps` times after WARMUP calls
    on `device`; `data` = (q, e) from `sweep_data` replaces n, d, b and
    seed.  Returns {row: ms per call, "attribution": {...}, "launches":
    {row: {kernel: launches}}, "device": ..., "shapes": {...}}."""
    dev = resolve_device(device)
    q, e = data if data is not None else sweep_data(dev, n, d, b, tile_n, seed)
    b, n_pad = q.shape[0], e.shape[0]
    qb = q.to(torch.bfloat16)
    mask = torch.ones(n_pad, dtype=torch.bool, device=dev)
    k_tile = tc.tile_pick_count(top_k, n_pad, tile_n, MERGE_K)
    half = b // 2
    q8, qs = quantize_queries(q)
    e8, es = quantize_bank(e, dev)

    def full(packed: bool, qq: torch.Tensor = q):
        return tc.cosine_top_k(qq, e, mask, top_k, tile_n=tile_n, packed_select=packed,
                               merge_k=MERGE_K)

    rows = {
        "matmul_only_acc": lambda: sc.matmul_only_acc(qb, e, tile_n),
        "matmul_only_wide": lambda: sc.matmul_only_wide(qb, e, tile_n),
        "encode_level1": lambda: sc.encode_level1(qb, e, tile_n),
        "full_two_level": lambda: full(True),
        "full_kpass": lambda: full(True),
        "full_exact_kernel": lambda: full(False),
        "two_level_2x256": lambda: (full(True, q[:half]), full(True, q[half:])),
        "library_matmul": lambda: torch.matmul(qb, e.T),
        "b5_alone": lambda: tc.float_packed_tile_topk(qb, e, mask, k_tile, tile_n),
        "matmul_only_acc_tile128": lambda: sc.matmul_only_acc(qb, e, 128),
        "b1_alone": lambda: tc.int8_tile_topk(q8, qs, e8, es, mask, top_k, tile_n),
        "library_int8_matmul": lambda: torch._int_mm(q8, e8.T),
    }
    wrappers = _wrappers()
    out: Dict = {}
    launches = {}
    for name, fn in rows.items():
        before = {k: w.launches for k, w in wrappers.items()}
        out[name] = 1e3 * device_time(fn, iters=steps, warmup=WARMUP, device=dev)
        launches[name] = {k: w.launches - before[k] for k, w in wrappers.items()
                          if w.launches != before[k]}
    acc, b5 = out["matmul_only_acc"], out["b5_alone"]
    out["attribution"] = {
        "dots_ms": acc,
        "writes_ms": out["matmul_only_wide"] - acc,
        "encode_level1_ms": out["encode_level1"] - acc,
        "library_speedup_over_dots": acc / out["library_matmul"],
        "b5_over_library": b5 / out["library_matmul"],
        "b1_over_library": out["b1_alone"] / out["library_int8_matmul"],
        "acc_2048_over_128": acc / out["matmul_only_acc_tile128"],
    }
    out["launches"] = launches
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    out["shapes"] = dict(b=b, n=n_pad, d=e.shape[1], tile_n=tile_n, top_k=top_k,
                         merge_k=MERGE_K, k_tile=k_tile, steps=steps, warmup=WARMUP)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu (a small size)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(sweep(dev, **(CPU_SIZE if dev.type == "cpu" else {}))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
