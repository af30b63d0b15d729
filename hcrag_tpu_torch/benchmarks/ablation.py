"""Where the bf16 query step's time goes: dots, selection, then the step.

    python -m hcrag_tpu_torch.benchmarks.ablation [N] [B]                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.ablation --device cpu           # a small size

Counterpart of `benchmarks/ablation.py`, over the same data: the synthetic
index and degree-4 graph of `utils.synthetic.synthetic_setup(N, 384)` (by
default N = 1,000,000; the JAX script's `_synthetic_setup`), the rows
rounded to bf16, B = 1024 queries from numpy `default_rng(7)`, k = 10,
every row valid.  It prints ms per batch (CUDA events, 10 calls after a
warm-up) under the JAX script's stage labels:

  "matmul only (reduced)"
        the dots alone, as the JAX script's stage 1 computes them: the
        bf16 products summed in f32 (on the card one tensor-core product
        a chunk, `torch.mm(q, e.T, out_dtype=torch.float32)`; on the CPU
        `ops/similarity.dots`), over 2^17-row chunks, each chunk's
        [B, rows] block summed over its rows;
  "matmul only (reduced, float64 as stage 2)"
        the same, with the products of stage 2 (`ops/similarity.dots`:
        summed in float64, rounded to f32), so that stage 2 less this
        row is its selection;
  "matmul + streaming XLA top-k" (N > 2^18; else "matmul + chunked XLA
  top-k", the dots and `masked_top_k`)
        `ops/similarity.streaming_masked_top_k`, the port's route without
        a kernel (JAX's counterpart runs XLA's sort);
  "pallas fused cosine+top-k"
        `cosine_top_k(tile_n=2048)` over the bf16 bank padded to whole
        tiles: kernel B4 and a stable merge;
  "full step (expansion d1)", "full step (max_expanded=1)"
        `QueryEngine.query_batch_device` at depth 1 with `max_expanded`
        20 and 1, over the engine of the bf16 rows
        (`bank_dtype="bfloat16"`: B4, the metrics, the expansion and its
        scoring), as the JAX engine runs over a bf16 host index.

The JAX script records None where its fused call fails; the port raises.
On the CPU the host clock times the plain versions.  Nothing is written
but `--out`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    device_name,
    device_of,
    finish,
    log,
    ms,
    parser,
    timed,
    unit_queries,
)
from hcrag_tpu_torch.ops import topk_cuda as tc
from hcrag_tpu_torch.ops.similarity import dots, masked_top_k, streaming_masked_top_k

N, B, K, TILE_N = 1_000_000, 1024, 10, 2048
STREAM_ROWS = 1 << 17  # `streaming_masked_top_k`'s chunk
CPU_SIZE = dict(n=20_000, b=64, steps=2)

DOTS = "matmul only (reduced)"
DOTS_F64 = "matmul only (reduced, float64 as stage 2)"
FUSED = "pallas fused cosine+top-k"
STEP_D1 = "full step (expansion d1)"
STEP_MAX1 = "full step (max_expanded=1)"


def select_label(n: int) -> str:
    return ("matmul + streaming XLA top-k" if n > (1 << 18)
            else "matmul + chunked XLA top-k")


def tensor_core_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, D] . b [N, D]^T as float32 [M, N]: on the card one product of
    the operands as they are, summed in f32; on the CPU `dots`."""
    if a.device.type == "cuda":
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return dots(a, b)


def reduced_dots(q: torch.Tensor, e: torch.Tensor,
                 product: Callable = tensor_core_dots) -> torch.Tensor:
    """[B] f32: every query's dots with every row by `product`, summed over
    the rows, chunk by chunk as the streaming selection takes them."""
    qb = q.to(e.dtype)
    out = torch.zeros(q.shape[0], dtype=torch.float32, device=q.device)
    for lo in range(0, e.shape[0], STREAM_ROWS):
        out += product(qb, e[lo:lo + STREAM_ROWS]).sum(dim=1)
    return out


def setup(dev: torch.device, n: int = N, b: int = B, index=None, graph=None) -> Dict:
    """The operands: `index` and `graph` (`synthetic_setup(n, 384)` unless
    given), the bf16 bank, its copy padded to whole tiles with the padded
    mask, the queries, and the engine over the bf16 rows."""
    from hcrag_tpu_torch.query.engine import QueryEngine
    from hcrag_tpu_torch.utils.synthetic import synthetic_setup

    if index is None:
        with timed(f"synthetic setup ({n}, degree 4)"):
            index, graph = synthetic_setup(n, 384, graph_degree=4)
    n = index.n
    e = torch.from_numpy(np.asarray(index.emb, np.float32)).to(dev).to(torch.bfloat16)
    n_pad = -(-n // TILE_N) * TILE_N
    e_pad = torch.nn.functional.pad(e, (0, 0, 0, n_pad - n))
    with timed("engine init"):
        engine = QueryEngine(index, graph, device=dev, ell_max_degree=8,
                             bank_dtype="bfloat16")
    return dict(e=e, e_pad=e_pad, mask=torch.ones(n, dtype=torch.bool, device=dev),
                mask_pad=torch.arange(n_pad, device=dev) < n, engine=engine,
                q=torch.from_numpy(unit_queries(7, b, index.dim)).to(dev))


def variants(x: Dict, k: int = K) -> Dict[str, Callable]:
    q, e, mask, engine = x["q"], x["e"], x["mask"], x["engine"]
    n = e.shape[0]
    if n > (1 << 18):
        select = lambda: streaming_masked_top_k(q, e, mask, k)  # noqa: E731
    else:
        select = lambda: masked_top_k(dots(q.to(e.dtype), e), mask, k)  # noqa: E731
    step = lambda max_exp: engine.query_batch_device(  # noqa: E731
        q, top_k=k, expansion_depth=1, max_expanded=max_exp)
    return {DOTS: lambda: reduced_dots(q, e), DOTS_F64: lambda: reduced_dots(q, e, dots),
            select_label(n): select,
            FUSED: lambda: tc.cosine_top_k(q, x["e_pad"], x["mask_pad"], k, tile_n=TILE_N),
            STEP_D1: lambda: step(20), STEP_MAX1: lambda: step(1)}


def run(device: Union[str, torch.device, None] = "cuda", n: int = N, b: int = B,
        steps: int = 10, index=None, graph=None, data: Optional[Dict] = None) -> Dict:
    """Time every stage (module docstring).  `index`, `graph` replace the
    synthetic set-up; `data` (`setup(...)`) replaces all of it."""
    dev = device_of(device)
    x = data if data is not None else setup(dev, n, b, index, graph)
    log(f"device={device_name(dev)} n={x['e'].shape[0]} b={x['q'].shape[0]} k={K}")
    res: Dict = {}
    for label, fn in variants(x).items():
        res[label] = ms(fn, dev, steps, warmup=1)
        log(f"  {label:42s} {res[label]:8.3f} ms/batch")
    res["device"] = device_name(dev)
    res["shapes"] = dict(n=x["e"].shape[0], b=x["q"].shape[0], k=K, steps=steps)
    return res


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("n", nargs="?", type=int, default=None, help="index rows (1,000,000)")
    p.add_argument("b", nargs="?", type=int, default=None, help="queries a batch (1024)")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    size = dict(CPU_SIZE) if dev.type == "cpu" else {}
    if args.n is not None:
        size["n"] = args.n
    if args.b is not None:
        size["b"] = args.b
    finish(run(dev, **size), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
