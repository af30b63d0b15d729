"""Selection under the packed key against selection by raw value, at 1M rows.

    python -m hcrag_tpu_torch.benchmarks.twolevel_ablation                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.twolevel_ablation --device cpu   # a small size

Counterpart of `benchmarks/twolevel_ablation.py`, over the same data
(numpy `default_rng(7)`: 1,000,000 normalized rows of D=384, then 512
normalized queries; the int8 bank and its row scales are `quantize_rows`
of the rows, here computed on the device by `quantize_bank`, byte-equal).
The JAX script asks a TPU question: whether the per-tile selection should
take the two-level per-lane pass or k full-width passes.  The port has no
such choice: its kernels compute the exact per-tile top-k that both TPU
branches approximate.  So the port asks its own question on the same
banks, the packed (score | lane) key against the raw value, and prints QPS
(B / seconds per call, CUDA events) under the JAX keys:

  int8_packed_two_level  `cosine_top_k_int8(packed_select=True,
                         merge_k=32)`: kernels B1 + B2, one call;
  int8_packed_kpass      the same call, timed once and printed under both
                         keys: the JAX script's two strategies are one
                         contract in the port;
  bf16_exact_kpass       `cosine_top_k(merge_k=32)` over the bf16 bank:
                         kernel B4 and a stable merge;
  bf16_packed_two_level  `cosine_top_k(packed_select=True, merge_k=32)`:
                         kernels B5 + B2;
  int8_exact             (no JAX key) `cosine_top_k_int8(packed_select=
                         False, merge_k=32)`: kernel B3e, the int8
                         raw-value counterpart, and a stable merge;

and `int8_two_level_top10_in_merge32_vs_f32_brute`, the share of the f32
top-10 of the first 8 queries found in the int8 packed call's merge-32.
`ms` gives each row's milliseconds per call.  On the CPU the host clock
times the plain versions.  Nothing is written but `--out`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    device_name,
    device_of,
    finish,
    log,
    ms,
    normal_rows,
    parser,
    recall,
    timed,
)
from hcrag_tpu_torch.ops import topk_cuda as tc
from hcrag_tpu_torch.ops.quantize import quantize_bank

N, D, B, K, MERGE_K = 1_000_000, 384, 512, 10, 32
SEED = 7
CPU_SIZE = dict(n=20_000, d=64, b=16, steps=2)


def banks(dev: torch.device, n: int = N, d: int = D, b: int = B) -> Dict:
    """The JAX script's rows and queries on `dev`: f32 rows, their bf16
    copy, the int8 bank with its scales, the queries and an all-valid
    mask."""
    rng = np.random.default_rng(SEED)
    e = normal_rows(rng, n, d, dev)
    q = normal_rows(rng, b, d, dev)
    e8, sc = quantize_bank(e, dev)
    return dict(e=e, e_bf16=e.to(torch.bfloat16), e8=e8, sc=sc, q=q,
                mask=torch.ones(n, dtype=torch.bool, device=dev))


def variants(x: Dict) -> Dict[str, Callable]:
    q, mask = x["q"], x["mask"]
    int8 = lambda packed: tc.cosine_top_k_int8(  # noqa: E731
        q, x["e8"], x["sc"], mask, K, packed_select=packed, merge_k=MERGE_K)
    bf16 = lambda packed: tc.cosine_top_k(  # noqa: E731
        q, x["e_bf16"], mask, K, packed_select=packed, merge_k=MERGE_K)
    return {"int8_packed_two_level": lambda: int8(True),
            "bf16_exact_kpass": lambda: bf16(False),
            "bf16_packed_two_level": lambda: bf16(True),
            "int8_exact": lambda: int8(False)}


def top10_in_merge32(x: Dict, n_check: int = 8) -> float:
    """Share of the f32 top-10 of the first `n_check` queries inside the
    int8 packed call's merge-32."""
    _, idx = variants(x)["int8_packed_two_level"]()
    scores = (x["q"][:n_check] @ x["e"].T).cpu().numpy()
    ref = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    return recall(ref, idx[:n_check].cpu().numpy())


def run(device: Union[str, torch.device, None] = "cuda", n: int = N, d: int = D, b: int = B,
        steps: int = 20, data: Dict = None) -> Dict:
    dev = device_of(device)
    with timed("gen"):
        x = data if data is not None else banks(dev, n, d, b)
    b = x["q"].shape[0]
    res: Dict = {"ms": {}}
    for key, fn in variants(x).items():
        t = ms(fn, dev, steps)
        res["ms"][key] = t
        res[key] = b / (t / 1e3)
        log(f"[{key}] {t:.3f} ms/batch -> {res[key]:.0f} QPS")
    res["int8_packed_kpass"] = res["int8_packed_two_level"]
    res["int8_two_level_top10_in_merge32_vs_f32_brute"] = top10_in_merge32(x)
    log(f"recall of f32-true top-10 inside int8 packed merge-32: "
        f"{res['int8_two_level_top10_in_merge32_vs_f32_brute']}")
    res["note"] = ("QPS of one fused call at B=%d, k=%d, merge %d over %d rows: the packed key "
                   "against the raw value; int8_packed_kpass repeats int8_packed_two_level (one "
                   "exact contract in the port)" % (b, K, MERGE_K, x["e"].shape[0]))
    res["device"] = device_name(dev)
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
