"""The card's memory read and copy rate over the retrieval banks' shapes.

    python -m hcrag_tpu_torch.benchmarks.hbm_bandwidth                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.hbm_bandwidth --device cpu   # a small size

Counterpart of `benchmarks/hbm_bandwidth.py`, over the same data: numpy
`default_rng(7)` normal rows [n_pad, D] (1,000,000 rows padded to whole
2048-row tiles, D=384), cast to bf16 (734 MiB) and to int8 as
`(x * 16).clip(-127, 127)` truncated (367 MiB).  It prints, under the JAX
script's keys, GiB/s (2^30 bytes a second) of:

  xla_reduce_bf16_734MiB
                 one full read: `torch.sum(bank, dtype=torch.float32)`;
  xla_reduce_int8_367MiB
                 one full read of the int8 bank as 32-bit words, their
                 max (`bank.view(torch.int32).amax()`): the same bytes
                 read once.  PyTorch reduces in the input's own type
                 unless it is bf16 or f16: the JAX script's
                 `sum(int8, float32)` (and a sum of the words into int64)
                 first writes a widened copy of the bank and reads it
                 back, so it gives no memory rate;
  folded_reduce_bf16_16x, folded_reduce_int8_16x
                 16 of those reads captured in one CUDA graph and replayed
                 (`utils.timing.graph_ms`): the counterpart of JAX's 16
                 reads in one device call, without the host's launch cost.
                 A graph replays every kernel it holds, so the pass-scaled
                 bank of the JAX scan (there to stop XLA from merging equal
                 reads) is not needed: each pass reads the bank as is;
  xla_copy_bf16_rw
                 one copy, read + write: `bank * bf16(1.0009765625)` into a
                 new tensor (2x the bytes), the scale a Python float (the
                 bf16 rounding of 1.0009765625, 1.0, so the output equals
                 JAX's bit for bit): a scale held in a tensor on the card
                 takes PyTorch's broadcast path, not its vectorized one.

Beside them: `assumed_peak_gib_s`, the memory rate that every bytes bound
of `utils/bounds.py` divides by (3.35e12 B/s), each rate's share of it
(`share_of_assumed_peak`), and the rates in GB/s (10^9).  The JAX
script's residency read-backs have no counterpart (a tensor on the card is
resident once its copy returns), nor its optional profiler trace
(`trace_dir`; `utils.timing.trace_to` profiles any call).  On the CPU the
host clock times plain loops.  Nothing is written but `--out`.
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
    timed,
)
from hcrag_tpu_torch.utils.bounds import PEAK_BYTES
from hcrag_tpu_torch.utils.timing import graph_ms

PASSES = 16
COPY_SCALE = 1.0009765625
TILE_N, SEED = 2048, 7
CPU_SIZE = dict(n=16_384, d=128)


def banks(dev: torch.device, n: int = 1_000_000, d: int = 384):
    """(bf16 bank, int8 bank) [n_pad, d] on `dev` from the JAX script's
    draw, n_pad = n rounded up to whole tiles."""
    n_pad = -(-n // TILE_N) * TILE_N
    rng = np.random.default_rng(SEED)
    e = normal_rows(rng, n_pad, d, dev, normalize=False)
    return e.to(torch.bfloat16), (e * 16).clamp(-127, 127).to(torch.int8)


def reduce_f32(e: torch.Tensor) -> torch.Tensor:
    return torch.sum(e, dtype=torch.float32)


def reduce_words(e: torch.Tensor) -> torch.Tensor:
    """The largest of `e`'s bytes taken as 32-bit words."""
    return e.view(torch.int32).amax()


def variants(bf16: torch.Tensor, int8: torch.Tensor) -> Dict[str, Callable]:
    """Each timed variant as a call, under its key (the folded rows time
    `PASSES` of these calls in one graph)."""
    mib = lambda t: f"{round(t.numel() * t.element_size() / 2**20)}MiB"  # noqa: E731
    scale = float(torch.tensor(COPY_SCALE, dtype=bf16.dtype))
    return {
        f"xla_reduce_bf16_{mib(bf16)}": lambda: reduce_f32(bf16),
        f"xla_reduce_int8_{mib(int8)}": lambda: reduce_words(int8),
        f"folded_reduce_bf16_{PASSES}x": lambda: reduce_f32(bf16),
        f"folded_reduce_int8_{PASSES}x": lambda: reduce_words(int8),
        "xla_copy_bf16_rw": lambda: bf16 * scale,
    }


def run(device: Union[str, torch.device, None] = "cuda", n: int = 1_000_000, d: int = 384,
        steps: int = 20, data=None) -> Dict:
    """Measure every row (module docstring); `data` = `banks(...)` replaces
    n and d.  Returns the result dict."""
    dev = device_of(device)
    with timed("gen"):
        bf16, int8 = data if data is not None else banks(dev, n, d)
    calls = variants(bf16, int8)
    nbytes = {key: (int8 if "int8" in key else bf16).numel()
              * (1 if "int8" in key else 2) for key in calls}
    res: Dict = {}
    for key, fn in calls.items():
        if key.startswith("folded"):
            t_ms = (graph_ms(fn, calls=PASSES, replays=4) if dev.type == "cuda"
                    else ms(fn, dev, PASSES))
        else:
            t_ms = ms(fn, dev, steps)
        moved = nbytes[key] * (2 if "copy" in key else 1)
        res[key] = moved / (t_ms / 1e3) / 2**30
        log(f"[{key}] {t_ms:.4f} ms a {'copy' if 'copy' in key else 'read'} -> "
            f"{res[key]:.1f} GiB/s")
    peak = PEAK_BYTES / 2**30
    res["assumed_peak_gib_s"] = peak
    res["share_of_assumed_peak"] = {k: res[k] / peak for k in calls}
    res["gb_s"] = {k: res[k] * 2**30 / 1e9 for k in calls}
    res["device"] = device_name(dev)
    res["shapes"] = dict(n=bf16.shape[0], d=bf16.shape[1], passes=PASSES)
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
