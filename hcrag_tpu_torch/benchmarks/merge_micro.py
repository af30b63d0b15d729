"""The cross-tile candidate merge (kernel B2) against plain alternatives.

    python -m hcrag_tpu_torch.benchmarks.merge_micro                # one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.merge_micro --device cpu   # a small size

Counterpart of `benchmarks/merge_micro.py`, over the same pool (numpy
`default_rng(0)`: values [512, 4890] standard normal f32, indices
[512, 4890] int32 in [0, 1,000,000): the 489 tiles x k=10 of a 1M-row
selection), keeping 32.  Under the JAX script's keys, ms per call of:

  xla_topk_ms        `torch.topk(v, 32)` + a gather of the indices: the
                     counterpart of `lax.top_k` + `take_along_axis`;
  argmax32_ms        32 passes of max, first argmax and mask, in PyTorch;
  packed_pallas_ms   kernel B2 (`packed_candidate_merge`), the port's
                     production merge and the counterpart of JAX's
                     `_packed_candidate_merge`, which the JAX docstring
                     names packed_pallas: the pool as 4890 one-candidate
                     tiles, so that ties go to the lowest column as there.
                     Its values carry the packed key's 2^-11 quantization.

On the card 20 calls are captured in one CUDA graph and replayed
(`utils.timing.graph_ms`), as JAX folds 20 calls into one scan to keep the
per-call launch out.  `approx_max_k_ms` has no counterpart: PyTorch has no
approximate top-k, so the key is left out.  On the CPU the host clock
times plain loops.  Nothing is written but `--out`.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import device_name, device_of, finish, log, ms, parser
from hcrag_tpu_torch.ops import topk_cuda as tc
from hcrag_tpu_torch.utils.timing import graph_ms

B, NT, K, M = 512, 489, 10, 32
REPS = 20
SEED = 0
CPU_SIZE = dict(b=64, c=4890)


def pool(dev: torch.device, b: int = B, c: int = NT * K) -> Tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(SEED)
    vals = rng.standard_normal((b, c)).astype(np.float32)
    idxs = rng.integers(0, 1_000_000, size=(b, c)).astype(np.int32)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(idxs).to(dev)


def torch_topk(v: torch.Tensor, i: torch.Tensor, m: int = M):
    ov, pos = torch.topk(v, m, dim=1)
    return ov, torch.gather(i, 1, pos)


def argmax32(v: torch.Tensor, i: torch.Tensor, m: int = M):
    col = torch.arange(v.shape[1], device=v.device)[None, :]
    outs_v, outs_p = [], []
    for _ in range(m):
        best = v.max(dim=1).values
        first = torch.argmax((v == best[:, None]).to(torch.int8), dim=1)
        outs_v.append(best)
        outs_p.append(first)
        v = torch.where(col == first[:, None], float("-inf"), v)
    pos = torch.stack(outs_p, dim=1)
    return torch.stack(outs_v, dim=1), torch.gather(i, 1, pos)


def packed_merge(v: torch.Tensor, i: torch.Tensor, m: int = M):
    b, c = v.shape
    return tc.packed_candidate_merge(v.view(b, c, 1), i.view(b, c, 1), m)


def variants(v: torch.Tensor, i: torch.Tensor) -> Dict[str, Callable]:
    return {"xla_topk_ms": lambda: torch_topk(v, i), "argmax32_ms": lambda: argmax32(v, i),
            "packed_pallas_ms": lambda: packed_merge(v, i)}


def run(device: Union[str, torch.device, None] = "cuda", b: int = B, c: int = NT * K) -> Dict:
    dev = device_of(device)
    v, i = pool(dev, b, c)
    res: Dict = {}
    for key, fn in variants(v, i).items():
        res[key] = graph_ms(fn, calls=REPS, replays=5) if dev.type == "cuda" else ms(fn, dev, 3)
        log(f"{key[:-3]}: {res[key]:.4f} ms")
    res["device"] = device_name(dev)
    res["shapes"] = dict(b=b, c=c, keep=M, calls_per_graph=REPS)
    return res


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, **(CPU_SIZE if dev.type == "cpu" else {})), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
