"""Bytes per collective of the sharded retrieval step at 2, 4 and 8 ranks.

    python -m hcrag_tpu_torch.benchmarks.sharded_traffic                # ranks on one NVIDIA GPU
    python -m hcrag_tpu_torch.benchmarks.sharded_traffic --device cpu   # ranks on the CPU

Counterpart of `benchmarks/sharded_traffic.py`.  The JAX script lowers the
sharded step on a virtual mesh and walks the compiled HLO for its
collectives.  The port has no compiled program to walk: every tensor that
crosses ranks goes through `parallel/sharded_ops._collective`, so the
script counts there, at run time, the kind and the bytes of each call
(the output's payload, as the HLO's result shape gives it).

The step is the JAX script's: `sharded_top_k` of B=8 normalized queries
over n=4096 normalized rows of d=128 (numpy `default_rng(0)`, rows first)
split contiguously over s ranks, top_k=10, `fetch_k=32`, the exact rescore
from the f32 rows.  Each rank selects its 32 candidates with the f32
mode's kernel, B4 (`cosine_top_k` with no merge oversample).  One spawn
of max(s) gloo ranks (`parallel/launch.run_ranks`; on the card they share
it) runs every s: the first s ranks form that mesh, with a group of their
own.  For each s it prints the JAX keys — `all_gather_bytes` beside the
model `all_gather_model_s*B*m*8` (values f32 + indices int32 [s, B, m]),
`all_reduce_bytes` beside `all_reduce_model_B*m*4` (the rescore's [B, m]
scores, not its rows) — and `collectives` (each call: kind, dtype, shape,
bytes), and under `summary` JAX's two scaling statements (generalized to
any pair of shard counts) and `matches_model`; `top10_equals_f32_brute`
checks every rank's result against the f32 brute force, and `launches`
rank 0's B4 launches.  No byte here crossed a wire: the ranks share one
machine.  Nothing is written but `--out`.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence, Union

import numpy as np
import torch

from hcrag_tpu_torch.benchmarks._common import (
    brute_force_top_k,
    device_of,
    finish,
    log,
    parser,
)

N, D, B, K, M = 4096, 128, 8, 10, 32
SHARDS = (2, 4, 8)


def step_inputs(n: int = N, d: int = D, b: int = B):
    """The JAX script's rows and queries (`default_rng(0)`, rows first)."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q


def b4_select(q, banks, mask, top_k, fetch_k):
    """A rank's candidates: kernel B4's exact top max(top_k, fetch_k) of
    its block, ties to the lowest row."""
    from hcrag_tpu_torch.ops.topk_cuda import cosine_top_k

    return cosine_top_k(q, banks["emb"], mask, max(top_k, fetch_k))


def traffic_rank(rank: int, world: int, shards: Sequence[int], device: str, n: int, d: int,
                 b: int, k: int, m: int) -> Dict:
    """One rank: for each s, the step over a mesh of ranks 0..s-1 with the
    collectives recorded.  Every rank makes every group, in order."""
    import torch.distributed as dist

    from hcrag_tpu_torch.ops import topk_cuda as tc
    from hcrag_tpu_torch.parallel import sharded_ops
    from hcrag_tpu_torch.parallel.mesh import ROWS_AXIS, Mesh

    dev = torch.device("cpu")
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    emb, q = step_inputs(n, d, b)
    out = {}
    for s in shards:
        group = dist.new_group(list(range(s)))
        if rank >= s:
            continue
        mesh = Mesh(shape={ROWS_AXIS: s}, coords={ROWS_AXIS: rank},
                    groups={ROWS_AXIS: group}, device=dev, backend=dist.get_backend(),
                    world=group, timeout=None)
        per = n // s
        block = torch.from_numpy(emb[rank * per:(rank + 1) * per]).to(dev)
        calls = []
        real = sharded_ops._collective

        def recording(kind, tensor, grp):
            got = real(kind, tensor, grp)
            calls.append((kind, str(got.dtype).replace("torch.", ""), list(got.shape),
                          got.numel() * got.element_size()))
            return got

        before = tc.float_tile_topk.launches
        sharded_ops._collective = recording
        try:
            v, i = sharded_ops.sharded_top_k(
                mesh, torch.from_numpy(q).to(dev), block, k, fetch_k=m,
                banks={"emb_f32": block}, rescore_key="emb_f32", local_select=b4_select)
        finally:
            sharded_ops._collective = real
        out[s] = dict(calls=calls, values=v.cpu().numpy(), indices=i.cpu().numpy(),
                      b4_launches=tc.float_tile_topk.launches - before)
    return out


def run(device: Union[str, torch.device, None] = "cuda", shards: Sequence[int] = SHARDS,
        n: int = N, d: int = D, b: int = B, k: int = K, m: int = M) -> Dict:
    from hcrag_tpu_torch.parallel.launch import run_ranks

    dev = device_of(device)
    if dev.type == "cuda":  # once here, not in every rank at once
        from hcrag_tpu_torch.ops import _build

        _build.build(("float_tile_topk",))
    if any(n % s for s in shards):
        raise ValueError(f"n={n} must split evenly over {tuple(shards)} ranks")
    world = max(shards)
    ranks = run_ranks(traffic_rank, world, args=(tuple(shards), dev.type, n, d, b, k, m))
    emb, q = step_inputs(n, d, b)
    ref = brute_force_top_k(emb, q, k)
    table, exact = {}, True
    for s in shards:
        calls = ranks[0][s]["calls"]
        gather = sum(c[3] for c in calls if c[0] == "all_gather")
        reduce = sum(c[3] for c in calls if c[0] == "all_reduce")
        table[f"shards_{s}"] = {
            "all_gather_bytes": gather, "all_gather_model_s*B*m*8": s * b * m * 8,
            "all_reduce_bytes": reduce, "all_reduce_model_B*m*4": b * m * 4,
            "collectives": [dict(op=c[0], dtype=c[1], shape=c[2], bytes=c[3]) for c in calls],
            "launches": {"float_tile_topk": ranks[0][s]["b4_launches"]},
        }
        for r in range(s):
            same = (ranks[r][s]["calls"] == calls
                    and np.array_equal(ranks[r][s]["indices"], ref))
            exact = exact and same
        log(f"shards={s}: all-gather {gather} B (model {s * b * m * 8}), all-reduce "
            f"{reduce} B (model {b * m * 4})")
    lo, hi = min(shards), max(shards)
    g = {s: table[f"shards_{s}"]["all_gather_bytes"] for s in shards}
    r = {s: table[f"shards_{s}"]["all_reduce_bytes"] for s in shards}
    summary = {
        "merge_traffic_scales_linearly_in_shards":
            abs(g[hi] / g[lo] - hi / lo) < 0.26 * (hi / lo) / 4,
        "rescore_traffic_constant_in_shards": len(set(r.values())) == 1,
        "matches_model": all(
            t["all_gather_bytes"] == t["all_gather_model_s*B*m*8"]
            and t["all_reduce_bytes"] == t["all_reduce_model_B*m*4"] for t in table.values()),
        "top10_equals_f32_brute": exact,
        "config": {"batch": b, "top_k": k, "merge_m": m, "rows": n, "dim": d},
        "device": dev.type,
    }
    return {"summary": summary, **table}


def main(argv=None) -> int:
    p = parser(__doc__)
    p.add_argument("--shards", default=",".join(map(str, SHARDS)),
                   help="comma-separated shard counts (2,4,8)")
    args = p.parse_args(argv)
    dev = device_of(args.device)
    finish(run(dev, tuple(int(s) for s in args.shards.split(","))), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
