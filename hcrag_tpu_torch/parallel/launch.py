"""Run a function on several ranks of one machine, each in its own process.

    from hcrag_tpu_torch.parallel.launch import run_ranks
    outs = run_ranks(my_module.work, 4, args=(...,))

`run_ranks` starts `world` processes with the `spawn` method (a parent that
holds a CUDA context cannot fork), joins them in one gloo process group (a
`FileStore` in a fresh temporary directory), calls `fn(rank, world, *args)`
on each, and returns each rank's return value in rank order.  `fn` and its
arguments are pickled, so `fn` must be importable by name.  A rank that
raises fails the whole run with its traceback; the other ranks are
terminated.  The group is gloo because these ranks share one machine and
may share one card, which NCCL refuses.  Ranks with a card each run under
`torchrun`, where no launcher is needed: `make_row_mesh` takes the group
from its environment and chooses NCCL.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback
from typing import Any, Callable, List, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, args, store_path, results) -> None:
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
        )
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(
    fn: Callable[..., Any],
    world: int,
    args: Sequence = (),
    *,
    timeout_s: float = 600.0,
) -> List[Any]:
    """`fn(rank, world, *args)` on `world` spawned ranks in one process
    gloo group; returns [rank 0's result, rank 1's, ...]."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(fn, r, world, tuple(args), store, results),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        outs, errors = {}, []
        try:
            # Drain the queue before joining: a rank blocks on a full pipe.
            for _ in range(world):
                rank, ok, value = results.get(timeout=timeout_s)
                if ok:
                    outs[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue.Empty:
            errors.append(f"no result from every rank within {timeout_s} s")
        finally:
            for p in procs:
                if errors:
                    p.terminate()
                p.join(timeout=60)
    if errors:
        raise RuntimeError("run_ranks failed: " + "\n".join(errors))
    return [outs[r] for r in range(world)]
