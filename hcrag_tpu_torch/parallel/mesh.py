"""Meshes of ranks for the sharded engine, on `torch.distributed`.

Counterpart of `hcrag_tpu/parallel/mesh.py`.  JAX runs one controller over
a mesh of devices; the port runs one process per rank, as DDP does, and a
mesh here is this process's view of the grid: the axis sizes, its
coordinates on them, and the process group along each axis through which
its collectives go.  Ranks are laid out row-major over the axes, as
`jax.make_mesh` lays out devices: on a (batch, rows) mesh rank
`b * rows + r` sits at (b, r).

The groups are made with `dist.new_group` over the default group, not with
`init_device_mesh`: the backend then follows the default group, so ranks
that share one card run gloo over CUDA tensors (NCCL refuses two ranks on
one card), where `init_device_mesh("cuda", ...)` would ask for NCCL
groups.  Every rank creates every group, in the same order.

Where no default group exists, the mesh makes one: under `torchrun` from
its environment (`env://`), else a world of one rank in memory (a
`HashStore`), so a single plain process needs no launcher.  Its backend is
NCCL when every rank has a card of its own, else gloo (the CPU, or ranks
sharing a card); a `cuda` mesh without CUDA raises (`resolve_device`).

A `timeout` bounds every collective over the mesh's groups: they are then
made with it (and so is the default group, where the mesh makes it), so a
rank whose partner never joins raises instead of waiting torch's default
(30 minutes for gloo).  Without one, the row mesh's group is the default
group itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from hcrag_tpu_torch.device import resolve_device

#: Mesh axis over which index rows (and, optionally, graph tables) are split.
ROWS_AXIS = "rows"
#: Optional second axis over which the query batch is split.
BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a grid of ranks.

    `shape` maps each axis, in order, to its size; `coords` gives this
    rank's index on each axis; `groups` the process group of the ranks that
    differ from this one along that axis alone (their group ranks are their
    coordinates on it); `world` the group of every rank of the mesh (group
    rank = global rank); `device` is this rank's device; `timeout` the
    groups' collective timeout (None: torch's default)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    device: torch.device
    backend: str
    world: object
    timeout: Optional[datetime.timedelta]

    @property
    def size(self) -> int:
        """Ranks in the mesh."""
        n = 1
        for s in self.shape.values():
            n *= s
        return n


def _backend(device: torch.device, world: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    """A `cuda` device without an index becomes the rank's own card
    (`LOCAL_RANK` under torchrun), wrapping round when ranks outnumber
    cards."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _ensure_default_group(device: torch.device, timeout) -> torch.device:
    """The default process group (made if absent, with `timeout`) and this
    rank's device."""
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            world = int(os.environ["WORLD_SIZE"])
            dev = _rank_device(device, int(os.environ["RANK"]))
            backend = _backend(dev, world)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend, init_method="env://", timeout=timeout,
                device_id=dev if backend == "nccl" else None,
            )
            return dev
        dev = _rank_device(device, 0)
        backend = _backend(dev, 1)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout,
            device_id=dev if backend == "nccl" else None,
        )
        return dev
    dev = _rank_device(device, dist.get_rank())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _make_mesh(axes: Tuple[str, ...], sizes: Tuple[int, ...], device, timeout) -> Mesh:
    dev = _ensure_default_group(resolve_device(device), timeout)
    world, rank = dist.get_world_size(), dist.get_rank()
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(
            f"a mesh of {dict(zip(axes, sizes))} needs {total} ranks; the "
            f"default group has {world}"
        )
    # Every rank creates every group, in this order.
    world_group = (dist.group.WORLD if timeout is None
                   else dist.new_group(list(range(world)), timeout=timeout))
    if len(axes) == 1:
        groups = {axes[0]: world_group}
        coords = {axes[0]: rank}
    else:
        nb, nr = sizes
        b, r = divmod(rank, nr)
        coords = {axes[0]: b, axes[1]: r}
        groups = {}
        for i in range(nb):
            g = dist.new_group([i * nr + j for j in range(nr)], timeout=timeout)
            if i == b:
                groups[axes[1]] = g
        for j in range(nr):
            g = dist.new_group([i * nr + j for i in range(nb)], timeout=timeout)
            if j == r:
                groups[axes[0]] = g
    return Mesh(
        shape=dict(zip(axes, sizes)), coords=coords, groups=groups,
        device=dev, backend=dist.get_backend(), world=world_group, timeout=timeout,
    )


def make_row_mesh(
    num_devices: Optional[int] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> Mesh:
    """1-D mesh over every rank of the default group (made if absent; see
    the module's docstring).  `num_devices`, where given, must be the world
    size: a rank outside the mesh would have nothing to run.  `device`
    defaults to CUDA (this rank's card); `timeout` bounds the mesh's
    collectives (see the module's docstring)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    if num_devices is not None and world is not None and num_devices != world:
        raise ValueError(
            f"make_row_mesh({num_devices}): the default group has {world} "
            "ranks; start as many ranks as the mesh has shards"
        )
    size = num_devices if num_devices is not None else (
        world if world is not None else int(os.environ.get("WORLD_SIZE", 1))
    )
    return _make_mesh((ROWS_AXIS,), (size,), device, timeout)


def make_batch_row_mesh(
    batch: int, rows: int, *, device: Optional[Union[str, torch.device]] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> Mesh:
    """2-D (batch, rows) mesh: queries split over `batch`, index rows over
    `rows`; batch x rows must be the world size.  `timeout` as in
    `make_row_mesh`."""
    return _make_mesh((BATCH_AXIS, ROWS_AXIS), (batch, rows), device, timeout)


def row_sharding(mesh: Mesh):
    """The placement of [N, ...] tensors split along the rows axis (and
    replicated along any other), one entry per mesh axis, as
    `torch.distributed.tensor` states placements."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if a == ROWS_AXIS else Replicate() for a in mesh.shape)


def replicated(mesh: Mesh):
    """The placement of tensors held whole on every rank."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.shape)
