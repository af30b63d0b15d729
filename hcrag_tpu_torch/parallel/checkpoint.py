"""Sharded index checkpoints: each rank writes and reads its own blocks.

Counterpart of `hcrag_tpu/parallel/checkpoint.py`, which writes through
orbax.  The port's layout, in one directory:

  * `manifest.json`: the mesh's shape, the rows per shard, the engine's
    mode, and for every tensor its key, placement (`rows`: split over the
    rows axis, or `replicated`), global shape and dtype;
  * `rows-<j>.npz` (uncompressed): the blocks of the row-split tensors that
    the ranks at coordinate j of the rows axis hold, written by the first
    of them (the ranks along a batch axis hold the same blocks);
  * `replicated.npz`: the tensors held whole, written once, by rank 0.

No rank gathers another's rows, so a 10M-row bank is written and read in
parallel, a block per rank.  A restore needs the same mesh shape and the
same engine mode, and refuses any other with a `ValueError` that names the
difference.  bfloat16 tensors are stored as their 16-bit patterns (numpy
has no bfloat16) and the manifest keeps their dtype.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from hcrag_tpu_torch.parallel.mesh import ROWS_AXIS

#: (key, engine attribute) of every device tensor an engine may carry: an
#: int8 or dual-residency engine selects and rescores from emb_int8,
#: emb_scale and emb_f32, so leaving out a bank it holds would restore
#: stale selection or rescore rows.
_BANK_ATTRS = (
    ("emb", "d_emb"),
    ("emb_int8", "d_emb_int8"),
    ("emb_scale", "d_emb_scale"),
    ("emb_f32", "d_emb_f32"),
    ("emb_res8", "d_emb_res8"),
    ("emb_res_scale", "d_emb_res_scale"),
    ("type_ids", "d_type_ids"),
    ("entity_bits", "d_bits"),
    ("entity_counts", "d_counts"),
    ("graph_ids", "d_graph_ids"),
    ("neighbors", "d_neighbors"),
    ("neighbors_hop2", "d_neighbors_hop2"),
    ("g_type_ids", "d_g_type_ids"),
    ("g_row", "d_g_row"),
)

#: The engine attributes that fix which banks exist and what they hold.
_MODE_ATTRS = (
    "quantize_int8", "int8_only", "int8_residual", "int8_rescore",
    "int8_f32_rescore", "exact_rescore", "pallas_super", "bank_dtype",
    "shard_graph",
)


def _engine_tree(engine) -> Dict[str, torch.Tensor]:
    return {
        key: getattr(engine, attr)
        for key, attr in _BANK_ATTRS
        if getattr(engine, attr, None) is not None
    }


def _is_split(engine, key: str) -> bool:
    """Whether the engine holds `key` as blocks of rows, one per shard."""
    return dict(_BANK_ATTRS)[key] in engine.split_attrs


def _describe(engine) -> Dict:
    """The manifest an engine would write: mesh, mode and every tensor."""
    mesh = engine.mesh
    n_split = mesh.shape[ROWS_AXIS]
    tensors = {}
    for key, t in _engine_tree(engine).items():
        split = _is_split(engine, key)
        shape = list(t.shape)
        if split:
            shape[0] *= n_split
        tensors[key] = {
            "placement": "rows" if split else "replicated",
            "shape": shape,
            "dtype": str(t.dtype).removeprefix("torch."),
        }
    return {
        "format": "hcrag_tpu_torch sharded index 1",
        "mesh_shape": dict(mesh.shape),
        "rows_per_shard": engine._n_bank // n_split,
        "n_rows": engine._n_rows,
        "mode": {a: getattr(engine, a) for a in _MODE_ATTRS},
        "tensors": tensors,
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def save_sharded_index(engine, directory) -> None:
    """Write the engine's device tensors (every bank its mode uses) under
    `directory`: each rank its own blocks, rank 0 the whole tensors and the
    manifest.  Every rank of the mesh calls it; it returns when all have
    written."""
    directory = Path(directory).absolute()
    mesh = engine.mesh
    directory.mkdir(parents=True, exist_ok=True)
    tree = _engine_tree(engine)
    first_of_rows = all(c == 0 for a, c in mesh.coords.items() if a != ROWS_AXIS)
    if first_of_rows:
        np.savez(
            directory / f"rows-{mesh.coords[ROWS_AXIS]}.npz",
            **{k: _to_numpy(t) for k, t in tree.items() if _is_split(engine, k)},
        )
    if dist.get_rank() == 0:
        np.savez(
            directory / "replicated.npz",
            **{k: _to_numpy(t) for k, t in tree.items() if not _is_split(engine, k)},
        )
        (directory / "manifest.json").write_text(json.dumps(_describe(engine), indent=1))
    dist.barrier()


def restore_sharded_index(engine, directory) -> None:
    """Read a checkpoint of `save_sharded_index` into an engine of the same
    mesh shape and mode: each rank reads its own blocks.  Raises
    `ValueError` naming the first difference in the mesh, the mode or a
    tensor's key, shape or dtype."""
    directory = Path(directory).absolute()
    saved = json.loads((directory / "manifest.json").read_text())
    want = _describe(engine)
    for field in ("mesh_shape", "rows_per_shard", "n_rows"):
        if saved[field] != want[field]:
            raise ValueError(
                f"checkpoint {field} {saved[field]} != the engine's {want[field]}"
            )
    for attr, value in want["mode"].items():
        if saved["mode"].get(attr) != value:
            raise ValueError(
                f"checkpoint mode {attr}={saved['mode'].get(attr)!r} != the "
                f"engine's {value!r}"
            )
    if set(saved["tensors"]) != set(want["tensors"]):
        raise ValueError(
            f"checkpoint tensors {sorted(saved['tensors'])} != the engine's "
            f"{sorted(want['tensors'])}"
        )
    for key, spec in want["tensors"].items():
        if saved["tensors"][key] != spec:
            raise ValueError(f"checkpoint {key} {saved['tensors'][key]} != the engine's {spec}")
    with np.load(directory / f"rows-{engine.mesh.coords[ROWS_AXIS]}.npz") as split, \
            np.load(directory / "replicated.npz") as whole:
        for key, attr in _BANK_ATTRS:
            if key in want["tensors"]:
                src = split if _is_split(engine, key) else whole
                setattr(engine, attr, _from_numpy(
                    src[key], want["tensors"][key]["dtype"], engine.device))
