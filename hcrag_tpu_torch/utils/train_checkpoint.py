"""Training-state checkpoint and resume: parameters, optimizer state, step.

Counterpart of `hcrag_tpu/utils/train_checkpoint.py`, in the same file
layout, so a checkpoint written by either package restores in the other:
one `.npz` holding `__step__` (int64), then `p/leaf_%05d` for the
parameters and `o/leaf_%05d` for the optimizer state, each list in the JAX
package's tree-flatten order.  The JAX side flattens pytrees; here the
caller hands the leaves over as lists in that order (`Reranker` maps its
modules and AdamW state onto them).  Restoring checks the leaf count and
every leaf's shape against templates of the model and optimizer as they
are now, so an architecture or optimizer change raises instead of
restoring into the wrong slots.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def _npz_path(path) -> Path:
    """The path with an explicit '.npz' suffix: `np.savez` appends one to a
    name without it, so save and restore normalize alike and every spelling
    names the same file."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def save_train_state(path, params: Sequence, opt_state: Sequence, step: int) -> None:
    """Write the parameter leaves, the optimizer-state leaves and the step
    counter to one .npz."""
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"__step__": np.asarray(step, np.int64)}
    for prefix, leaves in (("p", params), ("o", opt_state)):
        for i, leaf in enumerate(leaves):
            payload[f"{prefix}/leaf_{i:05d}"] = np.asarray(leaf)
    np.savez(path, **payload)


def restore_train_state(
    path, params_template: Sequence, opt_state_template: Sequence
) -> Tuple[List[np.ndarray], List[np.ndarray], int]:
    """(parameter leaves, optimizer-state leaves, step) from a checkpoint,
    each leaf cast to its template's dtype.  The leaf count and each leaf's
    shape must equal the templates' (ValueError otherwise)."""
    with np.load(_npz_path(path)) as data:
        step = int(data["__step__"])
        out = []
        for prefix, template in (("p", params_template), ("o", opt_state_template)):
            keys = [f"{prefix}/leaf_{i:05d}" for i in range(len(template))]
            missing = [k for k in keys if k not in data]
            if missing:
                saved = sum(1 for k in data.files if k.startswith(prefix + "/"))
                raise ValueError(
                    f"checkpoint {path} has {saved} '{prefix}' leaves, template "
                    f"expects {len(template)} (first missing: {missing[0]}) — "
                    "optimizer/model drift?"
                )
            restored = []
            for k, leaf in zip(keys, template):
                arr, want = data[k], np.asarray(leaf)
                if tuple(arr.shape) != tuple(want.shape):
                    raise ValueError(
                        f"{k}: saved shape {arr.shape} != template {want.shape}"
                    )
                restored.append(arr.astype(want.dtype))
            out.append(restored)
    return out[0], out[1], step
