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
restoring into the wrong slots.  `optax_adamw` builds a torch AdamW with
optax.adamw's settings; `adamw_state` / `set_adamw_state` read and set its
state as optax keeps it: one count, and the moments by parameter name.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


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


def optax_adamw(params, lr: float, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """torch's AdamW with optax.adamw's b1, b2 and eps, over every
    parameter (optax's mask is None, so biases and LayerNorms decay too)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def adamw_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                ) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(Adam's count, first moments, second moments) of `optimizer` over
    `model`'s parameters, the moments keyed by parameter name; before the
    first step the count is 0 and the moments zero."""
    named = dict(model.named_parameters())
    states = [optimizer.state.get(p, {}) for p in named.values()]
    if not states[0]:
        zeros = {name: torch.zeros_like(p) for name, p in named.items()}
        return 0, zeros, zeros
    return (int(states[0]["step"]),
            {name: st["exp_avg"] for name, st in zip(named, states)},
            {name: st["exp_avg_sq"] for name, st in zip(named, states)})


def set_adamw_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer, count: int,
                    exp_avg: Dict[str, torch.Tensor], exp_avg_sq: Dict[str, torch.Tensor]) -> None:
    """Set AdamW's state over `model`'s parameters: torch's per-parameter
    step from optax's one count, the moments by parameter name."""
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }
