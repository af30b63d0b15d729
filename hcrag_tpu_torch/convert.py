"""Carry the JAX engine's device state into the port.

`bank_from_numpy` turns the arrays of the JAX engine's `_bank()` (as numpy
arrays) into tensors under the same keys, in the dtypes the port's engine
keeps: uint32 bitsets travel as int32 words with the same bits, and
bfloat16 rows keep their bits.  That covers the float banks (an f32 `emb`,
or a bf16 `emb` beside an f32 `emb_f32`) and the int8 ones: `emb_int8`
with its `emb_scale`, the residual level `emb_res8` / `emb_res_scale`, and
a bf16 `emb` beside them (none in int8-only residency).

`reranker_state_from_flax` and `reranker_flax_params` carry the learned
re-ranker's parameters between the Flax tree (`{"params": {"Dense_i":
{"kernel" [in, out], "bias"}}}`) and `models/reranker.RerankerMLP`'s
state dict (`layers.i.weight` [out, in], `layers.i.bias`): the kernels are
transposed, the biases copied.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from hcrag_tpu_torch.device import resolve_device


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def bank_from_numpy(
    jax_bank: Dict[str, np.ndarray],
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, torch.Tensor]:
    """{key: numpy array of the JAX engine's bank} -> {key: tensor on
    `device`} (CUDA unless another device is named)."""
    dev = resolve_device(device)
    return {key: _tensor(np.asarray(a)).to(dev) for key, a in jax_bank.items()}


#: The re-ranker's dense layers, input to output.
RERANKER_LAYERS = 3
#: (layer, leaf) of each Flax parameter in the JAX package's tree-flatten
#: order: Dense_0/bias, Dense_0/kernel, Dense_1/bias, ... .
_RERANKER_LEAVES = [(i, leaf) for i in range(RERANKER_LAYERS) for leaf in ("bias", "kernel")]


def reranker_leaves(state: Dict[str, torch.Tensor]) -> List[np.ndarray]:
    """A `RerankerMLP` state dict (or any tensors under its names, such as
    the optimizer's moments) as the Flax leaves in the JAX package's
    flatten order, kernels [in, out]."""
    out = []
    for i, leaf in _RERANKER_LEAVES:
        name = f"layers.{i}.{'weight' if leaf == 'kernel' else 'bias'}"
        a = state[name].detach().cpu().numpy()
        out.append(np.ascontiguousarray(a.T) if leaf == "kernel" else a)
    return out


def reranker_state_from_leaves(leaves) -> Dict[str, torch.Tensor]:
    """The inverse of `reranker_leaves`: f32 tensors on the CPU under the
    `RerankerMLP` state dict's names."""
    out = {}
    for (i, leaf), a in zip(_RERANKER_LEAVES, leaves):
        a = np.asarray(a, np.float32)
        if leaf == "kernel":
            out[f"layers.{i}.weight"] = _tensor(a.T)
        else:
            out[f"layers.{i}.bias"] = _tensor(a)
    return out


def reranker_state_from_flax(params) -> Dict[str, torch.Tensor]:
    """A Flax re-ranker tree (with or without its "params" level) as a
    `RerankerMLP` state dict on the CPU."""
    tree = params.get("params", params)
    return reranker_state_from_leaves(
        [tree[f"Dense_{i}"][leaf] for i, leaf in _RERANKER_LEAVES])


def reranker_flax_params(state: Dict[str, torch.Tensor]) -> Dict:
    """A `RerankerMLP` state dict as the Flax tree `{"params": {...}}` of
    numpy arrays."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for (i, leaf), a in zip(_RERANKER_LEAVES, reranker_leaves(state)):
        tree.setdefault(f"Dense_{i}", {})[leaf] = a
    return {"params": tree}
