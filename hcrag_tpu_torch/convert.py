"""Carry the JAX engine's device state into the port.

`bank_from_numpy` turns the arrays of the JAX engine's `_bank()` (as numpy
arrays) into tensors under the same keys, in the dtypes the port's engine
keeps: uint32 bitsets travel as int32 words with the same bits, and
bfloat16 rows keep their bits.  That covers the float banks (an f32 `emb`,
or a bf16 `emb` beside an f32 `emb_f32`) and the int8 ones: `emb_int8`
with its `emb_scale`, the residual level `emb_res8` / `emb_res_scale`, and
a bf16 `emb` beside them (none in int8-only residency).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

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
