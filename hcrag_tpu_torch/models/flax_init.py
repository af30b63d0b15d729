"""Flax's `Dense` initialization for `nn.Linear`, shared by the encoder and
the re-ranker so that a fresh module draws as the JAX package's does."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

#: Flax's truncated normal keeps [-2, 2]; this is that truncation's
#: standard deviation, which `lecun_normal` divides out.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(layer: nn.Linear, generator: Optional[torch.Generator] = None) -> None:
    """Initialize `layer` as Flax's `Dense` does: the kernel LeCun normal
    (a normal truncated at two standard deviations, scaled to variance
    1/fan_in), the bias zero."""
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.mul_(math.sqrt(1.0 / layer.in_features) / _TRUNC_STD)
        layer.bias.zero_()
