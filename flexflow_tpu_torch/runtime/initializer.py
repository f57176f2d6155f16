"""Weight initializers.

PyTorch counterpart of ``flexflow_tpu/runtime/initializer.py``: the same
distributions and fan rules, drawn from an explicit ``torch.Generator``
instead of a JAX key. The two packages draw different numbers from the same
seed; tests copy the JAX params across with ``load_numpy_params``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape: Tuple[int, ...],
                 dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniformInitializer(Initializer):
    """Glorot uniform with the JAX package's fan rule (fan_in/fan_out over
    the last two dims, receptive field = the leading dims)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, gen, shape, dtype, device):
        if len(shape) < 2:
            fan_in = fan_out = shape[0] if shape else 1
        else:
            receptive = math.prod(shape[:-2])
            fan_in = shape[-2] * receptive
            fan_out = shape[-1] * receptive
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        return (u * (2 * limit) - limit).to(dtype)


class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


DefaultWeightInitializer = GlorotUniformInitializer
DefaultBiasInitializer = ZeroInitializer
