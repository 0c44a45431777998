"""Weight initialisers of the port, each drawing from an explicit
``torch.Generator`` (flax's truncated-normal variance scaling)."""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def variance_scaling(shape, fan_in: int, scale: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Truncated normal with variance ``scale / fan_in``, drawn on the CPU."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return t


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    """flax ``glorot_uniform``: uniform on [-l, l], l = sqrt(6 / (fan_in +
    fan_out)), drawn on the CPU."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    t = torch.empty(shape, dtype=torch.float32)
    return t.uniform_(-limit, limit, generator=generator)
