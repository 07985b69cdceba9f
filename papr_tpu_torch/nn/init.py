"""Parameter initializers with torch's distributions (``papr_tpu/nn/init.py``).

Every draw takes an explicit ``torch.Generator``; samples are drawn on the
generator's device (CPU by default) and then moved, so a seed gives the same
weights whatever the target device.
"""

from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            device=None) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (lo + (hi - lo) * u).to(device)


def xavier_uniform(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ for an (out, in) weight matrix."""
    fan_out, fan_in = shape[0], shape[1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(gen, shape, -bound, bound, device)


def fan_in_bias(gen: torch.Generator, fan_in: int, out_features: int,
                device=None) -> torch.Tensor:
    """torch.nn.Linear's and Conv2d's default bias:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return uniform(gen, (out_features,), -bound, bound, device)


def kaiming_uniform_conv(gen: torch.Generator, shape,
                         device=None) -> torch.Tensor:
    """torch.nn.Conv2d's default weight init; ``shape`` is HWIO."""
    kh, kw, in_c, _ = shape
    fan_in = kh * kw * in_c
    gain = math.sqrt(2.0 / (1 + 5.0))
    bound = gain * math.sqrt(3.0 / fan_in)
    return uniform(gen, shape, -bound, bound, device)
