"""Interleaved sinusoidal positional encoding (``papr_tpu/nn/posenc.py``).

Every input dimension's ``[x, sin(f^0 x), cos(f^0 x), ..., sin(f^{L-1} x),
cos(f^{L-1} x)]`` block stays contiguous — NOT the frequency-major NeRF
layout.
"""

from __future__ import annotations

import torch


def posenc(x: torch.Tensor, L_embed: int, factor: float = 2.0,
           without_self: bool = False, mult_factor: float = 1.0) -> torch.Tensor:
    """Encode ``x (..., D)`` to ``(..., D * (2L [+1]))`` interleaved per-dim."""
    parts = [] if without_self else [x]
    for i in range(L_embed):
        scaled = (factor ** i) * x * mult_factor
        parts.append(torch.sin(scaled))
        parts.append(torch.cos(scaled))
    stacked = torch.stack(parts, dim=-1)  # (..., D, 2L[+1])
    return stacked.reshape(*x.shape[:-1], -1)
