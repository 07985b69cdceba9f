"""LayerNorm with the reference's formula (``papr_tpu/nn/norm.py``).

Normalizes by ``std + eps`` where ``std`` is the *unbiased* standard
deviation (ddof=1), with float32 statistics whatever the compute dtype.
"""

from __future__ import annotations

import torch


def layernorm_init(features: int, device=None) -> dict:
    return {"a": torch.ones(features, dtype=torch.float32, device=device),
            "b": torch.zeros(features, dtype=torch.float32, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    out_dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = xf.shape[-1]
    var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    std = torch.sqrt(var)
    y = params["a"] * (xf - mean) / (std + eps) + params["b"]
    return y.to(out_dtype)
