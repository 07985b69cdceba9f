"""Activation registry (``papr_tpu/nn/activations.py``).

Stateless activations are plain ``f(x)`` closures from
:func:`build_activation`; the parametric family can read trainable ``a``/``b``
(and PReLU slopes) from a per-instance params dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TRAINABLE_A = ("gaussian", "quadratic", "multi-quadratic", "laplacian",
                "expsin")


def activation_param_init(act_type: str, a: float = 1.0, b: float = 1.0,
                          trainable: bool = False,
                          num_channels: int | None = None,
                          device=None) -> dict:
    """Per-instance trainable params for ``act_type`` (possibly empty)."""
    act_type = act_type.lower()
    full = lambda n, v: torch.full((n,), v, dtype=torch.float32, device=device)
    if act_type == "prelu":
        return {"slope": full(int(num_channels) if num_channels else 1, 0.25)}
    if not trainable:
        return {}
    if act_type in _TRAINABLE_A:
        return {"a": full(1, a)}
    if act_type == "super-gaussian":
        return {"a": full(1, a), "b": full(1, b)}
    return {}


def apply_activation(act_type: str, x: torch.Tensor, params: dict | None = None,
                     neg_slope: float = 0.2, a=1.0, b=1.0) -> torch.Tensor:
    """Apply the named activation, drawing ``a``/``b``/PReLU slopes from
    ``params`` when present (else the build-time constants)."""
    act_type = act_type.lower()
    p = params or {}
    cast = lambda v: v.to(x.dtype) if torch.is_tensor(v) else v
    a = cast(p.get("a", a))
    b = cast(p.get("b", b))

    if act_type == "none":
        return x
    if act_type == "leakyrelu":
        return torch.where(x >= 0, x, neg_slope * x)
    if act_type == "prelu":
        slope = cast(p.get("slope", 0.25))
        return torch.where(x >= 0, x, slope * x)
    if act_type == "relu":
        return torch.clamp_min(x, 0)
    if act_type == "+1":
        return x + 1
    if act_type == "relu+1":
        return torch.clamp_min(x, 0) + 1
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "shifted_tanh":
        return (torch.tanh(x) + 1) / 2
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="none")
    if act_type == "gaussian":
        return torch.exp(-x ** 2 / (2 * a ** 2))
    if act_type == "quadratic":
        return 1 / (1 + (a * x) ** 2)
    if act_type == "multi-quadratic":
        return 1 / (1 + (a * x) ** 2) ** 0.5
    if act_type == "laplacian":
        return torch.exp(-torch.abs(x) / a)
    if act_type == "super-gaussian":
        return torch.exp(-x ** 2 / (2 * a ** 2)) ** b
    if act_type == "expsin":
        return torch.exp(-torch.sin(a * x))
    if act_type == "clamp":
        return torch.clamp(x, 0.0, 1.0)
    if "sine" in act_type:
        return torch.sin(a * x)
    if "softplus" in act_type:
        # "softplus_a_b_c" -> a * softplus(b * x + c)
        c1, c2, c3 = [float(v) for v in act_type.split("_")[1:]]
        return c1 * F.softplus(c2 * x + c3)
    raise NotImplementedError(f"activation [{act_type}] is not found")


def build_activation(act_type: str = "leakyrelu", neg_slope: float = 0.2,
                     a: float = 1.0, b: float = 1.0):
    """Return a pure ``f(x) -> x`` with build-time constants."""
    return lambda x: apply_activation(act_type, x, None, neg_slope, a, b)
