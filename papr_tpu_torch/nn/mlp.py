"""Generic MLP and FeedForward blocks (``papr_tpu/nn/mlp.py``).

Functional init/apply pairs over plain dicts of tensors, the same tree the
JAX package builds, so converted JAX parameters drop in leaf by leaf. This is
the unfused path; ``ops/fused_mlp.py`` holds the fused embedder kernel.

Supported layer machinery: ``skip_layers``, ``half_layers``,
``residual_layers``/``residual_dims``, torch-style weight normalization and
the FeedForward's dropout (training only, from an explicit
``torch.Generator``).
Matmuls run in ``policy.compute_dtype`` (bf16 when ``use_amp``); parameters
are stored fp32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .activations import activation_param_init, apply_activation
from .init import fan_in_bias, uniform, xavier_uniform
from .norm import layernorm_apply, layernorm_init

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


@dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: the dtype matmuls and convolutions run in."""
    compute_dtype: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


F32 = Policy(torch.float32)


def policy_from_config(cfg) -> Policy:
    """use_amp -> ``tpu.compute_dtype`` compute (bf16 by default)."""
    if cfg.use_amp:
        return Policy(_DTYPES[cfg.get_path("tpu.compute_dtype", "bfloat16")])
    return F32


# ---------------------------------------------------------------- linear ----

def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True, use_wn: bool = False, xavier: bool = True,
                device=None) -> dict:
    if xavier:
        w = xavier_uniform(gen, (out_dim, in_dim), device)
    else:
        w = uniform(gen, (out_dim, in_dim), -1.0, 1.0, device) / in_dim ** 0.5
    p: dict = {}
    if use_wn:
        # The reference xavier-inits v and keeps g at the per-row norm.
        p["v"] = w
        p["g"] = torch.linalg.norm(w, dim=1, keepdim=True)
    else:
        p["w"] = w
    if bias:
        p["bias"] = fan_in_bias(gen, in_dim, out_dim, device)
    return p


def linear_apply(params: dict, x: torch.Tensor,
                 policy: Policy = F32) -> torch.Tensor:
    if "v" in params:
        v = params["v"]
        w = params["g"] * v / torch.linalg.norm(v, dim=1, keepdim=True)
    else:
        w = params["w"]
    y = policy.cast(x) @ policy.cast(w).T
    if "bias" in params:
        y = y + policy.cast(params["bias"])
    return y


# ------------------------------------------------------------------- MLP ----

def mlp_init(gen: torch.Generator, inp_dim: int, num_layers: int,
             num_channels: int, out_dim: int, use_wn: bool = False,
             skip_layers=(), bias: bool = True, half_layers=(),
             residual_layers=(), residual_dims=(),
             act_type: str = "leakyrelu", last_act_type: str = "none",
             act_a: float = 1.0, act_b: float = 1.0,
             act_trainable: bool = False, device=None) -> dict:
    """Layer list with the reference's dims (models/mlp.py:23-33)."""
    assert len(residual_dims) == len(residual_layers)
    layers = []
    for i in range(num_layers):
        cur_inp = inp_dim if i == 0 else num_channels
        cur_out = out_dim if i == num_layers - 1 else num_channels
        if (i + 1) in half_layers:
            cur_out = cur_out // 2
        if i in half_layers:
            cur_inp = cur_inp // 2
        if i in skip_layers:
            cur_inp += inp_dim
        if i in residual_layers:
            cur_inp += residual_dims[list(residual_layers).index(i)]
        layer = linear_init(gen, cur_inp, cur_out, bias=bias, use_wn=use_wn,
                            device=device)
        cur_act = last_act_type if i == num_layers - 1 else act_type
        ap = activation_param_init(cur_act, a=act_a, b=act_b,
                                   trainable=act_trainable,
                                   num_channels=cur_out, device=device)
        if ap:
            layer["act"] = ap
        layers.append(layer)
    return {"layers": layers}


def mlp_apply(params: dict, x: torch.Tensor, act_type: str = "leakyrelu",
              last_act_type: str = "none", a: float = 1.0, b: float = 1.0,
              skip_layers=(), residual_layers=(), residuals=(),
              policy: Policy = F32) -> torch.Tensor:
    inp = x
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        if i in skip_layers:
            x = torch.cat([x, inp], dim=-1)
        if i in residual_layers:
            x = torch.cat([x, residuals[list(residual_layers).index(i)]],
                          dim=-1)
        x = linear_apply(layer, x, policy)
        cur_act = last_act_type if i == n - 1 else act_type
        x = apply_activation(cur_act, x, layer.get("act"), a=a, b=b)
    return x


# ----------------------------------------------------------- FeedForward ----

def feedforward_init(gen: torch.Generator, d_input: int, d_output: int,
                     ff_cfg, device=None) -> dict:
    """[LayerNorm] -> MLP -> [LayerNorm] (the k/q/v embedders)."""
    p: dict = {
        "mlp": mlp_init(
            gen, d_input, ff_cfg.n_ff_layer, ff_cfg.d_ff, d_output,
            use_wn=ff_cfg.use_wn, skip_layers=tuple(ff_cfg.skip_layers),
            half_layers=tuple(ff_cfg.half_layers),
            residual_layers=tuple(ff_cfg.get("residual_layers", [])),
            residual_dims=tuple(ff_cfg.get("residual_dims", [])),
            act_type=ff_cfg.ff_act, last_act_type=ff_cfg.ff_last_act,
            act_a=float(ff_cfg.ff_act_a), act_b=float(ff_cfg.ff_act_b),
            act_trainable=bool(ff_cfg.ff_act_trainable), device=device),
    }
    if ff_cfg.norm == "layernorm":
        p["innorm"] = layernorm_init(d_input, device)
        p["outnorm"] = layernorm_init(d_output, device)
    elif ff_cfg.norm != "none":
        raise ValueError("Invalid attention norm type")
    return p


def dropout_keep(gen: torch.Generator, keep: float, shape,
                 device) -> torch.Tensor:
    """Bernoulli(keep) mask of ``shape`` drawn from ``gen`` (on ``device``):
    the one place the FeedForward's dropout draws its randomness."""
    return torch.rand(shape, generator=gen, device=device) < keep


def feedforward_apply(params: dict, x: torch.Tensor, ff_cfg, d_output: int,
                      eps: float = 1e-6, policy: Policy = F32,
                      dropout_rng: torch.Generator | None = None
                      ) -> torch.Tensor:
    """FeedForward (residual only when dims match). With ``dropout_rng``
    (training) and ``ff_cfg.dropout_ff > 0`` the dense stack's output is
    dropped out before ``outnorm`` (``papr_tpu/nn/mlp.py``): kept with
    probability 1 - rate and scaled by 1 / (1 - rate)."""
    def norm(name, t):
        return layernorm_apply(params[name], t, eps) if name in params else t

    def body(t):
        t = mlp_apply(
            params["mlp"], t, act_type=ff_cfg.ff_act,
            last_act_type=ff_cfg.ff_last_act, a=ff_cfg.ff_act_a,
            b=ff_cfg.ff_act_b, skip_layers=tuple(ff_cfg.skip_layers),
            residual_layers=tuple(ff_cfg.get("residual_layers", [])),
            policy=policy)
        rate = float(ff_cfg.dropout_ff)
        if rate > 0.0 and dropout_rng is not None:
            keep = dropout_keep(dropout_rng, 1.0 - rate, t.shape, t.device)
            t = torch.where(keep, t / (1.0 - rate), 0.0).to(t.dtype)
        return t

    if ff_cfg.residual_ff and x.shape[-1] == d_output:
        return norm("outnorm", x + body(norm("innorm", x)))
    return norm("outnorm", body(norm("innorm", x)))
