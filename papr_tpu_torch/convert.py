"""Parameters of a JAX papr_tpu model as the port's parameters.

``from_jax_params`` takes the JAX (params, state) pytrees as nested dicts /
lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and copies them
leaf by leaf, padded point slots included, so both packages compute the same
function on the same weights. Both sides keep the same layouts: linear
weights are (out, in), convolution kernels HWIO. (``papr_tpu/model/
torch_convert.py::to_torch_state_dict`` exports only the live points for the
reference's ``model.pth``, which is a different purpose.)

``from_jax_opt_state`` and ``from_jax_lpips_params`` carry the Adam state and
the LPIPS weights across, so both packages can start from one mid-training
state; ``from_jax_quant_params`` carries an int8 walk quantization across, so
both int8 kernels can run on the same quantization.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .model.papr import model_meta


def to_torch(tree, device=None):
    """Nested dicts / lists of numpy arrays -> the same tree of tensors
    (float32, or bool for masks) on ``device`` (``None``: the card, and an
    error without one, as in every converter here)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(arr.astype(np.float32)).to(device)


def from_jax_params(params_np: dict, state_np: dict, cfg, device=None):
    """(params, state) numpy pytrees of ``papr_tpu.model.papr.create_model``
    -> the port's (params, state) on ``device``."""
    params = to_torch(params_np, device)
    state = to_torch(state_np, device)
    P = model_meta(cfg).pad_num_pts
    if tuple(params["points"].shape) != (P, 3) or \
            tuple(state["alive"].shape) != (P,):
        raise ValueError(f"expected {P} padded point slots, got "
                         f"{tuple(params['points'].shape)} / "
                         f"{tuple(state['alive'].shape)}")
    return params, state


def from_jax_opt_state(opt_state_np: dict, params: dict, cfg) -> dict:
    """The JAX per-group Adam state (``papr_tpu.train.optim.init_opt_state``
    layout: {group key: {"m": tree, "v": tree, "t": int32}} as numpy) ->
    the port's (moments on the parameters' device, ``t`` a host int)."""
    from .train.optim import build_group_specs
    specs = build_group_specs(cfg)
    dev = params["points"].device
    out = {}
    for key, st in opt_state_np.items():
        if key not in specs or key not in params:
            raise ValueError(f"optimizer group {key!r} is not trained by "
                             "this config")
        out[key] = {"m": to_torch(st["m"], dev), "v": to_torch(st["v"], dev),
                    "t": int(np.asarray(st["t"]))}
    return out


def from_jax_lpips_params(lp_np: dict, device=None) -> dict:
    """JAX LPIPS params ({"convs": [{"w": HWIO, "b"}], "lins": [...]}, numpy)
    -> the port's (OIHW kernels for ``F.conv2d``)."""
    device = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    convs = [{"w": t(np.asarray(c["w"]).transpose(3, 2, 0, 1)), "b": t(c["b"])}
             for c in lp_np["convs"]]
    lins = [t(np.asarray(l).reshape(-1)) for l in lp_np["lins"]]
    return {"convs": convs, "lins": lins}


def from_jax_quant_params(qp_np, walks, device=None) -> tuple:
    """The JAX int8 quantization of the key and value walks, ``((kwq, kinv,
    kdq), (vwq, vinv, vdq))`` as numpy (``papr_tpu.model.papr
    eval_quant_params`` / ``ops.stream_attn._quantize_walk``: per layer int8
    weights (d_i, d_i+1), inverse activation scales (1, d_i) and dequant rows
    (1, d_i+1), every width padded to 128 lanes), cut to the true widths of
    ``walks`` = (key Walk, value Walk): the port's ``(WalkQuant, WalkQuant)``
    for ``attend_eval_idx(..., quant_params=)``."""
    from .ops.fused_mlp import WalkQuant
    device = resolve_device(device)
    out = []
    for (wq, inv, dq), walk in zip(qp_np, walks):
        dims = [tuple(int(d) for d in w.shape) for w in walk.ws]
        out.append(WalkQuant(
            tuple(torch.from_numpy(np.asarray(w)[:a, :b].astype(np.int8))
                  .to(device) for w, (a, b) in zip(wq, dims)),
            tuple(torch.from_numpy(np.asarray(r, np.float32).reshape(-1)[:a]
                                   .copy()).to(device)
                  for r, (a, _) in zip(inv, dims)),
            tuple(torch.from_numpy(np.asarray(r, np.float32).reshape(-1)[:b]
                                   .copy()).to(device)
                  for r, (_, b) in zip(dq, dims))))
    return tuple(out)
