"""Parameters of a JAX papr_tpu model as the port's parameters.

``from_jax_params`` takes the JAX (params, state) pytrees as nested dicts /
lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and copies them
leaf by leaf, padded point slots included, so both packages compute the same
function on the same weights. Both sides keep the same layouts: linear
weights are (out, in), convolution kernels HWIO. (``papr_tpu/model/
torch_convert.py::to_torch_state_dict`` exports only the live points for the
reference's ``model.pth``, which is a different purpose.)
"""

from __future__ import annotations

import numpy as np
import torch

from .model.papr import model_meta


def to_torch(tree, device="cpu"):
    """Nested dicts / lists of numpy arrays -> the same tree of tensors
    (float32, or bool for masks) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(arr.astype(np.float32)).to(device)


def from_jax_params(params_np: dict, state_np: dict, cfg, device="cpu"):
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
