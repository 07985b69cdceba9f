"""Prune / grow events on the padded, static-shape point cloud
(``papr_tpu/train/points_host.py``).

The reference reallocates its parameter tensors and rebuilds every
optimizer on each prune / grow (models/model.py:335-394, train.py:207-250).
Here shapes stay fixed: prune clears alive bits; grow writes host-computed
points into free slots, in place. The caller rebuilds the optimizer state
(``train.optim.init_opt_state``), which matches the reference's full
rebuild.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.pointgrow import add_points_knn


def prune_points(params: dict, state: dict, thresh: float,
                 prune_type: str = "<"):
    """Returns (params, state, num_pruned). Reference models/model.py:335-358."""
    alive = state["alive"]
    influ = params["points_influ_scores"][:, 0]
    if prune_type == "<":
        keep = influ > thresh
    elif prune_type == ">":
        keep = influ < thresh
    else:
        raise ValueError(prune_type)
    new_alive = alive & keep
    num_pruned = int(alive.sum().item() - new_alive.sum().item())
    state = dict(state)
    state["alive"] = new_alive
    return params, state, num_pruned


def add_points(params: dict, state: dict, cfg, add_num: int,
               rng: np.random.Generator):
    """Grow into free slots. Returns (params, state, num_added); never
    exceeds the padded size (reference train.py:239-242 cap)."""
    alive = state["alive"].cpu().numpy()
    live_idx = np.nonzero(alive)[0]
    free_idx = np.nonzero(~alive)[0]
    add_num = min(int(add_num), len(free_idx))
    if add_num <= 0:
        return params, state, 0

    host = lambda name: params[name].detach().cpu().numpy()[live_idx]
    feats = host("pc_feats") if "pc_feats" in params else None
    popt = cfg.geoms.points
    new_coords, n_new, new_influ, new_feats = add_points_knn(
        host("points"), host("points_influ_scores"), add_num=add_num,
        k=int(popt.add_k), comb_type=popt.add_type,
        sample_k=int(popt.add_sample_k), sample_type=popt.add_sample_type,
        point_features=feats, rng=rng)
    if n_new <= 0:
        return params, state, 0

    dev = params["points"].device
    slots = torch.as_tensor(free_idx[:n_new], device=dev)
    with torch.no_grad():
        for name, vals in (("points", new_coords),
                           ("points_influ_scores", new_influ),
                           ("pc_feats", new_feats)):
            if vals is not None and name in params:
                params[name][slots] = torch.as_tensor(
                    np.asarray(vals, np.float32), device=dev)
    new_alive = state["alive"].clone()
    new_alive[slots] = True
    state = dict(state)
    state["alive"] = new_alive
    return params, state, n_new
