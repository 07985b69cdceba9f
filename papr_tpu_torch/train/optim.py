"""Per-group Adam with per-group schedules (``papr_tpu/train/optim.py``).

One torch-Adam per parameter group (reference models/model.py:117-192):

* groups: points / attn / points_influ_scores / pc_feats / mapping_mlp /
  renderer / bkg_feats (bkg only when learnable); ``fix_keys`` removes
  groups;
* weight decay is torch-Adam L2 folded into the gradient;
* a prune/grow event rebuilds the optimizer state: moments reset and the
  per-group bias-correction counter ``t`` restarts, while the schedule keeps
  following the global step.

The update runs in place under ``torch.no_grad()``, one ``torch._foreach_*``
launch per operation over a group's tensors: parameters and moments are
tensors on the parameters' device, ``t`` a host integer per group. The
bias corrections are computed in float32, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .schedules import make_schedule

# param tree top-level key -> (optimizer-group name, lr-config name).
GROUPS = {
    "points": ("points", "points"),
    "attn": ("attn", "attn"),
    "points_influ_scores": ("points_influ_scores", "points_influ_scores"),
    "pc_feats": ("pc_feats", "feats"),
    "mapping_mlp": ("mapping_mlp", "mapping_mlp"),
    "renderer": ("renderer", "generator"),
    "bkg_feats": ("bkg_feats", "bkg_feats"),
}

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class GroupSpec:
    name: str
    lr_fn: Callable
    weight_decay: float


def build_group_specs(cfg) -> dict[str, GroupSpec]:
    lr_opt = cfg.training.lr
    fixed = set(cfg.training.fix_keys)
    steps = int(cfg.training.steps)
    specs: dict[str, GroupSpec] = {}
    for top_key, (group, lr_name) in GROUPS.items():
        if group in fixed:
            continue
        if group == "bkg_feats" and not cfg.geoms.background.learnable:
            continue
        gcfg = lr_opt[lr_name]
        specs[top_key] = GroupSpec(
            name=group,
            lr_fn=make_schedule(gcfg, steps, lr_opt.lr_factor),
            weight_decay=float(gcfg.get("weight_decay", 0) or 0.0))
    return specs


def tree_leaves(tree) -> list:
    """Leaves of a nested dict / list tree, dict keys sorted (jax.tree's
    order, which tree_map follows too)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def init_opt_state(params: dict, specs: dict[str, GroupSpec]) -> dict:
    """Zero moments and t = 0 for every trained group present in params."""
    return {key: {"m": tree_map(torch.zeros_like, params[key]),
                  "v": tree_map(torch.zeros_like, params[key]),
                  "t": 0}
            for key in params if key in specs}


def apply_updates(params: dict, grads: dict, opt_state: dict,
                  specs: dict[str, GroupSpec], step: int) -> tuple:
    """One Adam step per group, in place; ``grads`` maps each trained key to
    its gradient tree; ``step`` is the global schedule step."""
    with torch.no_grad():
        for key, spec in specs.items():
            if key not in params:
                continue
            lr = spec.lr_fn(step)
            st = opt_state[key]
            st["t"] += 1
            tf = np.float32(st["t"])
            bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** tf)
            bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** tf)
            # One multi-tensor launch per operation over the whole group.
            ps, gs = tree_leaves(params[key]), tree_leaves(grads[key])
            ms, vs = tree_leaves(st["m"]), tree_leaves(st["v"])
            if spec.weight_decay:
                gs = torch._foreach_add(gs, ps, alpha=spec.weight_decay)
            torch._foreach_mul_(ms, ADAM_B1)
            torch._foreach_add_(ms, gs, alpha=1 - ADAM_B1)
            torch._foreach_mul_(vs, ADAM_B2)
            torch._foreach_addcmul_(vs, gs, gs, value=1 - ADAM_B2)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, ADAM_EPS)
            upd = torch._foreach_div(ms, bc1)
            torch._foreach_mul_(upd, lr)
            torch._foreach_div_(upd, den)
            torch._foreach_sub_(ps, upd)
    return params, opt_state


def current_lrs(specs: dict[str, GroupSpec], step: int) -> dict[str, float]:
    return {spec.name: float(spec.lr_fn(step)) for spec in specs.values()}
