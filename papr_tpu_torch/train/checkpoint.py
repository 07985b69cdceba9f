"""Checkpointing: single-tree snapshots (``papr_tpu/train/checkpoint.py``).

One compressed .npz per snapshot holding every leaf of {params, opt_state,
state, extras} under path-string keys, plus the step and the loss histories.
The flat key layout is the JAX package's (``//`` between path parts, ``#i``
for list items, ``__step__``), the parameter trees are the same in both
packages and the optimizer state has the same {group: {m, v, t}} shape, so a
``checkpoint.npz`` written by either package loads in the other. Static
shapes (the padded point cloud) make resuming trivial; Adam's moments and
step counts ARE restored on resume.

The reference's ``model.pth`` layout (``import_torch`` / ``export_torch`` in
the JAX package) is not ported yet: ROADMAP.md Queue 1 item 3.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

SEP = "//"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{SEP}#{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, value in flat.items():
        keys = path.split(SEP)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return [listify(node[f"#{i}"]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(save_dir: str, step: int, params, opt_state, state,
                    extras: dict | None = None, histories: dict | None = None,
                    keep_snapshot: bool = False):
    """Write <save_dir>/checkpoint.npz (+ checkpoint_<step>.npz snapshot).
    The file is written beside its final name and moved over it, so a reader
    never sees a half-written checkpoint."""
    os.makedirs(save_dir, exist_ok=True)
    tree = {"params": params, "opt_state": opt_state, "state": state}
    if extras:
        tree["extras"] = extras
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    flat["__step__"] = np.asarray(step)
    path = os.path.join(save_dir, "checkpoint.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)
    if keep_snapshot:
        np.savez_compressed(os.path.join(save_dir, f"checkpoint_{step}.npz"),
                            **flat)
    if histories is not None:
        with open(os.path.join(save_dir, "histories.json"), "w") as f:
            json.dump({k: [float(x) for x in v] for k, v in histories.items()}, f)


def load_checkpoint(save_dir_or_file: str):
    """Returns (step, tree) where tree has params/opt_state/state[/extras]
    as numpy arrays."""
    path = save_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.npz")
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{path}: loading the reference's model.pth is ROADMAP.md Queue 1 "
            "item 3 (model.pth interop); load a checkpoint.npz")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__"))
    return step, _unflatten(flat)


def load_histories(save_dir: str) -> dict:
    path = os.path.join(save_dir, "histories.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def restore_into(template, loaded):
    """Map loaded numpy leaves onto a template tree: a tensor leaf comes back
    as a tensor of the template's dtype on the template's device, a host
    integer (Adam's ``t``) as an int."""
    t_flat = _flatten(template)
    l_flat = _flatten(loaded)
    missing = set(t_flat) - set(l_flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def restore(ref, value):
        arr = np.asarray(value)
        if isinstance(ref, torch.Tensor):
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf of shape {arr.shape}, "
                                 f"model wants {tuple(ref.shape)}")
            return torch.from_numpy(arr.copy()).to(device=ref.device,
                                                   dtype=ref.dtype)
        return type(ref)(arr)

    return _unflatten({k: restore(t_flat[k], l_flat[k]) for k in t_flat})
