"""Composite training loss (weighted MSE / L1 / LPIPS) and PSNR
(``papr_tpu/train/losses.py``), with the LPIPS fallback of
``papr_tpu/train/loop.py::build_loss``.
"""

from __future__ import annotations

import math

import torch


def get_loss(losses_cfg, lpips_params=None, policy=None):
    """Returns f(pred, target) -> scalar tensor for ``training.losses``.
    The LPIPS weights (loaded, or ``lpips_params``) sit on ``f.params``."""
    terms, params = [], {}
    for name, weight in dict(losses_cfg).items():
        w = float(weight)
        if w <= 0:
            continue
        if name == "mse":
            terms.append((w, lambda p, t: ((p - t) ** 2).mean()))
        elif name == "l1":
            terms.append((w, lambda p, t: (p - t).abs().mean()))
        elif name == "lpips":
            from ..model.lpips import load_lpips_params, lpips_apply
            lp = lpips_params if lpips_params is not None else load_lpips_params()
            params["lpips"] = lp
            terms.append((w, lambda p, t, lp=lp: lpips_apply(lp, p, t,
                                                             policy=policy)))
        elif name == "lpips_alex":
            raise NotImplementedError(
                "lpips_alex as a *training* loss is not supported (the "
                "reference's branch is broken too; models/__init__.py:45)")
        else:
            raise NotImplementedError(f"loss [{name}] is not supported")
    if not terms:
        raise ValueError("no active losses")

    def loss_fn(pred, target):
        total = 0.0
        for w, f in terms:
            total = total + w * f(pred, target)
        return total

    loss_fn.params = params
    return loss_fn


def build_loss(cfg, policy=None, device=None):
    """The loss of ``cfg`` with the LPIPS fallback when the converted VGG16
    backbone is absent (``tpu.lpips_fallback``): "random" (default) seeded
    random backbone and lin heads, "random-lin" random backbone with the
    shipped lin heads, "drop" the term zeroed. ``device`` ``None`` is the
    card (an error without one)."""
    from ..device import resolve_device
    device = resolve_device(device)
    from ..model.lpips import load_lpips_params, random_lpips_params
    lp = None
    if float(dict(cfg.training.losses).get("lpips", 0)) > 0:
        try:
            lp = load_lpips_params(device=device)
        except FileNotFoundError as e:
            mode = str(cfg.get_path("tpu.lpips_fallback", "random"))
            if mode not in ("random", "random-lin"):
                print(f"WARNING: {e}\nWARNING: continuing WITHOUT the lpips "
                      "loss term.")
                losses = {k: (0.0 if k.startswith("lpips") else v)
                          for k, v in dict(cfg.training.losses).items()}
                return get_loss(losses, policy=policy)
            real_lins = mode == "random-lin"
            print(f"WARNING: {e}\nWARNING: using DETERMINISTIC RANDOM VGG "
                  "weights (seed 0" + (", real lin heads" if real_lins else "")
                  + ") for the lpips term — identical FLOPs and "
                  "reproducible, but not the pretrained perceptual metric "
                  "(tpu.lpips_fallback: drop to disable the term instead).")
            lp = random_lpips_params(0, use_real_lins=real_lins,
                                     device=device)
    return get_loss(cfg.training.losses, lpips_params=lp, policy=policy)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse) (reference train.py:88)."""
    mse = ((pred - target) ** 2).mean()
    return -10.0 * torch.log(mse) / math.log(10.0)
