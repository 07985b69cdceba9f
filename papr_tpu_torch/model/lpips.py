"""LPIPS perceptual loss with a VGG16 backbone (``papr_tpu/model/lpips_jax.py``).

Inputs are NHWC RGB in [0, 1], as in the JAX package: mapped to [-1, 1],
normalized by the LPIPS shift / scale, pushed through the five VGG16 relu
slices (relu1_2 .. relu5_3), channel-unit-normalized, squared-differenced,
weighted by the lin heads, spatially averaged and summed (reference
models/lpips.py). Convolutions run NCHW through ``F.conv2d``; kernels are
stored OIHW (``convert.from_jax_lpips_params`` turns the JAX package's HWIO
kernels around).

Weights: the converted torchvision backbone ``lpips_vgg.npz`` and the lin
heads ``lpips_lin.npz``, read with numpy from the JAX package's asset
directory (``$PAPR_LPIPS_WEIGHTS`` overrides the backbone path). Without the
backbone, ``random_lpips_params`` draws a seeded random one of identical
shapes and FLOPs (``tpu.lpips_fallback``, see ``train/losses.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# VGG16 feature-extractor conv plan: (out_channels, pool_before)
VGG16_CONVS = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
SLICE_ENDS = (1, 3, 6, 9, 12)  # conv indices ending each LPIPS slice
SLICE_CHANNELS = (64, 128, 256, 512, 512)

SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "papr_tpu", "assets")
DEFAULT_WEIGHTS = os.path.join(_ASSETS, "lpips_vgg.npz")
DEFAULT_LIN_WEIGHTS = os.path.join(_ASSETS, "lpips_lin.npz")


def _hwio_to_oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def load_lin_params(path: str | None = None, device=None) -> list | None:
    """The 5 learned lin-head weight vectors, or None when the asset is
    missing. ``device`` ``None`` is the card (an error without one), here
    and in the two functions below."""
    device = resolve_device(device)
    path = path or DEFAULT_LIN_WEIGHTS
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return [torch.from_numpy(data[f"lin{i}.w"].astype(np.float32)).to(device)
                for i in range(5)]


def load_lpips_params(path: str | None = None, device=None) -> dict:
    device = resolve_device(device)
    path = path or os.environ.get("PAPR_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS VGG weights not found at {path}. Convert them once with "
            "tools/convert_vgg.py (needs torchvision) or set "
            "PAPR_LPIPS_WEIGHTS. Training can proceed without the lpips term "
            "(set training.losses.lpips: 0).")
    with np.load(path) as data:
        convs = [{"w": _hwio_to_oihw(data[f"conv{i}.w"]).to(device),
                  "b": torch.from_numpy(data[f"conv{i}.b"].astype(np.float32)
                                        ).to(device)}
                 for i in range(len(VGG16_CONVS))]
        lins = [torch.from_numpy(data[f"lin{i}.w"].astype(np.float32)
                                 ).to(device) for i in range(5)]
    return {"convs": convs, "lins": lins}


def random_lpips_params(seed: int = 0, use_real_lins: bool = False,
                        device=None) -> dict:
    """Seeded random backbone (no-torchvision fallback): the shapes and
    scales of the JAX package's ``random_lpips_params`` — N(0, 1) * 0.05
    kernels (drawn HWIO) and biases, U(0, 1) lin heads unless the real ones
    are asked for. The bits are not the ones jax.random draws."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    convs, in_c = [], 3
    for out_c, _ in VGG16_CONVS:
        w = torch.randn(3, 3, in_c, out_c, generator=gen) * 0.05
        b = torch.randn(out_c, generator=gen) * 0.05
        convs.append({"w": w.permute(3, 2, 0, 1).contiguous().to(device),
                      "b": b.to(device)})
        in_c = out_c
    if use_real_lins:
        lins = load_lin_params(device=device)
        if lins is None:
            raise FileNotFoundError(
                f"real lin heads requested but {DEFAULT_LIN_WEIGHTS} is "
                "missing; restore the shipped asset or use "
                "tpu.lpips_fallback: random.")
    else:
        lins = [torch.rand(c, generator=gen).to(device) for c in SLICE_CHANNELS]
    return {"convs": convs, "lins": lins}


def _vgg_slices(params: dict, x: torch.Tensor, compute_dtype=None) -> list:
    """x (N, 3, H, W) already scaled -> the 5 relu feature maps (NCHW)."""
    outs = []
    h = x if compute_dtype is None else x.to(compute_dtype)
    for i, (_, pool_before) in enumerate(VGG16_CONVS):
        if pool_before:
            h = F.max_pool2d(h, 2)
        w, b = params["convs"][i]["w"], params["convs"][i]["b"]
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        h = torch.clamp_min(F.conv2d(h, w, padding=1) + b[None, :, None, None],
                            0)
        if i in SLICE_ENDS:
            outs.append(h)
    return outs


def _unit_normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Reference models/lpips.py:64-67 (norm inside sqrt AND denominator),
    over the channel axis of NCHW maps."""
    norm = torch.sqrt((feat * feat).sum(1, keepdim=True) + eps)
    return feat / (norm + eps)


def lpips_apply(params: dict, pred: torch.Tensor, target: torch.Tensor,
                policy=None) -> torch.Tensor:
    """pred / target (N, H, W, 3) in [0, 1] -> scalar fp32. With a policy,
    the backbone runs in its compute dtype (the JAX package's policy)."""
    compute_dtype = policy.compute_dtype if policy is not None else None
    if compute_dtype == torch.float32:
        compute_dtype = None
    shift = torch.tensor(SHIFT, dtype=torch.float32, device=pred.device)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=pred.device)

    def prep(img):
        img = 2.0 * img.float() - 1.0
        return ((img - shift) / scale).permute(0, 3, 1, 2)

    f0 = _vgg_slices(params, prep(pred), compute_dtype)
    f1 = _vgg_slices(params, prep(target), compute_dtype)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for k in range(5):
        a = _unit_normalize(f0[k].float())
        b = _unit_normalize(f1[k].float())
        w = params["lins"][k].float().reshape(1, -1, 1, 1)
        val = (w * (a - b) ** 2).sum(1)                  # 1x1 lin head
        total = total + val.mean(dim=(1, 2)).mean()
    return total
