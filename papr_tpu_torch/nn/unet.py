"""SmallUNet rendering head (``papr_tpu/nn/unet.py``).

Channel plan 128-256-512-256-128 with SingleConv blocks (conv3x3 + ReLU),
max-pool downsampling, ConvTranspose(k=2, s=2) upsampling with skip
concatenation, and six optional FiLM modulation sites for exposure control.

Layout: the public function takes and returns NHWC like the JAX package, and
kernels stay HWIO so converted parameters drop in unchanged. Inside, each
convolution is ``F.conv2d`` on a channels-last view (``permute`` of the NHWC
tensor, no copy). ConvTranspose 2x2/stride 2 has non-overlapping taps, so it
is one matmul followed by a 2x2 pixel interleave, as in the JAX package.
Convolutions run in the policy compute dtype; parameters are fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .activations import build_activation
from .init import fan_in_bias, kaiming_uniform_conv, uniform
from .mlp import F32, Policy


# ------------------------------------------------------------- primitives --

def conv_init(gen, in_c: int, out_c: int, k: int, device=None) -> dict:
    w = kaiming_uniform_conv(gen, (k, k, in_c, out_c), device)
    b = fan_in_bias(gen, k * k * in_c, out_c, device)
    return {"w": w, "b": b}


def conv_apply(p: dict, x: torch.Tensor, policy: Policy = F32) -> torch.Tensor:
    """'SAME' convolution, NHWC in and out, HWIO kernel."""
    w = policy.cast(p["w"]).permute(3, 2, 0, 1)          # OIHW view
    pad = (w.shape[-1] - 1) // 2
    y = F.conv2d(policy.cast(x).permute(0, 3, 1, 2), w, padding=pad)
    return y.permute(0, 2, 3, 1) + policy.cast(p["b"])


def convT2x2_init(gen, in_c: int, out_c: int, device=None) -> dict:
    # torch ConvTranspose2d's default init uses fan_in = out_c * k * k.
    fan_in = 4 * out_c
    bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
    w = uniform(gen, (2, 2, in_c, out_c), -bound, bound, device)
    b = fan_in_bias(gen, fan_in, out_c, device)
    return {"w": w, "b": b}


def convT2x2_apply(p: dict, x: torch.Tensor,
                   policy: Policy = F32) -> torch.Tensor:
    """ConvTranspose2d(k=2, s=2): out[2i+di, 2j+dj] = x[i, j] @ W[di, dj]."""
    n, h, w, cin = x.shape
    wt = policy.cast(p["w"])                               # (2, 2, Cin, Cout)
    cout = wt.shape[-1]
    y = policy.cast(x).reshape(-1, cin) @ wt.permute(2, 0, 1, 3).reshape(
        cin, 4 * cout)
    y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 2 * h, 2 * w, cout) + policy.cast(p["b"])


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool, truncating odd sizes like torch MaxPool2d."""
    n, h, w, c = x.shape
    x = x[:, :h - h % 2, :w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def upsample_bilinear_align_corners(x: torch.Tensor,
                                    scale: int = 2) -> torch.Tensor:
    """torch nn.Upsample(mode='bilinear', align_corners=True), NHWC."""
    n, h, w, c = x.shape
    oh, ow = h * scale, w * scale

    def grid(out_len, in_len):
        if out_len == 1 or in_len == 1:
            return torch.zeros(out_len, dtype=torch.float32, device=x.device)
        return (torch.arange(out_len, dtype=torch.float32, device=x.device)
                * (in_len - 1) / (out_len - 1))

    ys, xs = grid(oh, h), grid(ow, w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1, x1 = torch.clamp_max(y0 + 1, h - 1), torch.clamp_max(x0 + 1, w - 1)
    wy = (ys - y0.float())[None, :, None, None].to(x.dtype)
    wx = (xs - x0.float())[None, None, :, None].to(x.dtype)
    g = lambda yi, xi: x[:, yi][:, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _norm_apply(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "none":
        return x
    xf = x.float()
    if kind == "instance":  # per-sample, per-channel over H, W; affine=False
        dims = (1, 2)
    elif kind == "batch":   # batch statistics (no running stats)
        dims = (0, 1, 2)
    else:
        raise NotImplementedError(kind)
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, keepdim=True, unbiased=False)
    return ((xf - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)


# ------------------------------------------------------------ conv blocks --

def single_conv_init(gen, in_c, out_c, mid_c=None, device=None):
    return {"c1": conv_init(gen, in_c, mid_c or out_c, 3, device)}


def single_conv_apply(p, x, norm, policy):
    return torch.clamp_min(_norm_apply(norm, conv_apply(p["c1"], x, policy)), 0)


def double_conv_init(gen, in_c, out_c, mid_c=None, device=None):
    mid_c = mid_c or out_c
    return {"c1": conv_init(gen, in_c, mid_c, 3, device),
            "c2": conv_init(gen, mid_c, out_c, 3, device)}


def double_conv_apply(p, x, norm, policy):
    x = torch.clamp_min(_norm_apply(norm, conv_apply(p["c1"], x, policy)), 0)
    return torch.clamp_min(_norm_apply(norm, conv_apply(p["c2"], x, policy)), 0)


def _block_init(gen, in_c, out_c, single, mid_c=None, device=None):
    return (single_conv_init(gen, in_c, out_c, mid_c, device) if single
            else double_conv_init(gen, in_c, out_c, mid_c, device))


def _block_apply(p, x, single, norm, policy):
    return (single_conv_apply(p, x, norm, policy) if single
            else double_conv_apply(p, x, norm, policy))


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Centre padding of x1 to x2's spatial size (models/unet.py:131-135)."""
    dy = x2.shape[1] - x1.shape[1]
    dx = x2.shape[2] - x1.shape[2]
    if dy == 0 and dx == 0:
        return x1
    return F.pad(x1, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


# --------------------------------------------------------------- SmallUNet --

def small_unet_init(gen, n_channels: int, n_classes: int,
                    bilinear: bool = False, single: bool = True,
                    render_scale: int = 1, device=None) -> dict:
    assert render_scale in (1, 2)
    d = device
    p = {
        "inc": single_conv_init(gen, n_channels, 128, device=d),
        "down1": _block_init(gen, 128, 256, single, device=d),
        "down2": _block_init(gen, 256, 512, single, device=d),
    }
    if bilinear:
        # Quirk preserved: SingleConv(in, out, mid=in//2) outputs mid channels.
        p["up1"] = {"conv": _block_init(gen, 512, 256, single, mid_c=256,
                                        device=d)}
        p["up2"] = {"conv": _block_init(gen, 256, 128, single, mid_c=128,
                                        device=d)}
    else:
        p["up1"] = {"up": convT2x2_init(gen, 512, 256, d),
                    "conv": _block_init(gen, 512, 256, single, device=d)}
        p["up2"] = {"up": convT2x2_init(gen, 256, 128, d),
                    "conv": _block_init(gen, 256, 128, single, device=d)}
    if render_scale == 2:
        if bilinear:
            p["up3"] = {"conv": double_conv_init(gen, 128, 128, mid_c=64,
                                                 device=d)}
        else:
            p["up3"] = {"up": convT2x2_init(gen, 128, 128, d),
                        "conv": double_conv_init(gen, 128, 128, device=d)}
    p["outc"] = conv_init(gen, 128, n_classes, 1, d)
    return p


def _film(x: torch.Tensor, gamma, beta) -> torch.Tensor:
    c = x.shape[-1]
    return (x * gamma.reshape(1, 1, 1, c).to(x.dtype)
            + beta.reshape(1, 1, 1, c).to(x.dtype))


def small_unet_apply(params: dict, x: torch.Tensor, *, bilinear: bool = False,
                     single: bool = True, norm: str = "none",
                     last_act: str = "none", render_scale: int = 1,
                     affine_layer: int = -1, gamma=None, beta=None,
                     policy: Policy = F32) -> torch.Tensor:
    """x: (N, H, W, C_feat) fused features -> (N, H, W, n_classes)."""
    if affine_layer >= 0:
        assert gamma is not None and beta is not None

    def maybe_film(t, site):
        return _film(t, gamma, beta) if affine_layer == site else t

    def up_block(p, x1, x2):
        if bilinear:
            x1 = upsample_bilinear_align_corners(x1)
        else:
            x1 = convT2x2_apply(p["up"], x1, policy)
        x1 = _pad_to_match(x1, x2)
        return _block_apply(p["conv"], torch.cat([x2, x1], dim=-1),
                            single, norm, policy)

    x = maybe_film(policy.cast(x), 0)
    x1 = maybe_film(single_conv_apply(params["inc"], x, norm, policy), 1)
    x2 = maybe_film(_block_apply(params["down1"], maxpool2(x1), single, norm,
                                 policy), 2)
    x3 = maybe_film(_block_apply(params["down2"], maxpool2(x2), single, norm,
                                 policy), 3)
    y = maybe_film(up_block(params["up1"], x3, x2), 4)
    y = maybe_film(up_block(params["up2"], y, x1), 5)
    if render_scale == 2:
        if bilinear:
            y = upsample_bilinear_align_corners(y)
        else:
            y = convT2x2_apply(params["up3"]["up"], y, policy)
        y = double_conv_apply(params["up3"]["conv"], y, norm, policy)
    logits = conv_apply(params["outc"], y, policy)
    return build_activation(last_act)(logits)
