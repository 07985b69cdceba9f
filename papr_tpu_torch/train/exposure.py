"""cIMLE exposure-control machinery: shading-code store + resampling
(``papr_tpu/train/exposure.py``).

Behavioral spec: reference exposure_control_finetune.py:184-218 and
utils.py:406-495 (``resample_shading_codes``): each training image owns a
latent shading code; periodically, candidate codes are scored by re-decoding
the image's (fixed) fused feature map through mapping-MLP-FiLM + UNet and the
best (by PSNR or loss) replaces the stored code.

The fused feature map is rendered once (tiled, through the attention
kernels), then all ``num_samples`` candidate decodes run as ONE batch of N
under ``torch.no_grad()``: the mapping MLP on the (N, dim) codes, the UNet on
N copies of the map, each modulated by its own (gamma, beta) row. The
candidates come from the caller's ``numpy.random.Generator`` in the JAX
package's order (one (num_samples, dim) draw per image, before the render),
so the same seed picks the same codes in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.papr import composite_background, mapping_apply, render_foreground
from ..nn.activations import build_activation
from ..nn.mlp import policy_from_config
from .step import render_full_image


def init_shading_codes(rng: np.random.Generator, n_images: int, cfg) -> np.ndarray:
    ec = cfg.exposure_control
    return (rng.standard_normal((n_images, int(ec.shading_code_dim)))
            .astype(np.float32) * float(ec.shading_code_scale))


def _candidate_scores_fn(cfg, loss_fn=None):
    """-> score(params, fused, bkg_attn, img, codes): one score per
    candidate code, as a host array (lower is better).

    ``fused`` (1, H, W, C) and ``bkg_attn`` (1, H, W, 1, 1) are the image's
    attention pass; ``img`` (1, H, W, 3); ``codes`` (N, dim). select_by
    'psnr' ranks by MSE (identical ordering); 'loss' ranks by the full
    training loss (MSE + LPIPS as configured) like the reference's loss
    branch (utils.py:479-481)."""
    policy = policy_from_config(cfg)
    last_act = build_activation(cfg.models.last_act)
    by_loss = cfg.exposure_control.shading_code_resample_select_by == "loss"
    built = {}

    def loss_of(device):
        if loss_fn is not None:
            return loss_fn
        if device not in built:
            from .losses import build_loss
            built[device] = build_loss(cfg, policy, device=device)
        return built[device]

    @torch.no_grad()
    def score(params, fused, bkg_attn, img, codes):
        dev = params["points"].device
        fused = torch.as_tensor(fused, device=dev)
        bkg_attn = torch.as_tensor(bkg_attn, device=dev)
        img = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        codes = torch.as_tensor(np.asarray(codes, np.float32), device=dev)
        n = codes.shape[0]
        gamma, beta = mapping_apply(params, cfg, codes, policy)
        fg = render_foreground(params, cfg,
                               fused.expand(n, *fused.shape[1:]), gamma,
                               beta, policy)
        rgb = last_act(composite_background(cfg, params, fg[..., None, :],
                                            bkg_attn)[..., 0, :])
        if by_loss:
            fn = loss_of(dev)
            return np.asarray([float(fn(rgb[i:i + 1], img))
                               for i in range(n)], np.float32)
        return ((rgb - img) ** 2).mean(dim=(1, 2, 3)).cpu().numpy()

    return score


def resample_shading_codes(shading_codes: np.ndarray, cfg, params, state,
                           dataset, img_id: int, step: int,
                           rng: np.random.Generator, score_fn=None,
                           full_img: bool = False) -> None:
    """Best-of-N resample for one image's code (in place, like the
    reference)."""
    ec = cfg.exposure_control
    if full_img:
        img, rayd, rayo = dataset.get_full_img(img_id)
    else:
        _, _, img, rayd, rayo = dataset[img_id]
        img, rayd, rayo = img[None], rayd[None], rayo[None]

    candidates = (rng.standard_normal(
        (int(ec.shading_code_num_samples), int(ec.shading_code_dim)))
        .astype(np.float32) * float(ec.shading_code_scale))

    fused, bkg_attn = render_attention(params, state, cfg, rayo, rayd)
    score_fn = score_fn or _candidate_scores_fn(cfg)
    scores = np.asarray(score_fn(params, fused, bkg_attn, img, candidates))
    best = int(np.argmin(scores))
    shading_codes[img_id] = candidates[best]


def render_attention(params, state, cfg, rayo, rayd):
    """The fixed part of a resample: the image's tiled attention pass at
    ``eval.max_height x eval.max_width`` tiles -> (fused (1, H, W, C),
    bkg_attn (1, H, W, 1, 1)) on the model's device."""
    dev = params["points"].device
    out = render_full_image(params, state, cfg, rayo, rayd,
                            int(cfg.eval.max_height), int(cfg.eval.max_width),
                            attention_only=True)
    return (torch.as_tensor(out["fused"][..., 0, :], device=dev),
            torch.as_tensor(out["attn"][..., -1:, :], device=dev))
