"""The training step, tiled full-image rendering and frame delivery
(``papr_tpu/train/step.py``).

* ``make_train_step``: forward, loss (MSE + LPIPS), the gradient of every
  trained parameter through autograd (the kernels' backwards on the card),
  and the per-group Adam update in place; eager, no ``torch.compile``.
  Embedder dropout draws from a generator derived from (seed, step), so a
  resumed run replays the same masks.

* ``render_full_image``: host rays in (dataset-driven eval), edge-padded
  fixed-shape ray tiles, the attention pass per tile, untiling, one
  full-image UNet pass, background compositing and the last activation.
* ``render_frame`` / ``render_frames``: the serving path. A (4, 4) camera
  pose goes in and a uint8 (H, W, 3) frame comes out; rays are generated on
  the device, so the only per-frame upload is the pose. ``render_frames``
  enqueues frame i+1 before it fetches frame i (CUDA work is asynchronous),
  so the host copy of one frame overlaps the next frame's device work.

Tiles are edge-padded, never zero-padded: a zero ray direction in the
overhang would poison the culled selection's cone bounds for every valid ray
sharing a pixel block with it. Multi-device (sharded) rendering is not
ported: a ``tpu.mesh`` of more than one device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.papr import (composite_background, eval_quant_params, evaluate,
                          forward, model_meta, render_foreground)
from ..nn.activations import build_activation
from ..nn.mlp import policy_from_config
from ..ops.geometry import get_rays
from .optim import (apply_updates, build_group_specs, init_opt_state,
                    tree_leaves, tree_map)


def dropout_generator(cfg, step: int, device):
    """The embedder dropout's generator of one training step, or None when no
    embedder has ``dropout_ff > 0``: seeded from (``cfg.seed``, step), as the
    JAX step folds the step into ``PRNGKey(seed)``, so a resumed run replays
    the same masks."""
    e = cfg.models.attn.embed
    if not any(float(e[n].dropout_ff) > 0 for n in ("key", "query", "value")):
        return None
    seed = np.random.SeedSequence([int(cfg.seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def loss_and_grads(params, state, cfg, rayo, rayd, target, c2w, loss_fn,
                   specs, policy, shading_code=None, dropout_rng=None):
    """Forward + last activation + loss, and the loss's gradient for every
    trained group (``specs``) -> (loss, pred, grads {key: tree}).
    ``dropout_rng``: the step's ``dropout_generator``."""
    last_act = build_activation(cfg.models.last_act)
    live = {key: tree_map(lambda t: t.detach().requires_grad_(True), p)
            if key in specs else p for key, p in params.items()}
    with torch.enable_grad():
        pred = last_act(forward(live, state, cfg, rayo, rayd, c2w,
                                shading_code=shading_code, policy=policy,
                                dropout_rng=dropout_rng))
        loss = loss_fn(pred, target)
        keys = [k for k in live if k in specs]
        flat = [x for k in keys for x in tree_leaves(live[k])]
        gflat = torch.autograd.grad(loss, flat, allow_unused=True)
    gflat = [torch.zeros_like(x) if g is None else g
             for g, x in zip(gflat, flat)]
    grads, i = {}, 0
    for k in keys:
        n = len(tree_leaves(live[k]))
        it = iter(gflat[i:i + n])
        grads[k] = tree_map(lambda _: next(it), live[k])
        i += n
    return loss.detach(), pred.detach(), grads


def make_train_step(cfg, loss_fn=None):
    """-> step(params, opt_state, state, rayo, rayd, target, c2w, step,
    shading_code=None) -> (params, opt_state, loss, pred).

    rayo (N, 3), rayd (N, H, W, 3) and target (N, H, W, 3) on the model's
    device; ``step`` is the global step the schedules read. The update is in
    place (the returned params / opt_state are the ones passed in). With no
    ``loss_fn`` the config's loss is built with the LPIPS fallback
    (``train/losses.py``)."""
    from .losses import build_loss
    policy = policy_from_config(cfg)
    specs = build_group_specs(cfg)
    loss_cache = {}

    def step(params, opt_state, state, rayo, rayd, target, c2w, step,
             shading_code=None):
        fn = loss_fn
        if fn is None:
            dev = params["points"].device
            if dev not in loss_cache:
                loss_cache[dev] = build_loss(cfg, policy, device=dev)
            fn = loss_cache[dev]
        loss, pred, grads = loss_and_grads(
            params, state, cfg, rayo, rayd, target, c2w, fn, specs, policy,
            shading_code,
            dropout_generator(cfg, step, params["points"].device))
        params, opt_state = apply_updates(params, grads, opt_state, specs,
                                          int(step))
        return params, opt_state, loss, pred

    return step


def make_opt_state(cfg, params):
    return init_opt_state(params, build_group_specs(cfg))


def _untile(x: torch.Tensor, N: int, ty: int, tx: int) -> torch.Tensor:
    """(N, ty*tx, th, tw, ...) -> (N, ty*th, tx*tw, ...)."""
    th, tw = x.shape[2], x.shape[3]
    x = x.reshape(N, ty, tx, th, tw, *x.shape[4:])
    x = x.movedim(2, 3)
    return x.reshape(N, ty * th, tx * tw, *x.shape[5:])


def _tiled_render_body(params, state, cfg, policy, rayo, rayd_tiles,
                       gamma, beta, extras: bool, run_unet: bool,
                       rgb8: bool):
    """Attention pass over every tile + full-image UNet + composite.

    rayo (N, 3), rayd_tiles (N, ty, tx, th, tw, 3) on the model's device."""
    meta = model_meta(cfg)
    N, ty, tx, th, tw, _ = rayd_tiles.shape
    flat = rayd_tiles.reshape(N, ty * tx, th, tw, 3)
    # tpu.int8_eval: calibrate and quantize the walks ONCE per frame, on
    # ~1024 strided rays of all tiles, not inside every tile's call
    # (papr_tpu/train/step.py:209-219).
    qp = None
    if (bool(cfg.get_path("tpu.int8_eval", False))
            and bool(cfg.get_path("tpu.eval_fused", True))):
        all_rays = flat.reshape(-1, 3)
        qp = eval_quant_params(params, state, cfg, rayo[0],
                               all_rays[::max(1, all_rays.shape[0] // 1024)],
                               policy=policy)
    fs, ats, sels = [], [], []
    for n in range(N):
        for t in range(ty * tx):
            out = evaluate(params, state, cfg, rayo[n:n + 1], flat[n, t][None],
                           policy=policy, with_selected=extras,
                           quant_params=qp)
            fs.append(out[0][0])
            ats.append(out[1][0])
            if extras:
                sels.append(out[2][0])
    stack = lambda xs: torch.stack(xs).reshape(N, ty * tx, *xs[0].shape)
    fused = _untile(stack(fs), N, ty, tx)          # (N, Hp, Wp, 1, C)
    attn = _untile(stack(ats), N, ty, tx)          # (N, Hp, Wp, k+1, 1)
    selected = _untile(stack(sels), N, ty, tx) if extras else None
    if not run_unet:
        return fused, attn, selected
    if meta.use_renderer:
        fg = render_foreground(params, cfg, fused[..., 0, :], gamma, beta,
                               policy)[..., None, :]
    else:
        fg = fused
    bkg_attn = attn[..., -1:, :]
    rgb = composite_background(cfg, params, fg, bkg_attn)
    rgb = build_activation(cfg.models.last_act)(rgb[..., 0, :])
    if rgb8:
        rgb = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8)
    if extras:
        return rgb, fg[..., 0, :], bkg_attn[..., 0, :], fused, attn, selected
    return rgb, fg[..., 0, :], bkg_attn[..., 0, :]


def render_frame_async(params, state, cfg, c2w, focal_x: float,
                       focal_y: float, H: int, W: int, tile_h: int = 0,
                       tile_w: int = 0, policy=None) -> torch.Tensor:
    """Enqueue one frame; returns the uint8 (H, W, 3) tensor on the model's
    device without waiting for it."""
    policy = policy or policy_from_config(cfg)
    tile_h, tile_w = tile_h or H, tile_w or W
    dev = params["points"].device
    c2w_t = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    focal = torch.tensor([focal_x, focal_y], dtype=torch.float32, device=dev)
    rayo, rayd = get_rays(H, W, c2w_t, focal)          # (1, 3), (H, W, 3)
    Hp, Wp = -(-H // tile_h) * tile_h, -(-W // tile_w) * tile_w
    rows = torch.clamp_max(torch.arange(Hp, device=dev), H - 1)
    cols = torch.clamp_max(torch.arange(Wp, device=dev), W - 1)
    rayd = rayd[rows][:, cols]                          # edge padding
    ty, tx = Hp // tile_h, Wp // tile_w
    tiles = rayd.reshape(ty, tile_h, tx, tile_w, 3).permute(0, 2, 1, 3, 4)
    rgb = _tiled_render_body(params, state, cfg, policy, rayo, tiles[None],
                             None, None, False, True, True)[0]
    return rgb[0, :H, :W]


def render_frame(params, state, cfg, c2w, focal_x: float, focal_y: float,
                 H: int, W: int, tile_h: int = 0, tile_w: int = 0,
                 policy=None) -> np.ndarray:
    """One-call frame delivery: (4, 4) c2w -> uint8 (H, W, 3) RGB."""
    return render_frame_async(params, state, cfg, c2w, focal_x, focal_y, H, W,
                              tile_h, tile_w, policy).cpu().numpy()


def render_frames(params, state, cfg, c2ws, focal_x: float, focal_y: float,
                  H: int, W: int, tile_h: int = 0, tile_w: int = 0,
                  policy=None):
    """Pipelined multi-frame delivery: yields uint8 (H, W, 3) frames for a
    sequence of camera poses, enqueuing frame i+1 before fetching frame i."""
    pending = None
    for c2w in c2ws:
        fut = render_frame_async(params, state, cfg, c2w, focal_x, focal_y,
                                 H, W, tile_h, tile_w, policy)
        if pending is not None:
            yield pending.cpu().numpy()
        pending = fut
    if pending is not None:
        yield pending.cpu().numpy()


def render_full_image(params, state, cfg, rayo, rayd, tile_h: int,
                      tile_w: int, policy=None, with_depth: bool = False,
                      gamma=None, beta=None, with_extras: bool = None,
                      attention_only: bool = False, rgb_only: bool = False,
                      rgb_uint8: bool = False) -> dict:
    """Tiled attention pass + one full-image UNet pass (reference
    train.py:29-87 / test.py:45-104). rayo (N, 3), rayd (N, H, W, 3) host
    arrays. Returns a dict of numpy arrays: rgb, foreground, bkg_attn, and
    with ``with_extras``/``with_depth`` the fused features, attention,
    selected points and depth."""
    policy = policy or policy_from_config(cfg)
    dev = params["points"].device
    rayd = np.asarray(rayd, np.float32)
    N, H, W, _ = rayd.shape
    extras = bool(with_extras) or with_depth
    ph = -(-H // tile_h) * tile_h - H
    pw = -(-W // tile_w) * tile_w - W
    rayd_p = np.pad(rayd, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    ty, tx = (H + ph) // tile_h, (W + pw) // tile_w
    tiles = rayd_p.reshape(N, ty, tile_h, tx, tile_w, 3).transpose(
        0, 1, 3, 2, 4, 5)                               # (N, ty, tx, th, tw, 3)
    rayo_t = torch.as_tensor(np.asarray(rayo, np.float32), device=dev)
    tiles_t = torch.as_tensor(np.ascontiguousarray(tiles), device=dev)
    crop = lambda x: x[:, :H, :W].cpu().numpy()

    if attention_only:
        f, a, s = _tiled_render_body(params, state, cfg, policy, rayo_t,
                                     tiles_t, None, None, True, False, False)
        out = {"fused": crop(f), "attn": crop(a), "selected": crop(s)}
        if with_depth:
            out["depth"] = attention_depth(np.asarray(rayo), out["selected"],
                                           out["attn"])
        return out
    res = _tiled_render_body(params, state, cfg, policy, rayo_t, tiles_t,
                             gamma, beta, extras, True,
                             rgb_uint8 and not extras)
    if rgb_only and not extras:
        return {"rgb": crop(res[0])}
    out = {"rgb": crop(res[0]), "foreground": crop(res[1]),
           "bkg_attn": crop(res[2])}
    if extras:
        out["fused"] = crop(res[3])
        out["attn"] = crop(res[4])
        out["selected"] = crop(res[5])
    if with_depth:
        out["depth"] = attention_depth(np.asarray(rayo), out["selected"],
                                       out["attn"])
    return out


def attention_depth(rayo: np.ndarray, selected: np.ndarray,
                    attn: np.ndarray) -> np.ndarray:
    """Attention-weighted point-to-image-plane distance (train.py:110-116)."""
    od = -rayo.reshape(-1)[:3]
    D = np.sum(od * rayo.reshape(-1)[:3])
    dists = np.abs(np.sum(selected * od, -1) - D) / np.linalg.norm(od)
    n_bkg = attn.shape[-2] - dists.shape[-1]
    if n_bkg > 0:
        dists = np.concatenate(
            [dists, np.zeros(dists.shape[:-1] + (n_bkg,), np.float32)], -1)
    return np.sum(attn[..., 0] * dists, axis=-1)
