"""Evaluation CLI: python -m papr_tpu_torch.cli.test --opt <yml> [--resume N]

Renders the test split tile by tile and reports loss / PSNR / SSIM per frame
and averaged; writes predrgb / depth / fgrgb / bkgmask PNGs and optional
videos, with the flags, log files and output layout (under
<save_dir>/<index>/test) of the repository's ``test.py``. Runs on the GPU;
``PAPR_PLATFORM=cpu`` asks for the CPU.

Not ported yet: the exposure-control modes (``--exp [--random | --intrp]``,
ROADMAP.md Queue 1 item 2) raise. The LPIPS columns need the converted VGG16
/ AlexNet backbones, which the repository does not carry: they report nan
with a warning, as ``test.py`` does without the weights.
"""

import argparse
import os
import shutil
import sys

import numpy as np

from ..config import Config, load_config, make_test_config
from ..utils.logging import Logger, setup_seed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PAPR (PyTorch / CUDA) test")
    p.add_argument("--opt", type=str, default="", help="Option file path")
    p.add_argument("--resume", type=int, default=250000, help="Resume step")
    p.add_argument("--exp", action="store_true",
                   help="[Exposure control] test with exposure control")
    p.add_argument("--intrp", action="store_true",
                   help="[Exposure control] latent interpolation")
    p.add_argument("--random", action="store_true",
                   help="[Exposure control] random codes")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--view", type=int, default=0,
                   help="[Exposure control] test frame index")
    p.add_argument("--scale", type=float, default=1.0,
                   help="[Exposure control] shading code scale")
    p.add_argument("--num_samples", type=int, default=20)
    p.add_argument("--start_index", type=int, default=0)
    p.add_argument("--end_index", type=int, default=1)
    p.add_argument("--num_intrp", type=int, default=10)
    # Parsed and ignored, like the reference (its test.py:34 defines
    # --resample but nothing reads it): kept for CLI flag parity.
    p.add_argument("--resample", action="store_true",
                   help="[Exposure control] accepted for reference-CLI "
                        "parity; unused")
    return p.parse_args(argv)


def make_lpips_metrics(device):
    """LPIPS metric fns: VGG through the port's module when its converted
    weights exist, else nan; AlexNet is not ported -> nan."""
    import torch

    from ..model.lpips import load_lpips_params, lpips_apply
    try:
        lp = load_lpips_params(device=device)

        def vgg(p, t):
            with torch.no_grad():
                return float(lpips_apply(lp, torch.as_tensor(p, device=device),
                                         torch.as_tensor(t, device=device)))
    except FileNotFoundError as e:
        print(f"WARNING: {e}\nWARNING: LPIPS-VGG metric will be nan.")
        vgg = lambda p, t: float("nan")
    print("WARNING: the LPIPS-alex metric is not ported (it needs downloaded "
          "AlexNet weights: ROADMAP.md, blocked).\nWARNING: LPIPS-alex "
          "metric will be nan.")
    alex = lambda p, t: float("nan")
    return alex, vgg


def _imwrite(path: str, arr: np.ndarray) -> None:
    """PNG through PIL (uint8 RGB, or uint16 depth)."""
    from PIL import Image
    Image.fromarray(arr).save(path)


def load_test_model(cfg, resume_step: int, device):
    """The model of ``cfg`` with the checkpoint ``test.load_path`` (default
    <save_dir>/<index>) restored: ``checkpoint_<resume_step>.npz`` when that
    snapshot exists, else ``checkpoint.npz``. -> (params, state, step)."""
    from ..model.papr import create_model
    from ..train.checkpoint import load_checkpoint, restore_into

    params, state = create_model(cfg, seed=int(cfg.seed), device=device)
    load_path = cfg.test.load_path or os.path.join(cfg.save_dir, cfg.index)
    if not os.path.isabs(load_path) and not os.path.exists(load_path):
        alt = os.path.join(cfg.save_dir, load_path)
        load_path = alt if os.path.exists(alt) else load_path
    if os.path.isdir(load_path):
        snap = os.path.join(load_path, f"checkpoint_{resume_step}.npz")
        if os.path.exists(snap):
            load_path = snap
        elif not os.path.exists(os.path.join(load_path, "checkpoint.npz")):
            load_path = os.path.join(load_path, "model.pth")   # raises below
    step, tree = load_checkpoint(load_path)
    params = restore_into(params, tree["params"])
    state = restore_into(state, tree["state"])
    print(f"!!!!! Loaded model from {load_path} at step {step}")
    return params, state, step


def run_test(cfg, save_name, mode, resume_step):
    """Render ``mode``'s split of ``cfg.dataset`` and report the metrics ->
    their means."""
    import torch

    from ..dataset import get_dataset, get_loader
    from ..device import platform_device
    from ..nn.mlp import policy_from_config
    from ..train.losses import build_loss
    from ..train.step import render_full_image
    from ..utils import plots
    from ..utils.metrics import psnr_np, ssim_np

    dev = platform_device()
    params, state, resume_step = load_test_model(cfg, resume_step, dev)
    dataset = get_dataset(cfg.dataset, mode=mode, seed=int(cfg.seed))
    loader = get_loader(dataset, cfg.dataset, mode="test")
    loss_fn = build_loss(cfg, policy_from_config(cfg), device=dev)
    lpips_alex, lpips_vgg = make_lpips_metrics(dev)
    host = lambda t: t.detach().cpu().numpy()

    stats = {"loss": [], "psnr": [], "ssim": [], "lpips_alex": [], "lpips_vgg": []}
    frames = {}

    def one_frame(frame, i, batch):
        code_mean = 0.0
        out = render_full_image(params, state, cfg, batch.rayo, batch.rayd,
                                int(cfg.test.max_height), int(cfg.test.max_width),
                                with_depth=True)
        rgb = np.clip(out["rgb"], 0, 1)
        img = batch.image
        with torch.no_grad():
            stats["loss"].append(float(loss_fn(
                torch.as_tensor(rgb, device=dev),
                torch.as_tensor(img, device=dev))))
        stats["psnr"].append(psnr_np(rgb, img))
        stats["ssim"].append(ssim_np(rgb[0], img[0]))
        stats["lpips_alex"].append(lpips_alex(rgb, img))
        stats["lpips_vgg"].append(lpips_vgg(rgb, img))
        print(f"Test frame: {frame}, code mean: {code_mean}, "
              f"test_loss: {stats['loss'][-1]:.4f}, test_psnr: {stats['psnr'][-1]:.4f}, "
              f"test_ssim: {stats['ssim'][-1]:.4f}, "
              f"test_lpips_alex: {stats['lpips_alex'][-1]:.4f}, "
              f"test_lpips_vgg: {stats['lpips_vgg'][-1]:.4f}")

        if cfg.test.save_fig:
            log_dir = os.path.join(cfg.save_dir, cfg.index, "test", "images")
            os.makedirs(log_dir, exist_ok=True)
            tag = (f"test-{frame:04d}-{i:02d}-codeMean{code_mean:.4f}"
                   f"-PSNR{stats['psnr'][-1]:.3f}-SSIM{stats['ssim'][-1]:.4f}"
                   f"-LPIPSA{stats['lpips_alex'][-1]:.4f}"
                   f"-LPIPSV{stats['lpips_vgg'][-1]:.4f}")
            depth = out["depth"][0] / cfg.dataset.coord_scale * (65536 / 10)
            _imwrite(os.path.join(log_dir, f"{tag}-predrgb.png"),
                     (rgb[0] * 255).astype(np.uint8))
            _imwrite(os.path.join(log_dir, f"{tag}-depth.png"),
                     depth.astype(np.uint16))
            _imwrite(os.path.join(log_dir, f"{tag}-fgrgb.png"),
                     (np.clip(out["foreground"][0], 0, 1) * 255).astype(np.uint8))
            bkg_mask = host(params["bkg_feats"])[0] * out["bkg_attn"][0]
            _imwrite(os.path.join(log_dir, f"{tag}-bkgmask.png"),
                     (np.clip(bkg_mask, 0, 1) * 255).astype(np.uint8))

        if cfg.test.save_video and cfg.test.plots.pcrgb:
            alive = host(state["alive"])
            pts = host(params["points"])[alive]
            influ = host(params["points_influ_scores"])[alive, 0]
            scale_mult = 1.5 if "Barn" in cfg.dataset.path else (
                0.5 if "Family" in cfg.dataset.path else 1.0)
            azims = np.linspace(180, -180, max(len(loader), 1))
            panel = plots.test_pcrgb_plot(
                frame, -frame * (360.0 / max(len(loader), 1)), azims[frame],
                stats["psnr"][-1], pts, rgb[0], img[0], out["depth"][0],
                cfg.dataset.coord_scale * scale_mult, influ)
            frames.setdefault("pcrgb", []).append(np.asarray(panel.convert("RGB")))

        if cfg.test.save_video and cfg.test.plots.get("featattn", False):
            alive = host(state["alive"])
            pts = host(params["points"])[alive]
            influ = host(params["points_influ_scores"])[alive, 0]
            panel = plots.test_featmap_attn_plot(
                frame, -frame, pts, rgb[0], img[0],
                cfg.dataset.coord_scale, out["fused"][0, ..., 0, :],
                out["attn"][0, ..., 0], influ)
            frames.setdefault("featattn", []).append(np.asarray(panel.convert("RGB")))

    for frame, batch in enumerate(loader):
        one_frame(frame, 0, batch)

    means = {k: float(np.mean(v)) if v else float("nan") for k, v in stats.items()}
    if frames:
        from ..utils.video import write_video
        log_dir = os.path.join(cfg.save_dir, cfg.index, "test", "videos")
        os.makedirs(log_dir, exist_ok=True)
        for key, val in frames.items():
            name = (f"{cfg.index}-PSNR{means['psnr']:.3f}-SSIM{means['ssim']:.4f}"
                    f"-LPIPSA{means['lpips_alex']:.4f}-LPIPSV{means['lpips_vgg']:.4f}"
                    f"-{key}-{save_name}-step{resume_step}.mp4")[-255:]
            out = write_video(os.path.join(log_dir, name), val, fps=30)
            print("video:", out)

    print(f"Avg test loss: {means['loss']:.4f}, test PSNR: {means['psnr']:.4f}, "
          f"test SSIM: {means['ssim']:.4f}, test LPIPS Alex: "
          f"{means['lpips_alex']:.4f}, test LPIPS VGG: {means['lpips_vgg']:.4f}")
    return means


def main(argv=None):
    cli = parse_args(argv)
    if cli.intrp or cli.random:
        assert cli.exp, "--intrp/--random require --exp"
    assert not (cli.intrp and cli.random), \
        "Cannot do interpolation and random exposure at the same time."
    if cli.exp:
        raise NotImplementedError(
            "--exp / --intrp / --random: exposure control is not ported yet "
            "(ROADMAP.md Queue 1 item 2)")

    base_cfg = load_config(cli.opt)
    log_dir = os.path.join(base_cfg.save_dir, base_cfg.index)
    os.makedirs(log_dir, exist_ok=True)
    sys.stdout = Logger(os.path.join(log_dir, "test.log"), sys.stdout)
    sys.stderr = Logger(os.path.join(log_dir, "test_error.log"), sys.stderr)
    if cli.opt:
        shutil.copyfile(cli.opt, os.path.join(log_dir, os.path.basename(cli.opt)))
    setup_seed(base_cfg.seed)

    results = {}
    for entry in base_cfg.test.datasets:
        entry = Config(entry)
        cfg = make_test_config(base_cfg, entry)
        results[entry.name] = run_test(cfg, entry.name, entry.mode,
                                       cli.resume)
    return results


if __name__ == "__main__":
    main()
