"""Procedural demo scene generator (``papr_tpu/dataset/synth.py``; the port
keeps its own copy).

Creates a tiny NeRF-Synthetic-format dataset on disk (transforms_*.json +
PNGs) by rasterizing a lit sphere with a simple pinhole camera — enough for
CPU-runnable end-to-end tests and `configs/demo.yml` without shipping data.
The format matches what dataset/loaders.py consumes (and the reference's
Blender loader).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _look_at(eye: np.ndarray) -> np.ndarray:
    """c2w with camera at `eye` looking at the origin, y-up (OpenGL style)."""
    forward = -eye / np.linalg.norm(eye)          # camera -z points at origin
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w


def render_sphere(c2w: np.ndarray, H: int, W: int, focal: float,
                  radius: float = 0.5) -> np.ndarray:
    """Ray-trace a shaded sphere at the origin; returns RGBA float32."""
    i, j = np.meshgrid(np.arange(W), np.arange(H))
    dirs = np.stack([(i - W / 2 + 0.5) / focal,
                     -(j - H / 2 + 0.5) / focal,
                     -np.ones_like(i, np.float32)], -1).astype(np.float32)
    rd = dirs @ c2w[:3, :3].T
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = c2w[:3, 3]

    b = 2 * (rd @ ro)
    c = ro @ ro - radius ** 2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 1.0)
    pts = ro + rd * t[..., None]
    normal = pts / radius
    light = np.array([0.577, 0.577, 0.577], np.float32)
    lam = np.clip(normal @ light, 0, 1)
    albedo = np.abs(normal)  # position-dependent color
    rgb = albedo * (0.25 + 0.75 * lam[..., None])
    rgba = np.zeros((H, W, 4), np.float32)
    rgba[..., :3] = np.where(hit[..., None], rgb, 0.0)
    rgba[..., 3] = hit.astype(np.float32)
    return rgba


def make_demo_scene(out_dir: str, n_train: int = 6, n_test: int = 2,
                    H: int = 64, W: int = 64, seed: int = 0,
                    exposure_jitter: float = 0.0) -> str:
    """Write a mini Blender-format scene; returns ``out_dir``.

    ``exposure_jitter > 0`` multiplies each TRAIN image's RGB by a random
    per-image gain exp(U(-j, j)) (test/val stay neutral) — the per-image
    photometric inconsistency the cIMLE exposure-control stage exists to
    absorb (reference exposure_control_finetune.py)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    # Separate stream for exposure gains: cameras stay identical to the
    # neutral (exposure_jitter=0) generation of the same seed.
    g_rng = np.random.default_rng(seed + 7919)
    camera_angle_x = 0.8
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    os.makedirs(out_dir, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test), ("val", 1)):
        frames = []
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        for k in range(n):
            theta = 2 * np.pi * (k / n + 0.05 * rng.standard_normal())
            z = 0.4 + 0.3 * rng.random()
            eye = np.array([2.2 * np.cos(theta), 2.2 * np.sin(theta), z],
                           np.float32)
            c2w = _look_at(eye)
            rgba = render_sphere(c2w, H, W, focal)
            if exposure_jitter and split == "train":
                g = float(np.exp(g_rng.uniform(-exposure_jitter,
                                               exposure_jitter)))
                rgba[..., :3] = np.clip(rgba[..., :3] * g, 0.0, 1.0)
            rel = f"./{split}/r_{k}"
            Image.fromarray((rgba * 255).astype(np.uint8), "RGBA").save(
                os.path.join(out_dir, f"{rel}.png"))
            frames.append({"file_path": rel,
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f)
    return out_dir


def make_demo_scene_t2(out_dir: str, n_train: int = 4, n_test: int = 2,
                       H: int = 64, W: int = 64, seed: int = 0) -> str:
    """Same sphere scene in Tanks&Temples/NSVF layout (rgb/ + pose/ +
    intrinsics.txt; 0*=train, 1*=test prefixes; poses are OpenCV-style so the
    loader's blender2opencv flip recovers them)."""
    from PIL import Image

    from .loaders import BLENDER2OPENCV
    rng = np.random.default_rng(seed)
    focal = 0.5 * W / np.tan(0.4)
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "pose"), exist_ok=True)
    with open(os.path.join(out_dir, "intrinsics.txt"), "w") as f:
        f.write(f"{focal} {W / 2} {H / 2} 0.\n")
    for split, n, prefix in (("train", n_train, "0"), ("test", n_test, "1")):
        for k in range(n):
            theta = 2 * np.pi * (k / n + 0.03 * rng.standard_normal())
            eye = np.array([2.2 * np.cos(theta), 2.2 * np.sin(theta),
                            0.5 + 0.2 * rng.random()], np.float32)
            c2w = _look_at(eye)
            rgba = render_sphere(c2w, H, W, focal)
            rgb = rgba[..., :3] * rgba[..., 3:] + (1 - rgba[..., 3:])
            name = f"{prefix}_{k:04d}"
            Image.fromarray((rgb * 255).astype(np.uint8)).save(
                os.path.join(out_dir, "rgb", f"{name}.png"))
            # loader applies pose @ blender2opencv; store pose @ inv(flip)
            stored = c2w @ np.linalg.inv(BLENDER2OPENCV)
            np.savetxt(os.path.join(out_dir, "pose", f"{name}.txt"), stored)
    return out_dir


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="./data/demo_sphere")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--height", type=int, default=0,
                    help="image height (overrides --size; e.g. 1280 for the "
                         "Tanks&Temples native shape)")
    ap.add_argument("--width", type=int, default=0,
                    help="image width (overrides --size; e.g. 2176 for t2)")
    ap.add_argument("--n_train", type=int, default=6)
    ap.add_argument("--n_test", type=int, default=2)
    ap.add_argument("--format", choices=["synthetic", "t2"], default="synthetic")
    ap.add_argument("--exposure_jitter", type=float, default=0.0,
                    help="per-train-image exposure gain exp(U(-j, j)) "
                         "(synthetic format only)")
    args = ap.parse_args()
    H = args.height or args.size
    W = args.width or args.size
    if args.format == "t2":
        print(make_demo_scene_t2(args.out, n_train=args.n_train,
                                 n_test=args.n_test, H=H, W=W))
    else:
        print(make_demo_scene(args.out, n_train=args.n_train,
                              n_test=args.n_test, H=H, W=W,
                              exposure_jitter=args.exposure_jitter))
