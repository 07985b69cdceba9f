"""Scene-format loaders: NeRF-Synthetic (Blender) and Tanks & Temples (NSVF)
(``papr_tpu/dataset/loaders.py``; the port keeps its own copy).

Behavioral spec: reference dataset/load_nerfsyn.py and dataset/load_t2.py.
Pure numpy/PIL on the host — image decode never touches the device path.
"""

from __future__ import annotations

import json
import os

import numpy as np

BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)


def _read_image(path: str, resize: tuple[int, int] | None = None) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if resize is not None:
        img = img.resize(resize)
    return (np.asarray(img) / 255.0).astype(np.float32)


def load_blender_data(basedir: str, split: str = "train", factor: int = 1,
                      read_offline: bool = True):
    """transforms_<split>.json + per-frame PNGs; focal from camera_angle_x.

    Reference: dataset/load_nerfsyn.py:8-41. With read_offline=False only
    frame 0 is decoded (shape probe); paths are returned for lazy reads.
    """
    from PIL import Image
    with open(os.path.join(basedir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)

    poses, images, image_paths = [], [], []
    for i, frame in enumerate(meta["frames"]):
        img_path = os.path.abspath(
            os.path.join(basedir, frame["file_path"] + ".png"))
        poses.append(np.asarray(frame["transform_matrix"], np.float32))
        image_paths.append(img_path)
        if read_offline or i == 0:
            probe = Image.open(img_path)
            W0, H0 = probe.size
            size = (W0 // factor, H0 // factor) if factor > 1 else None
            images.append(_read_image(img_path, size))

    poses = np.stack(poses).astype(np.float32)
    images = np.stack(images).astype(np.float32)
    H, W = images[0].shape[:2]
    focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, poses, [H, W, focal], image_paths


def read_intrinsics(filepath: str) -> np.ndarray:
    """Either a 4x4/3x3 matrix or an `f cx cy _` first line.

    Reference: dataset/load_t2.py:10-26.
    """
    try:
        return np.loadtxt(filepath).astype(np.float32)[:3, :3]
    except (ValueError, IndexError):
        pass
    with open(filepath) as f:
        fo, cx, cy, _ = map(float, f.readline().split())
    return np.array([[fo, 0.0, cx], [0.0, fo, cy], [0.0, 0.0, 1.0]], np.float32)


def load_t2_data(basedir: str, factor: int = 1, split: str = "train",
                 read_offline: bool = True, tgtH: int = 1280, tgtW: int = 2176):
    """rgb/ + pose/*.txt, split by filename prefix (0*=train, 1*=test).

    Reference: dataset/load_t2.py:29-86. Poses are post-multiplied by the
    Blender->OpenCV flip; intrinsics rescale to the decoded image size.
    """
    from PIL import Image
    colordir = os.path.join(basedir, "rgb")
    posedir = os.path.join(basedir, "pose")
    prefix = "0" if split == "train" else "1"
    if split not in ("train", "test"):
        raise ValueError(f"Unknown split: {split}")
    names = [f for f in os.listdir(colordir)
             if os.path.isfile(os.path.join(colordir, f)) and f.startswith(prefix)]
    names = sorted(names, key=lambda x: int(x.split(".")[0].split("_")[-1]))

    intr = read_intrinsics(os.path.join(basedir, "intrinsics.txt"))
    fx, _, cx = intr[0]
    _, fy, cy = intr[1]

    images, poses, image_paths = [], [], []
    W = H = None
    for i, name in enumerate(names):
        img_path = os.path.abspath(os.path.join(colordir, name))
        image_paths.append(img_path)
        if read_offline or i == 0:
            probe = Image.open(img_path)
            W, H = probe.size
            size = (tgtW // factor, tgtH // factor) if factor != 1 else None
            images.append(_read_image(img_path, size))
        pose = np.loadtxt(os.path.join(
            posedir, name.replace(".png", ".txt"))).astype(np.float32)
        poses.append(pose @ BLENDER2OPENCV)

    images = np.stack(images).astype(np.float32)
    poses = np.stack(poses).astype(np.float32)
    realH, realW = images.shape[1:3]
    fx = fx * (realW / W)
    fy = fy * (realH / H)
    return images, poses, [realH, realW, fx, fy], image_paths


def composite_background(images: np.ndarray, white_bg: bool) -> np.ndarray:
    """Alpha-composite RGBA onto white, or zero out white pixels on black.

    Reference: dataset/utils.py:141-159 (same rule reused by the lazy
    per-image path at dataset/dataset.py:56-61).
    """
    if white_bg and images.shape[-1] == 4:
        return images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    if not white_bg:
        images = images[..., :3].copy()
        mask = images.sum(-1) == 3.0
        images[mask] = 0.0
        return images
    return images[..., :3]


def load_meta_data(args, mode: str = "train"):
    """Dispatch on dataset type; returns (images, c2w, H, W, fx, fy, paths).

    Reference: dataset/utils.py:121-169.
    """
    if args.type == "synthetic":
        images, poses, hwf, paths = load_blender_data(
            args.path, split=mode, factor=args.factor,
            read_offline=args.read_offline)
        H, W, focal = hwf
        fx = fy = focal
        images = composite_background(images, args.white_bg)
    elif args.type == "t2":
        images, poses, hwf, paths = load_t2_data(
            args.path, factor=args.factor, split=mode,
            read_offline=args.read_offline)
        H, W, fx, fy = hwf
        images = composite_background(images, args.white_bg)
    else:
        raise ValueError(f"Unknown dataset type: {args.type}")
    return images, poses, H, W, fx, fy, paths
