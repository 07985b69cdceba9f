"""Video writing with graceful degradation (``papr_tpu/utils/video.py``).

mp4 via imageio-ffmpeg when available (reference train.py:297, test.py:282);
falls back to animated GIF (pure PIL) so observability artifacts survive
environments without an ffmpeg backend.
"""

from __future__ import annotations

import os

import numpy as np


def write_video(path: str, frames, fps: int = 30, quality: int = 10) -> str:
    """frames: list of HxWx3 uint8/float arrays or PIL Images. Returns the
    path actually written (possibly .gif)."""
    from PIL import Image

    arrs = []
    for f in frames:
        if hasattr(f, "convert"):
            arrs.append(np.asarray(f.convert("RGB")))
        else:
            a = np.asarray(f)
            if a.dtype != np.uint8:
                a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
            arrs.append(a)

    try:
        import imageio
        imageio.mimwrite(path, arrs, fps=fps, quality=quality)
        return path
    except Exception:
        gif_path = os.path.splitext(path)[0] + ".gif"
        imgs = [Image.fromarray(a) for a in arrs]
        imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return gif_path
