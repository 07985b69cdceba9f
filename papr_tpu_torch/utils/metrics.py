"""Image quality metrics (numpy): PSNR and SSIM.

SSIM follows skimage.metrics.structural_similarity with the reference's
call signature (test.py:19-24): win_size=11, uniform (non-gaussian) window,
data_range=1.0, channel-averaged, with the Wang et al. defaults K1=0.01,
K2=0.03 and skimage's edge-crop behavior.
"""

from __future__ import annotations

import numpy as np


def psnr_np(pred: np.ndarray, target: np.ndarray) -> float:
    mse = float(np.mean((pred - target) ** 2))
    return -10.0 * np.log(mse) / np.log(10.0)


def _uniform_filter2d(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter via integral image, 'valid' region only."""
    pad = np.cumsum(np.cumsum(np.pad(img, ((1, 0), (1, 0))), axis=0), axis=1)
    s = (pad[win:, win:] - pad[:-win, win:] - pad[win:, :-win]
         + pad[:-win, :-win])
    return s / (win * win)


def ssim_np(img1: np.ndarray, img2: np.ndarray, win_size: int = 11,
            data_range: float = 1.0) -> float:
    """img1/img2: (H, W, C) float in [0, data_range]."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)  # skimage uses unbiased covariance estimates
    vals = []
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        ux = _uniform_filter2d(x, win_size)
        uy = _uniform_filter2d(y, win_size)
        uxx = _uniform_filter2d(x * x, win_size)
        uyy = _uniform_filter2d(y * y, win_size)
        uxy = _uniform_filter2d(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
        B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
        vals.append(np.mean((A1 * A2) / (B1 * B2)))
    return float(np.mean(vals))
