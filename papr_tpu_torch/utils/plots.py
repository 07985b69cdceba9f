"""Training/test visualization panels (matplotlib, host-side;
``papr_tpu/utils/plots.py``).

Behavioral spec: reference utils.py:80-403 — the main training dashboard
(targets / predictions / loss curves / point cloud / depth / LRs / PSNR),
multi-view point-cloud scatter panels, and the test-time pcrgb panel used to
assemble videos. Rendered to PIL Images so callers can save or mimwrite.
"""

from __future__ import annotations

import io

import numpy as np


def available() -> bool:
    """Whether the figures can be drawn: a host without matplotlib skips
    the figures a config asks for (``eval.save_fig``), with one warning, and
    the run goes on."""
    import importlib.util
    if importlib.util.find_spec("matplotlib") is not None:
        return True
    if not available.warned:
        available.warned = True
        import warnings
        warnings.warn("matplotlib is not installed: the figures that "
                      "eval.save_fig asks for are skipped")
    return False


available.warned = False


def _plt():
    """matplotlib's pyplot on the Agg backend, imported at first use (the
    package imports without matplotlib; only the plots need it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _fig_to_image(fig) -> Image.Image:
    from PIL import Image
    plt = _plt()
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    buf.seek(0)
    return Image.open(buf).copy()


def influence_colors(weights: np.ndarray) -> np.ndarray:
    """Red-blue ramp by normalized influence (reference utils.py:80-86)."""
    w = np.asarray(weights).reshape(-1).astype(np.float64)
    rng = w.max() - w.min()
    w = (w - w.min()) / (rng if rng > 0 else 1.0)
    colors = np.ones((len(w), 3))
    colors[:, 0] = w
    colors[:, 1] = 0.0
    colors[:, 2] = 1.0 - w
    return colors


def training_main_plot(index: str, steps, train_tgt_rgb, train_tgt_patch,
                       train_pred_patch, test_tgt_rgb, test_pred_rgb,
                       train_losses, eval_losses, points, pt_plot_scale,
                       depth, pt_lrs, attn_lrs, eval_psnrs,
                       influ_scores=None) -> Image.Image:
    step = steps[-1]
    plt = _plt()
    fig = plt.figure(figsize=(20, 10))

    for i, (img, title) in enumerate([
            (train_tgt_rgb, "train target"),
            (train_tgt_patch, "train target patch"),
            (np.clip(train_pred_patch, 0, 1), "train pred patch")]):
        ax = fig.add_subplot(2, 5, i + 1)
        ax.imshow(np.clip(img, 0, 1))
        ax.set_title(f"iter {step}: {title}")

    ax = fig.add_subplot(2, 5, 4)
    ax.plot(steps, train_losses[-len(steps):], label="train")
    ax.plot(steps, eval_losses[-len(steps):], label="eval")
    ax.legend(); ax.set_title("losses")

    ax = fig.add_subplot(2, 5, 5, projection="3d")
    colors = influence_colors(influ_scores) if influ_scores is not None else None
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c=colors)
    ax.set_xlim(-pt_plot_scale, pt_plot_scale)
    ax.set_ylim(-pt_plot_scale, pt_plot_scale)
    ax.set_zlim(-pt_plot_scale, pt_plot_scale)
    ax.set_title(f"{points.shape[0]} points")

    ax = fig.add_subplot(2, 5, 6)
    ax.imshow(np.clip(test_tgt_rgb, 0, 1)); ax.set_title("eval target")
    ax = fig.add_subplot(2, 5, 7)
    ax.imshow(np.clip(test_pred_rgb, 0, 1)); ax.set_title("eval pred")
    ax = fig.add_subplot(2, 5, 8)
    ax.imshow(depth, cmap="magma"); ax.set_title("depth")

    ax = fig.add_subplot(2, 5, 9)
    ax.plot(steps, pt_lrs[-len(steps):], label="points lr")
    ax.plot(steps, attn_lrs[-len(steps):], label="attn lr")
    ax.legend(); ax.set_title("learning rates")

    ax = fig.add_subplot(2, 5, 10)
    ax.plot(steps, eval_psnrs[-len(steps):])
    ax.set_title(f"eval PSNR {eval_psnrs[-1]:.2f}")

    fig.suptitle(f"{index} @ step {step}")
    return _fig_to_image(fig)


def pcd_plot(index: str, step: int, rayo, rayd, points, coord_scale,
             pt_plot_scale, influ_scores=None) -> Image.Image:
    """Training point-cloud panel (reference utils.py:161-251): four 3D views
    (elev 0 at azim 90/180/270 plus the near-top 'View 1 Up'), each with the
    camera origin (red) and the central ray direction (blue quiver), colored
    by influence score; plus influence-score scatter and histogram panels
    when scores are given (reference panels 5-6)."""
    n = 6 if influ_scores is not None else 4
    plt = _plt()
    fig = plt.figure(figsize=(5 * n, 6))
    colors = ("orange" if influ_scores is None
              else influence_colors(influ_scores))
    views = [(0.0, 90, "Point Cloud View 1"),
             (0.0, 180, "Point Cloud View 2"),
             (0.0, 270, "Point Cloud View 3"),
             (89.9, 90, "Point Cloud View 1 Up")]
    for i, (elev, azim, title) in enumerate(views):
        ax = fig.add_subplot(1, n, i + 1, projection="3d")
        ax.view_init(elev=elev, azim=azim)
        ax.set_xlim(-pt_plot_scale, pt_plot_scale)
        ax.set_ylim(-pt_plot_scale, pt_plot_scale)
        ax.set_zlim(-pt_plot_scale, pt_plot_scale)
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
        ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=colors,
                   s=0.8 * coord_scale)
        if rayo is not None:
            ro = np.asarray(rayo).reshape(-1)[:3]
            ax.scatter([ro[0]], [ro[1]], [ro[2]], c="red", s=10)
            if rayd is not None:
                rd = np.asarray(rayd)
                H, W = rd.shape[0], rd.shape[1]
                c = rd[H // 2, W // 2]
                ax.quiver(ro[0], ro[1], ro[2], c[0], c[1], c[2],
                          length=2, alpha=1, color="blue")
        ax.set_title(title)
    if influ_scores is not None:
        scores = np.asarray(influ_scores).reshape(-1)
        ax = fig.add_subplot(1, n, 5)
        ax.scatter(range(len(scores)), scores)
        ax.set_title("Confidence Scores scatter plot")
        ax = fig.add_subplot(1, n, 6)
        ax.hist(scores, bins=np.linspace(-1, 1, 100).tolist())
        ax.set_title("Confidence Scores histogram")
    fig.suptitle(f"Point Clouds\n{index}\niter {step}")
    return _fig_to_image(fig)


def pcd_single_plot(step: int, points, pt_plot_scale,
                    influ_scores=None) -> Image.Image:
    """Rotating-cloud video frame (reference utils.py:254-280)."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    colors = influence_colors(influ_scores) if influ_scores is not None else None
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c=colors)
    ax.view_init(elev=20, azim=(step / 200) % 360)
    ax.set_xlim(-pt_plot_scale, pt_plot_scale)
    ax.set_ylim(-pt_plot_scale, pt_plot_scale)
    ax.set_zlim(-pt_plot_scale, pt_plot_scale)
    ax.set_title(f"step {step}: {points.shape[0]} pts")
    return _fig_to_image(fig)


def test_featmap_attn_plot(frame: int, th, points, rgb_pred, rgb_gt,
                           pt_plot_scale, featmap, attn,
                           influ_scores=None) -> Image.Image:
    """Feature-map channel panel + attention-weight maps (reference
    utils.py:342-403; note the reference's caveat that per-pixel top-k sets
    differ, so channel maps are indicative only)."""
    plt = _plt()
    fig = plt.figure(figsize=(16, 8))
    ax = fig.add_subplot(2, 4, 1, projection="3d")
    colors = influence_colors(influ_scores) if influ_scores is not None else None
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c=colors)
    ax.set_xlim(-pt_plot_scale, pt_plot_scale)
    ax.set_ylim(-pt_plot_scale, pt_plot_scale)
    ax.set_zlim(-pt_plot_scale, pt_plot_scale)
    ax = fig.add_subplot(2, 4, 2)
    ax.imshow(np.clip(rgb_pred, 0, 1)); ax.set_title("pred"); ax.axis("off")
    ax = fig.add_subplot(2, 4, 3)
    ax.imshow(np.clip(rgb_gt, 0, 1)); ax.set_title("gt"); ax.axis("off")
    ax = fig.add_subplot(2, 4, 4)
    ax.imshow(featmap.mean(-1), cmap="viridis")
    ax.set_title("feat mean"); ax.axis("off")
    for i in range(3):
        ax = fig.add_subplot(2, 4, 5 + i)
        ax.imshow(featmap[..., i], cmap="viridis")
        ax.set_title(f"feat ch{i}"); ax.axis("off")
    ax = fig.add_subplot(2, 4, 8)
    ax.imshow(attn[..., -1], cmap="magma")
    ax.set_title("bkg attention"); ax.axis("off")
    fig.suptitle(f"frame {frame}")
    return _fig_to_image(fig)


def test_pcrgb_plot(frame: int, th, azim, psnr, points, rgb_pred, rgb_gt,
                    depth, pt_plot_scale, influ_scores=None) -> Image.Image:
    """Test video frame: rotating cloud + pred/gt/depth (utils.py:283-340)."""
    plt = _plt()
    fig = plt.figure(figsize=(16, 4))
    ax = fig.add_subplot(1, 4, 1, projection="3d")
    colors = influence_colors(influ_scores) if influ_scores is not None else None
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=0.5, c=colors)
    ax.view_init(elev=20, azim=azim)
    ax.set_xlim(-pt_plot_scale, pt_plot_scale)
    ax.set_ylim(-pt_plot_scale, pt_plot_scale)
    ax.set_zlim(-pt_plot_scale, pt_plot_scale)
    for i, (img, title) in enumerate([
            (rgb_pred, f"pred (PSNR {psnr:.2f})"), (rgb_gt, "gt")]):
        ax = fig.add_subplot(1, 4, i + 2)
        ax.imshow(np.clip(img, 0, 1)); ax.set_title(title); ax.axis("off")
    ax = fig.add_subplot(1, 4, 4)
    ax.imshow(depth, cmap="magma"); ax.set_title("depth"); ax.axis("off")
    fig.suptitle(f"frame {frame}")
    return _fig_to_image(fig)
