"""Camera/ray geometry (``papr_tpu/ops/geometry.py``).

Ray generation keeps the reference pixel-center convention: image-plane
coordinates in units of 1/focal, y pointing up, camera looking down -z,
directions rotated to world by c2w and normalized. ``get_rays_np`` is the
host-side numpy version that feeds ``render_full_image``; ``get_rays`` is
its on-device twin used by the serving path (``render_frame``).
"""

from __future__ import annotations

import numpy as np
import torch


def get_rays_np(H: int, W: int, focal_x: float, focal_y: float,
                c2w: np.ndarray, fineness: int = 1):
    """c2w: (N, 4, 4). Returns rays_o (N, 3) and unit rays_d (N, H, W, 3)."""
    width = np.linspace(0, W / focal_x, int(W / fineness) + 1, dtype=np.float32)
    height = np.linspace(0, H / focal_y, int(H / fineness) + 1, dtype=np.float32)
    y, x = np.meshgrid(height, width, indexing="ij")
    px, py = width[1] - width[0], height[1] - height[0]
    x = (x - W / focal_x / 2 + px / 2)[:-1, :-1]
    y = -(y - H / focal_y / 2 + py / 2)[:-1, :-1]
    dirs = np.stack([x, y, -np.ones_like(x)], axis=-1)  # (H, W, 3) camera frame
    rot = c2w[:, :3, :3].astype(np.float32)             # (N, 3, 3)
    rays_d = np.einsum("nij,hwj->nhwi", rot, dirs)
    rays_o = c2w[:, :3, -1].astype(np.float32)
    norm = np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return rays_o, (rays_d / norm).astype(np.float32)


def get_rays(H: int, W: int, c2w: torch.Tensor, focal: torch.Tensor):
    """On-device twin of :func:`get_rays_np` at fineness=1
    (``get_rays_jnp``). c2w (4, 4), focal (2,) [fx, fy] on the target device
    -> rays_o (1, 3), unit rays_d (H, W, 3)."""
    dev = c2w.device
    x = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2 + 0.5) / focal[0]
    y = -(torch.arange(H, dtype=torch.float32, device=dev) - H / 2 + 0.5) / focal[1]
    dirs = torch.stack([x[None, :].expand(H, W), y[:, None].expand(H, W),
                        torch.full((H, W), -1.0, device=dev)], dim=-1)
    rays_d = torch.einsum("ij,hwj->hwi", c2w[:3, :3], dirs)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return c2w[:3, -1][None], rays_d


def normalize_vector(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Reference models/utils.py:255-257 (norm + eps in the denominator)."""
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def point_ray_geometry(points: torch.Tensor, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, eps: float = 1e-6):
    """Decompose (point - origin) along/across each ray.

    points (..., K, 3), rays_o broadcastable (..., 3), rays_d (..., 3) ->
    proj (..., K, 3), perp (..., K, 3) and their norms (..., K, 1), with the
    reference's eps placement (``rays . rays + eps`` in the projection).
    """
    rays = normalize_vector(rays_d, eps=eps)[..., None, :]
    v = points - rays_o[..., None, :]
    t = (v * rays).sum(-1)
    dd = (rays * rays).sum(-1)
    proj = rays * (t / (dd + eps))[..., None]
    perp = v - proj
    perp_dist = torch.linalg.norm(perp, dim=-1, keepdim=True)
    proj_dist = torch.linalg.norm(proj, dim=-1, keepdim=True)
    return proj, perp, proj_dist, perp_dist
