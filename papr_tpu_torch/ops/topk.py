"""Exact top-k nearest-point-to-ray selection (``papr_tpu/ops/topk.py``).

With v_p = p - o shared across the rays of one camera,

    dist^2(r, p) = ||v_p||^2 - t^2 * (dd + 2*eps) / (dd + eps)^2,
    t = d_r . v_p,   dd = d_r . d_r,

so the only pairwise quantity is one (R, 3) x (3, P) product; the algebra
keeps the reference's eps placement. Rays go in chunks so the (chunk, P)
score block is the only large temporary. Dead points get +inf.

Also home of the pack constants shared by the tile-cull selection
(``papr_tpu/ops/pallas_topk.py:36-42``): a non-negative fp32 distance's bits
order like its value, so ``(bits & VAL_MASK) | index`` is one int32 whose
order is distance order with the index as tie-break. 17 value bits and 15
index bits, so P <= 32768.
"""

from __future__ import annotations

import torch

IDX_BITS = 15
IDX_MASK = (1 << IDX_BITS) - 1   # 0x7FFF
VAL_MASK = -(1 << IDX_BITS)      # 0xFFFF8000 as two's-complement int32
MAXI = 0x7FFFFFFF


def pairwise_dist2(points: torch.Tensor, rays_o: torch.Tensor,
                   rays_d: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """points (P, 3), rays_o (3,), rays_d (R, 3) -> (R, P) squared distances
    in fp32 without (R, P, 3) temporaries."""
    v = points.float() - rays_o.float()
    v2 = (v * v).sum(-1)
    rays_d = rays_d.float()
    t = rays_d @ v.T
    dd = (rays_d * rays_d).sum(-1)
    f = (dd + 2 * eps) / (dd + eps) ** 2
    return v2[None, :] - (t * t) * f[:, None]


def select_topk(points: torch.Tensor, alive: torch.Tensor,
                rays_o: torch.Tensor, rays_d: torch.Tensor, k: int,
                eps: float = 1e-6, chunk: int = 4096) -> torch.Tensor:
    """(R, k) int32 indices of the k alive points nearest each ray, nearest
    first (the order among exactly equal distances is unspecified)."""
    dead_bias = torch.where(alive, 0.0, float("inf")).float()
    out = []
    for s in range(0, rays_d.shape[0], chunk):
        d2 = pairwise_dist2(points, rays_o, rays_d[s:s + chunk], eps)
        d2 = d2 + dead_bias[None, :]
        idx = torch.topk(d2, k, dim=1, largest=False, sorted=True).indices
        out.append(idx.to(torch.int32))
    return torch.cat(out, dim=0)
