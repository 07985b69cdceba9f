"""Streaming top-k selection over every point (``papr_tpu/ops/pallas_topk.py``,
``tpu.topk_impl: pallas``).

Point-to-ray distance and a running k-best per ray with no (rays, points)
distance matrix and no sort. The pack trick of ``ops/topk.py``: for a
non-negative fp32 distance ``(bits(dist) & ~0x7FFF) | index`` is one int32
whose order is distance order (ties to the lower index) and which carries
the winner's identity, so the k smallest packed keys are the selection.
Distances keep 8 mantissa bits: two points whose distances differ by less
than 0.4 % may swap ranks against the exact selection
(``tpu.topk_impl: xla``).

``topk_stream`` is the wrapper of the CUDA kernel in ``csrc/topk_stream.cu``
(the port of the Pallas ``_topk_kernel``); ``topk_stream_plain`` is the same
function in plain PyTorch, written with the kernel's operation order so the
two are bit-equal. A CPU tensor takes the plain version; a CUDA tensor takes
the kernel or raises. ``pallas_select_topk`` keeps the JAX package's name and
signature.

Constraints: P <= 32768 (the index must fit 15 bits). Points are padded to a
multiple of 2048 with +inf slots as in the JAX package, so with fewer than k
alive points the dead and padded slots fill the tail in index order, clamped
to P - 1.
"""

from __future__ import annotations

import torch

from .topk import IDX_BITS, IDX_MASK, VAL_MASK

POINT_CHUNK = 2048
RAY_BLOCK = 64           # rays (threads) per CUDA block


def stream_inputs(points, alive, rays_o, rays_d, eps: float = 1e-6):
    """The kernel's operands (pallas_topk.py:137-148): rays (R, 3), the
    per-ray scale f (R,), v^T (3, Ppad) and |v|^2 (Ppad,) with +inf for dead
    and padded slots; all fp32, detached (selection is not differentiated)."""
    P = points.shape[0]
    if P > (1 << IDX_BITS):
        raise ValueError(
            f"pallas topk supports <= {1 << IDX_BITS} points, got {P}")
    Ppad = -(-P // POINT_CHUNK) * POINT_CHUNK
    v = points.detach().float() - rays_o.detach().float().reshape(3)
    v2 = (v * v).sum(-1) + torch.where(alive, 0.0, float("inf"))
    vT = torch.nn.functional.pad(v.T, (0, Ppad - P)).contiguous()
    v2 = torch.nn.functional.pad(v2, (0, Ppad - P),
                                 value=float("inf")).contiguous()
    rd = rays_d.detach().float().contiguous()
    dd = (rd * rd).sum(-1)
    f = ((dd + 2 * eps) / (dd + eps) ** 2).contiguous()
    return rd, f, vT, v2


def topk_stream_plain(rd, f, vT, v2, k: int, ray_chunk: int = 1024):
    """Plain PyTorch version: rays (R, 3), f (R,), vT (3, Ppad), v2 (Ppad,)
    -> (R, k) int32, the index bits of each ray's k smallest packed keys in
    ascending key order. Every product and sum is rounded on its own, in the
    kernel's order."""
    topk_stream_plain.calls += 1
    Ppad = v2.shape[0]
    col = torch.arange(Ppad, dtype=torch.int32, device=rd.device)[None, :]
    out = []
    for s in range(0, rd.shape[0], ray_chunk):
        d = rd[s:s + ray_chunk]
        t = (d[:, 0:1] * vT[0:1] + d[:, 1:2] * vT[1:2]) + d[:, 2:3] * vT[2:3]
        dist = torch.clamp_min(v2[None, :] - (t * t) * f[s:s + ray_chunk, None],
                               0.0)
        key = (dist.contiguous().view(torch.int32) & VAL_MASK) | col
        best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        out.append(best & IDX_MASK)
    return torch.cat(out, dim=0).to(torch.int32)


topk_stream_plain.calls = 0


def topk_stream(rd, f, vT, v2, k: int) -> torch.Tensor:
    """The streaming selection on prepared operands: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Same contract as
    :func:`topk_stream_plain`."""
    if not rd.is_cuda:
        return topk_stream_plain(rd, f, vT, v2, k)
    from ..kernels import build

    R = rd.shape[0]
    Ppad = v2.shape[0]
    for name, t, shape in (("rays", rd, (R, 3)), ("f", f, (R,)),
                           ("vT", vT, (3, Ppad)), ("v2", v2, (Ppad,))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_cuda or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous CUDA float32 {shape}, "
                             f"got {tuple(t.shape)} {t.dtype} {t.device}")
    if k > 64 or k < 1 or Ppad > (1 << IDX_BITS):
        raise NotImplementedError(
            f"streaming top-k kernel takes 1 <= k <= 64 and <= "
            f"{1 << IDX_BITS} padded points (k={k}, Ppad={Ppad})")
    out = torch.empty(R, k, dtype=torch.int32, device=rd.device)
    rc = build.load().papr_topk_stream(
        rd.data_ptr(), f.data_ptr(), vT.data_ptr(), v2.data_ptr(), R, Ppad, k,
        RAY_BLOCK, out.data_ptr(),
        torch.cuda.current_stream(rd.device).cuda_stream)
    build.check(rc, "papr_topk_stream")
    topk_stream.launches += 1
    return out


topk_stream.launches = 0


def pallas_select_topk(points, alive, rays_o, rays_d, k: int,
                       eps: float = 1e-6) -> torch.Tensor:
    """(P, 3) points, (P,) alive, (3,) origin, (R, 3) dirs -> (R, k) int32.
    Same selection as ``ops.topk.select_topk`` up to the documented distance
    quantization."""
    rd, f, vT, v2 = stream_inputs(points, alive, rays_o, rays_d, eps)
    idx = topk_stream(rd, f, vT, v2, k)
    return torch.clamp_max(idx, points.shape[0] - 1)
