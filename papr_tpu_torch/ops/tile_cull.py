"""Tile cone culling: hierarchical top-k selection exploiting ray coherence
(``papr_tpu/ops/tile_cull.py``).

Rays in a 16x16 pixel block span a cone of half-angle delta around the
block's mean direction c. For a point p with v = p - o, alpha = angle(v, c),
every ray's distance to p is at least

    LB = |v| * min(sin(alpha - delta), sin(alpha + delta))  (0 if alpha < delta)

so ranking points by LB and keeping the M smallest keeps every exact winner
whenever at most M points can beat it in lower bound.

Pipeline:
  1. (torch) per tile: cone axis and half-angle, the bounds from one
     (T, 3) x (3, P) product, the M smallest by a sort of the bounds packed
     in the stage-3 layout ('packsort', the eval default), an exact stable
     sort ('sort') or an exact top-k ('approx', the training default);
  2. (torch) gather the (T, 8, M) candidate records;
  3. (kernel) exact distances to the tile's rays over its candidates and
     the k best per ray (``cull_select``: ``csrc/cull_topk.cu``, or
     ``cull_select_plain`` for CPU tensors), with the sound early exit for
     sorted prefilters;
  4. (torch) untile to row-major ray order.

The pack keeps 17 value bits and 15 index bits (``ops/topk.py``), so
P <= 32768.

The training prefilter 'approx' is ``jax.lax.approx_min_k`` in the JAX
package. Off the TPU that call returns the exact set of the ``take``
smallest bounds (in another order; ties among equal bounds may resolve
otherwise), so the port reads 'approx' as the exact top-k of the lower
bounds, ties to the lower index as ``lax.top_k`` (the JAX branch for
``take >= P``) resolves them: the candidate set is exact, recall 1.0 >=
``tpu.cull_recall``, which has nothing left to trade. As in the JAX package,
'approx' turns the early exit off, which at the training block of 16 gives
one 2048-wide chunk per tile in stage 3.
"""

from __future__ import annotations

import torch

from .topk import IDX_MASK, MAXI, VAL_MASK

RAY_TILE = 256
CAND_CHUNK = 2048


def _chunk_for(tr: int, m: int = CAND_CHUNK) -> int:
    """Candidate-chunk size for a ray tile of ``tr`` rays and cap ``m`` (the
    JAX package's chunking, kept so the early exit decides identically)."""
    m_aligned = max(512, -(-m // 512) * 512)
    return max(512, min((RAY_TILE * CAND_CHUNK) // tr, m_aligned))


def tile_rays(rays_d: torch.Tensor, block: int = 16):
    """(H, W, 3) -> (T, block*block, 3) edge-padded pixel-block tiles + meta."""
    H, W, _ = rays_d.shape
    Hp, Wp = -(-H // block) * block, -(-W // block) * block
    dev = rays_d.device
    rows = torch.clamp_max(torch.arange(Hp, device=dev), H - 1)
    cols = torch.clamp_max(torch.arange(Wp, device=dev), W - 1)
    padded = rays_d[rows][:, cols]
    by, bx = Hp // block, Wp // block
    tiles = padded.reshape(by, block, bx, block, 3).permute(0, 2, 1, 3, 4)
    return (tiles.reshape(by * bx, block * block, 3).contiguous(),
            (H, W, Hp, Wp, block, by, bx))


def untile_indices(idx_tiles: torch.Tensor, meta) -> torch.Tensor:
    """(T, TR, k) -> (H*W, k) in original row-major ray order."""
    H, W, Hp, Wp, block, by, bx = meta
    k = idx_tiles.shape[-1]
    x = idx_tiles.reshape(by, bx, block, block, k).permute(0, 2, 1, 3, 4)
    return x.reshape(Hp, Wp, k)[:H, :W].reshape(H * W, k)


def pack(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(bits(value) & VAL_MASK) | index for non-negative fp32 values."""
    return (values.contiguous().view(torch.int32) & VAL_MASK) | index


# --------------------------------------------------------------- stage 3 ----

def smallest_packed(tiles, f, recs, k: int) -> torch.Tensor:
    """tiles (b, TR, 3), f (b, TR), recs (b, 8, M) -> (b, TR, k) int32: each
    ray's k smallest distinct packed distances over all M candidates,
    ascending (MAXI where fewer than k exist)."""
    t = (tiles[..., 0:1] * recs[:, None, 0] + tiles[..., 1:2] * recs[:, None, 1]
         + tiles[..., 2:3] * recs[:, None, 2])                  # (b, TR, M)
    dist = torch.clamp_min(recs[:, None, 3] - t * t * f[..., None], 0.0)
    packed = pack(dist, recs[:, None, 4].to(torch.int32))
    srt = torch.sort(packed, dim=-1).values
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[..., 1:] = srt[..., 1:] == srt[..., :-1]
    srt = torch.where(dup, MAXI, srt)
    return torch.topk(srt, k, dim=-1, largest=False, sorted=True).values


def cull_select_plain(tiles, f, recs, k: int, chunk: int, early_exit: bool,
                      tile_batch: int = 64) -> torch.Tensor:
    """Plain PyTorch version of stage 3: tiles (T, TR, 3), f (T, TR), recs
    (T, 8, M) -> (T, TR, k) int32, the index bits of each ray's k smallest
    distinct packed distances in ascending order (index 0x7FFF where fewer
    than k exist). The early exit is sound, so this version scans every
    candidate and gives the same result."""
    cull_select_plain.calls += 1
    out = [smallest_packed(tiles[s:s + tile_batch], f[s:s + tile_batch],
                           recs[s:s + tile_batch], k) & IDX_MASK
           for s in range(0, tiles.shape[0], tile_batch)]
    return torch.cat(out, dim=0).to(torch.int32)


cull_select_plain.calls = 0


def cull_select(tiles, f, recs, k: int, chunk: int,
                early_exit: bool) -> torch.Tensor:
    """Stage 3 of the culled selection: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. Same contract as
    :func:`cull_select_plain`."""
    if not tiles.is_cuda:
        return cull_select_plain(tiles, f, recs, k, chunk, early_exit)
    from ..kernels import build

    T, TR, _ = tiles.shape
    M = recs.shape[-1]
    for name, t, shape in (("tiles", tiles, (T, TR, 3)), ("f", f, (T, TR)),
                           ("recs", recs, (T, 8, M))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name}: want CUDA float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    if TR > 1024 or M % chunk or k > 64:
        raise NotImplementedError(f"cull kernel takes TR <= 1024, M a "
                                  f"multiple of chunk, k <= 64 (TR={TR}, "
                                  f"M={M}, chunk={chunk}, k={k})")
    tiles, f, recs = tiles.contiguous(), f.contiguous(), recs.contiguous()
    out = torch.empty(T, TR, k, dtype=torch.int32, device=tiles.device)
    rc = build.load().papr_cull_topk(
        tiles.data_ptr(), f.data_ptr(), recs.data_ptr(), T, TR, M, chunk, k,
        int(bool(early_exit)), out.data_ptr(),
        torch.cuda.current_stream(tiles.device).cuda_stream)
    build.check(rc, "papr_cull_topk")
    cull_select.launches += 1
    return out


cull_select.launches = 0


# ------------------------------------------------------------ full select ----

def cull_inputs(points, alive, rays_o, rays_d_hw, M: int = 2048,
                block: int = 16, eps: float = 1e-6, prefilter: str = "sort",
                early_exit: bool = True):
    """Stages 1 and 2: returns (tiles, f, recs, chunk, early_exit, meta),
    the arguments of stage 3 plus the untile metadata."""
    if prefilter not in ("packsort", "sort", "approx"):
        raise NotImplementedError(f"cull prefilter {prefilter!r}")
    P = points.shape[0]
    if P > IDX_MASK + 1:
        raise ValueError(
            f"select_topk_culled packs global point indices into "
            f"{IDX_MASK + 1}-entry index bits; got P={P}. "
            "Use tpu.topk_impl: xla for larger clouds.")
    chunk = _chunk_for(block * block, M)
    early_exit = early_exit and prefilter in ("packsort", "sort")
    if early_exit:
        chunk = min(chunk, 512)
    Mp = max(-(-M // chunk) * chunk, chunk)
    early_exit = early_exit and Mp // chunk > 1
    points = points.detach().float()
    rays_o = rays_o.detach().float().reshape(3)
    tiles, meta = tile_rays(rays_d_hw.detach().float(), block)   # (T, TR, 3)
    T, TR, _ = tiles.shape
    dev = tiles.device

    # ---- stage 1: per-tile cone + bounds ----
    unit = tiles / torch.linalg.norm(tiles, dim=-1, keepdim=True)
    c = unit.sum(1)
    c = c / torch.linalg.norm(c, dim=-1, keepdim=True)            # (T, 3)
    cosd = torch.clamp((unit * c[:, None, :]).sum(-1).amin(1), -1.0, 1.0)
    sind = torch.sqrt(torch.clamp_min(1.0 - cosd * cosd, 0.0))
    v = points - rays_o                                           # (P, 3)
    vnorm2 = (v * v).sum(-1)
    vnorm = torch.sqrt(vnorm2)
    cos_a = torch.clamp((c @ v.T) / torch.clamp_min(vnorm, eps)[None, :],
                        -1.0, 1.0)                                # (T, P)
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    sd, cd = sind[:, None], cosd[:, None]
    sin_lo = sin_a * cd - cos_a * sd                  # sin(alpha - delta)
    sin_hi = sin_a * cd + cos_a * sd                  # sin(alpha + delta)
    crosses = (cos_a > cd) | (cos_a < -cd)
    lb_sin = torch.where(crosses, 0.0,
                         torch.minimum(torch.abs(sin_lo), torch.abs(sin_hi)))
    LB = vnorm[None, :] * lb_sin
    LB = torch.where(alive[None, :], LB, float("inf"))
    del unit, cos_a, sin_a, sin_lo, sin_hi, crosses, lb_sin

    take = min(Mp, P)
    if prefilter == "packsort":
        pidx = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
        cand = torch.sort(pack(LB, pidx), dim=1).values[:, :take] & IDX_MASK
    else:                                  # sort, approx: exact, stable
        cand = torch.sort(LB, dim=1, stable=True).indices[:, :take]
    cand = cand.long()
    if take < Mp:                                     # tiny clouds: pad
        cand = torch.nn.functional.pad(cand, (0, Mp - take))

    # ---- stage 2: candidate records ----
    dead_inf = torch.where(alive, 0.0, float("inf"))
    rec = torch.cat([v.T, (vnorm2 + dead_inf)[None, :],
                     torch.zeros(4, P, device=dev)], dim=0)       # (8, P)
    recs = rec[:, cand.reshape(-1)].reshape(8, T, Mp).permute(1, 0, 2)
    recs = recs.contiguous()
    recs[:, 4, :] = cand.float()                      # global index (exact)
    lane = torch.arange(Mp, device=dev)[None, :]
    if early_exit:
        # squared lower bound, ascending (the sorted prefilter's order)
        lb_cand = torch.gather(LB, 1, cand)
        lb_cand = lb_cand * lb_cand
        if take < Mp:
            lb_cand = torch.where(lane >= take, float("inf"), lb_cand)
        recs[:, 5, :] = lb_cand
    if take < Mp:
        # pad slots alias index 0: kill their distance
        recs[:, 3, :] = torch.where(lane >= take, float("inf"), recs[:, 3, :])

    dd = (tiles * tiles).sum(-1)
    f = (dd + 2 * eps) / (dd + eps) ** 2                          # (T, TR)
    return tiles, f, recs, chunk, early_exit, meta


def select_topk_culled(points, alive, rays_o, rays_d_hw, k: int,
                       M: int = 2048, block: int = 16, eps: float = 1e-6,
                       prefilter: str = "sort",
                       early_exit: bool = True) -> torch.Tensor:
    """points (P, 3), alive (P,), rays_o (3,), rays_d_hw (H, W, 3) ->
    (H*W, k) int32 global indices (row-major ray order)."""
    tiles, f, recs, chunk, early_exit, meta = cull_inputs(
        points, alive, rays_o, rays_d_hw, M, block, eps, prefilter,
        early_exit)
    winners = cull_select(tiles, f, recs, k, chunk, early_exit)
    flat = untile_indices(winners, meta)
    return torch.clamp_max(flat, points.shape[0] - 1)
