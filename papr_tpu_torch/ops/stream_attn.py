"""One-shot eval attention (``papr_tpu/ops/stream_attn.py::attend_stream_eval``).

From the gathered point records to (fused features, attention) in one
kernel: per (ray, k) the point-ray geometry, the key posenc and walk, the
``w_k`` projection, the scaled dot with the ray's query ``qq``,
``score_act`` x influence with the alive mask; the value posenc (geometry +
point features) and walk; a background-seeded online softmax and the
renormalized fuse. Forward only: the render path never differentiates.

``attend_eval_idx`` is the wrapper of the CUDA kernel in
``csrc/attend_eval.cu``; it reads record rows by index from the (P, 128)
point record plus ``idx (T, K)`` instead of a pre-gathered (K, T, 128)
tensor. ``attend_stream_eval`` keeps the JAX package's public layout
(records gathered k-major) so the tests compare like with like.
``attend_eval_plain`` is the plain PyTorch version. A CPU tensor takes the
plain version; a CUDA tensor takes the kernel or raises.

Numerics follow ``_ase_fwd_kernel``: fp32 geometry and posenc; walks as in
``ops/fused_mlp.py``; ``kk`` in the compute dtype (matmul rounded, bias
added in the compute dtype) promoted to fp32; ``qq``, scores and softmax
fp32; the value output rounded to the compute dtype and back before the
fuse; an all-dead ray divides by 1 when ``normalize`` holds.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .fused_mlp import (Walk, c_ints, check_walk_for_kernel, encode_plain,
                        pack_walk, round_up, walk_plain)

NEG_BIG = -1e30
REC_POS, REC_INFLU, REC_ALIVE, REC_FEATS = 0, 3, 4, 5
N_GEO = 9                      # raw sources [pos(3), proj(3), perp(3)]


@functools.lru_cache(maxsize=None)
def rec_pe_plan(has_pos, Ls, embed_type, factor, mult, extra_dim):
    """Posenc column plan over the per-token sources [pos?, proj, perp,
    point features] (stream_attn.py ``_rec_pe_plan`` layout, which matches
    attention.py ``_encode``). Source ids: pos 0-2, proj 3-5, perp 6-8,
    record lane ``REC_FEATS + j`` as ``N_GEO + j``."""
    base = {"pos": 0, "proj": 3, "perp": 6}
    feats = (["pos"] if has_pos else []) + ["proj", "perp"]
    cols = []
    for fi, src in enumerate(feats):
        for j in range(3):
            if embed_type == 1:
                cols.append((base[src] + j, 0.0, 0))
            for i in range(Ls[fi]):
                s = (factor ** i) * mult
                cols.append((base[src] + j, s, 1))
                cols.append((base[src] + j, s, 2))
    for j in range(extra_dim):
        cols.append((N_GEO + j, 0.0, 0))
    return tuple(cols)


def _check_score_act(score_act: str) -> None:
    if score_act not in ("relu", "none"):
        raise NotImplementedError(f"score_act {score_act}")


def attend_eval_plain(record, idx, rayo, rays, qq, kwalk: Walk, wk, bk,
                      vwalk: Walk, score_act="relu", bkg_score=5.0,
                      normalize=True, eps=1e-6, cdt=torch.float32):
    """Plain PyTorch version. record (P, rp) fp32, idx (T, K) int, rayo /
    rays (T, 3) fp32, qq (T, dm) fp32 -> fused (T, C) fp32, attn (T, K+1)."""
    attend_eval_plain.calls += 1
    _check_score_act(score_act)
    T, K = idx.shape
    n_feat = record.shape[1] - REC_FEATS
    dm = wk.shape[0]
    scores, values = [], []
    for k in range(K):
        rec = record[idx[:, k].long()]                          # (T, rp)
        sel = rec[:, :3]
        v = sel - rayo
        t_al = (v * rays).sum(-1, keepdim=True)
        dd = (rays * rays).sum(-1, keepdim=True)
        proj = rays * (t_al / (dd + eps))
        perp = v - proj
        raw = torch.cat([sel, proj, perp, rec[:, REC_FEATS:REC_FEATS + n_feat]],
                        dim=-1)
        y_k = walk_plain(encode_plain(raw, kwalk.cols), kwalk, cdt)
        kk = (y_k.to(cdt).float() @ wk.to(cdt).float().T).to(cdt)
        kk = (kk + bk.to(cdt)).float()
        col = (qq.float() * kk).sum(-1) / math.sqrt(dm)
        sact = torch.clamp_min(col, 0.0) if score_act == "relu" else col
        alive = rec[:, REC_ALIVE] > 0.5
        scores.append(torch.where(alive, sact * rec[:, REC_INFLU], NEG_BIG))
        y_v = walk_plain(encode_plain(raw, vwalk.cols), vwalk, cdt)
        values.append(y_v.to(cdt).float())
    s = torch.stack(scores, dim=1)                              # (T, K)
    m = torch.clamp_min(s.amax(dim=1, keepdim=True), bkg_score)
    e = torch.exp(s - m)
    eb = torch.exp(bkg_score - m)
    z = e.sum(dim=1, keepdim=True)
    denom = z + eb
    attn = torch.cat([e, eb], dim=1) / denom
    acc = (e.T[..., None] * torch.stack(values)).sum(0)         # (T, C)
    d = torch.where(z > 0, z, torch.ones_like(z)) if normalize else denom
    return acc / d, attn


attend_eval_plain.calls = 0


def attend_eval_idx(record, idx, rayo, rays, qq, kwalk: Walk, wk, bk,
                    vwalk: Walk, score_act="relu", bkg_score=5.0,
                    normalize=True, eps=1e-6, cdt=torch.float32):
    """One-shot eval attention from the (P, rp) record and idx (T, K): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``wk`` is the (dm, d_k_out) ``w_k`` weight (nn/mlp.py layout)."""
    if not record.is_cuda:
        return attend_eval_plain(record, idx, rayo, rays, qq, kwalk, wk, bk,
                                 vwalk, score_act, bkg_score, normalize, eps,
                                 cdt)
    from ..kernels import build

    _check_score_act(score_act)
    check_walk_for_kernel(kwalk, cdt, "attend_stream_eval key walk")
    check_walk_for_kernel(vwalk, cdt, "attend_stream_eval value walk")
    dev = record.device
    T, K = idx.shape
    P, rp = record.shape
    dm = int(wk.shape[0])
    for name, t, shape in (("rayo", rayo, (T, 3)), ("rays", rays, (T, 3)),
                           ("qq", qq, (T, dm))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"{name} must be on the card with the record")
    if record.dtype != torch.float32:
        raise ValueError("record must be float32")
    if not idx.is_cuda or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx: want integer indices on the card, got "
                         f"{idx.dtype} {idx.device}")
    need = max(c[0] for w in (kwalk, vwalk) for c in w.cols) - N_GEO
    if REC_FEATS + need >= rp:
        raise ValueError("posenc plan reads past the record width")
    d_k_out = int(kwalk.ws[-1].shape[1])
    if tuple(wk.shape) != (dm, d_k_out) or dm > 256:
        raise NotImplementedError(f"w_k {tuple(wk.shape)}: d_model <= 256")
    record = record.contiguous()
    idx = idx.to(torch.int32).contiguous()
    rayo, rays, qq = rayo.contiguous(), rays.contiguous(), qq.contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev)
    vmeta, vw, vb, vln, vplan, _ = pack_walk(vwalk, len(vwalk.cols), dev)
    dm_pad = round_up(dm, 16)
    wkT = torch.zeros(kpd[-1], dm_pad, dtype=torch.bfloat16, device=dev)
    wkT[:d_k_out, :dm] = wk.T.to(device=dev, dtype=torch.bfloat16)
    bkp = torch.zeros(dm_pad, dtype=torch.float32, device=dev)
    bkp[:dm] = bk.to(device=dev, dtype=torch.float32)
    C = int(vwalk.ws[-1].shape[1])
    fused = torch.empty(T, C, dtype=torch.float32, device=dev)
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    lib = build.load()
    vp = lambda a: ctypes.cast(c_ints(a), ctypes.c_void_p)
    rc = lib.papr_attend_eval(
        record.data_ptr(), rp, idx.data_ptr(), T, K, rayo.data_ptr(),
        rays.data_ptr(), qq.data_ptr(), dm, float(math.sqrt(dm)),
        vp(kmeta), kw.data_ptr(), kb.data_ptr(), kln.data_ptr(),
        kplan.data_ptr(), wkT.data_ptr(), bkp.data_ptr(), dm_pad,
        vp(vmeta), vw.data_ptr(), vb.data_ptr(), vln.data_ptr(),
        vplan.data_ptr(), int(score_act == "relu"), float(bkg_score),
        int(bool(normalize)), float(eps), fused.data_ptr(), attn.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "papr_attend_eval")
    attend_eval_idx.launches += 1
    return fused, attn


attend_eval_idx.launches = 0


def attend_stream_eval(rec, rayo, rays, qq, kwalk: Walk, wk, bk, vwalk: Walk,
                       score_act="relu", bkg_score=5.0, normalize=True,
                       eps=1e-6, cdt=torch.float32):
    """The JAX package's layout: rec (K, T, rp) gathered k-major (rec[k, t]
    is ray t's k-th point). Returns fused (T, C) fp32, attn (T, K+1) fp32."""
    K, T, rp = rec.shape
    idx = (torch.arange(K * T, dtype=torch.int32, device=rec.device)
           .reshape(K, T).T)
    return attend_eval_idx(rec.reshape(K * T, rp), idx, rayo, rays, qq,
                           kwalk, wk, bk, vwalk, score_act, bkg_score,
                           normalize, eps, cdt)
