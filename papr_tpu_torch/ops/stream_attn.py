"""Streamed attention (``papr_tpu/ops/stream_attn.py``): the one-shot eval
attention of the render path, and the training key / value streams with
their backwards (see the "training streams" section below).

Eval, ``attend_stream_eval``: from the gathered point records to (fused
features, attention) in one kernel: per (ray, k) the point-ray geometry,
the key posenc and walk, the ``w_k`` projection, the scaled dot with the
ray's query ``qq``, ``score_act`` x influence with the alive mask; the value
posenc (geometry + point features) and walk; a background-seeded online
softmax and the renormalized fuse. Forward only: rendering never
differentiates.

``attend_eval_idx`` is the wrapper of the CUDA kernel in
``csrc/attend_eval.cu``; it reads record rows by index from the (P, 128)
point record plus ``idx (T, K)`` instead of a pre-gathered (K, T, 128)
tensor. ``attend_stream_eval`` keeps the JAX package's public layout
(records gathered k-major) so the tests compare like with like.
``attend_eval_plain`` is the plain PyTorch version. A CPU tensor takes the
plain version; a CUDA tensor takes the kernel or raises.

Training: the record-native key / value streams (``key_stream_scores_rec``,
``value_stream_fuse_rec``) and the key stream with the query chain folded in
(``key_stream_scores_recq``) are below; the streams that read raw feature
tensors (``key_stream_scores``, ``value_stream_fuse``) are in
``ops/stream_feat.py``.

Int8 walks (``tpu.int8_eval`` / ``tpu.int8_train``): with ``int8=True`` the
one-shot eval attention and the two record-native training forwards run
their dense stacks as int8 x int8 -> int32 products (``walk_plain_q``, the
kernels ``attend_eval_i8`` / ``key_stream_i8_fwd`` / ``value_stream_i8_fwd``)
on a quantization calibrated by ``walk_amax`` + ``quantize_walk``: per call
on a row subsample of the call's own inputs, or once per frame
(``quant_params``, eval only). The training backwards are unchanged: they
recompute the walk in the compute dtype (a straight-through estimator) and
read the raw dots and masked scores the int8 forward saved.

Numerics follow ``_ase_fwd_kernel``: fp32 geometry and posenc; walks as in
``ops/fused_mlp.py``; ``kk`` in the compute dtype (matmul rounded, bias
added in the compute dtype) promoted to fp32; ``qq``, scores and softmax
fp32; the value output rounded to the compute dtype and back before the
fuse; an all-dead ray divides by 1 when ``normalize`` holds.

fp32 compute (``use_amp: false``): every kernel here has an fp32 form
(``attend_eval_f32``, ``key_stream_f32_fwd`` / ``_bwd``,
``value_stream_f32_fwd`` / ``_bwd``: the same kernels on the fp32 walk,
nothing rounded to bf16; ``key_stream_q_f32_fwd`` / ``_bwd``: the fp32
embedder's walk with ``w_q`` as its head, then the fp32 key stream's own
kernels, in one entry point each), and so has each
int8 forward (``attend_eval_i8_f32``, ``key_stream_i8_f32_fwd``,
``value_stream_i8_f32_fwd``: the int8 walk, then the fp32 ``w_k`` product
and the unrounded value rows, as the JAX kernels compute them with an fp32
compute dtype).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import fused_mlp as fm
from .fused_mlp import (BwdBuffers, FrameQuant, Walk, WalkQuant,
                        bwd_wgmma_buffers, c_ints, cast_c, check_pe_pairs,
                        check_walk_for_kernel, dense_c, encode_plain,
                        pack_walk, pack_walk_q, pack_walk_t, pack_walk_wgmma,
                        pack_walk_wgmma_f32, pack_walk_wgmma_q, quant_rows,
                        round_up, source_segments, walk_plain, walk_plain_q,
                        walk_relu_margin, walk_tensors, walk_with)

NEG_BIG = -1e30
REC_POS, REC_INFLU, REC_ALIVE, REC_FEATS = 0, 3, 4, 5
N_GEO = 9                      # raw sources [pos(3), proj(3), perp(3)]
# The widest value rows the fp32 value forward takes (csrc/walk_wgmma.cuh:
# its per-ray fuse rows sit beside the fp32 activations in shared memory).
F32_FWD_MAX_ROWS = 96


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


# ---------------------------------------------------- int8 calibration ----
#
# Plain tensor code on the inputs' device (the JAX package runs it as XLA
# code outside its kernels): no host synchronization, nothing enters an
# autograd graph.

INT8_CAL_ROWS = 1024       # calibration subsample row budget (across K)
# Headroom over the subsampled amax: rows outside the strided sample may
# exceed it and would clip at +-127.
INT8_CAL_HEADROOM = 1.1


def _cal_rays(T: int, K: int, rows: int, device) -> torch.Tensor:
    """The evenly strided rays a calibration samples: all K slots of
    ``max(1, min(T, rows // K))`` rays."""
    Ts = max(1, min(T, rows // max(K, 1)))
    return torch.arange(Ts, device=device) * max(1, T // Ts)


def _amax_sampled(rec, rayo, rays, walk: Walk, eps, cdt) -> list:
    """Per-column amax of each dense layer's input over the alive tokens of
    rec (K, Ts, rp) against rayo / rays (Ts, 3), times the headroom: the
    walk runs in the compute dtype, as the unquantized kernel would."""
    K, Ts, _ = rec.shape
    sel, proj, perp = _geometry_km(rec, rayo, rays, eps)
    raw = torch.cat([sel, proj, perp, rec[..., REC_FEATS:]], dim=-1)
    hs: list = []
    walk_plain(encode_plain(raw.reshape(K * Ts, -1).float(), walk.cols), walk,
               cdt, inputs=hs)
    alive = (rec[..., REC_ALIVE] > 0.5).reshape(K * Ts, 1)
    # abs / amax are exact in the compute dtype; a few hundred tiny launches
    # make a calibration host-bound, so every op saved here counts.
    return [INT8_CAL_HEADROOM
            * torch.where(alive, h, 0.0).abs().amax(dim=0).float()
            for h in hs]


@torch.no_grad()
def walk_amax(rec, rayo, rays, walk: Walk, eps=1e-6, cdt=torch.float32,
              rows=INT8_CAL_ROWS) -> list:
    """Per-layer per-column activation amax of a walk (JAX ``_walk_amax``),
    measured on an evenly strided row subsample of the inputs the kernel is
    about to run on: rec (K, T, rp) gathered k-major, rayo / rays (T, 3).
    Returns one (d_i,) fp32 row per dense layer."""
    walk_amax.calls += 1
    K, T, _ = rec.shape
    t = _cal_rays(T, K, rows, rec.device)
    return _amax_sampled(rec[:, t], rayo[t], rays[t], walk, eps, cdt)


walk_amax.calls = 0


@torch.no_grad()
def quantize_walk(ws, amaxs) -> WalkQuant:
    """Int8 weights for ``walk_plain_q`` from the ORIGINAL fp32 weights
    (JAX ``_quantize_walk``): the activation scale ``amax / 127`` folds into
    the weight rows before the per-output-channel weight scale; ``inv`` is
    ``127 / amax`` where amax > 0, else 0 (a dead column quantizes to 0)."""
    wq, inv, dq = [], [], []
    # A tensor divisor: on the card ``x / 127.0`` multiplies by a rounded
    # reciprocal, which is not JAX's division.
    c127 = torch.tensor(127.0, device=ws[0].device)
    for w, ax in zip(ws, amaxs):
        w, ax = w.float(), ax.float()
        # 127 / 0 and 0 / 0 land in the branch ``where`` drops.
        inv.append(torch.where(ax > 0, 127.0 / ax, 0.0))
        wf = w * (ax / c127)[:, None]
        sw = wf.abs().amax(dim=0) / c127
        q = torch.where(sw > 0, wf / sw, 0.0)
        wq.append(torch.clamp(torch.round(q), -127, 127).to(torch.int8))
        dq.append(sw)
    return WalkQuant(tuple(wq), tuple(inv), tuple(dq))


def calibrate_walk(rec, rayo, rays, walk: Walk, eps=1e-6,
                   cdt=torch.float32) -> WalkQuant:
    """Self-calibration of one call: ``quantize_walk`` on ``walk_amax`` of
    the call's own (K, T, rp) record and rays."""
    return quantize_walk(walk.ws, walk_amax(rec, rayo, rays, walk, eps, cdt))


@torch.no_grad()
def _calibrate_idx(record, idx, rayo, rays, walks, eps, cdt) -> tuple:
    """Self-calibration of the index form: the rows a (K, T, rp) gather
    would hold for the sampled rays, ``record[idx[t]]``."""
    T, K = idx.shape
    t = _cal_rays(T, K, INT8_CAL_ROWS, record.device)
    rec = record[idx[t].T.long()]                           # (K, Ts, rp)
    out = []
    for walk in walks:
        walk_amax.calls += 1
        out.append(quantize_walk(walk.ws, _amax_sampled(
            rec, rayo[t], rays[t], walk, eps, cdt)))
    return tuple(out)


def _run_walk_plain(enc, walk: Walk, cdt, quant: WalkQuant | None,
                    kernel_grads: bool = False):
    return (walk_plain(enc, walk, cdt, kernel_grads=kernel_grads)
            if quant is None
            else walk_plain_q(enc, walk, quant))


def attend_eval_plain(record, idx, rayo, rays, qq, kwalk: Walk, wk, bk,
                      vwalk: Walk, score_act="relu", bkg_score=5.0,
                      normalize=True, eps=1e-6, cdt=torch.float32,
                      int8=False, quant_params=None):
    """Plain PyTorch version. record (P, rp) fp32, idx (T, K) int, rayo /
    rays (T, 3) fp32, qq (T, dm) fp32 -> fused (T, C) fp32, attn (T, K+1).
    ``int8`` / ``quant_params`` as in ``attend_eval_idx``."""
    attend_eval_plain.calls += 1
    _check_score_act(score_act)
    T, K = idx.shape
    kq = vq = None
    if int8:
        kq, vq = quant_params if quant_params is not None else \
            _calibrate_idx(record, idx, rayo, rays, (kwalk, vwalk), eps, cdt)
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
        y_k = _run_walk_plain(encode_plain(raw, kwalk.cols), kwalk, cdt, kq)
        kk = (y_k.to(cdt).float() @ wk.to(cdt).float().T).to(cdt)
        kk = (kk + bk.to(cdt)).float()
        col = (qq.float() * kk).sum(-1) / math.sqrt(dm)
        sact = torch.clamp_min(col, 0.0) if score_act == "relu" else col
        alive = rec[:, REC_ALIVE] > 0.5
        scores.append(torch.where(alive, sact * rec[:, REC_INFLU], NEG_BIG))
        y_v = _run_walk_plain(encode_plain(raw, vwalk.cols), vwalk, cdt, vq)
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
                    normalize=True, eps=1e-6, cdt=torch.float32,
                    int8=False, quant_params=None):
    """One-shot eval attention from the (P, rp) record and idx (T, K): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``wk`` is the (dm, d_k_out) ``w_k`` weight (nn/mlp.py layout).

    ``int8=True`` runs both walks' dense stacks in int8 (the kernel
    ``attend_eval_i8``): with ``quant_params`` ((key WalkQuant, value
    WalkQuant), e.g. a frame's ``model.papr.eval_quant_params``) on the
    caller's quantization, without it calibrated on this call's own
    inputs. Everything outside the two dense stacks is unchanged."""
    if not record.is_cuda:
        return attend_eval_plain(record, idx, rayo, rays, qq, kwalk, wk, bk,
                                 vwalk, score_act, bkg_score, normalize, eps,
                                 cdt, int8, quant_params)
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
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    vmeta, vw, vb, vln, vplan, vpd = pack_walk(vwalk, len(vwalk.cols), dev,
                                               cdt)
    dm_pad = round_up(dm, 16)
    wkT = torch.zeros(kpd[-1], dm_pad, dtype=cdt, device=dev)
    wkT[:d_k_out, :dm] = wk.T.to(device=dev, dtype=cdt)
    bkp = torch.zeros(dm_pad, dtype=torch.float32, device=dev)
    bkp[:dm] = bk.to(device=dev, dtype=torch.float32)
    C = int(vwalk.ws[-1].shape[1])
    fused = torch.empty(T, C, dtype=torch.float32, device=dev)
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    lib = build.load()
    vp = lambda a: ctypes.cast(c_ints(a), ctypes.c_void_p)
    args = (record.data_ptr(), rp, idx.data_ptr(), T, K, rayo.data_ptr(),
            rays.data_ptr(), qq.data_ptr(), dm, float(math.sqrt(dm)),
            vp(kmeta), kw.data_ptr(), kb.data_ptr(), kln.data_ptr(),
            kplan.data_ptr(), wkT.data_ptr(), bkp.data_ptr(), dm_pad,
            vp(vmeta), vw.data_ptr(), vb.data_ptr(), vln.data_ptr(),
            vplan.data_ptr(), int(score_act == "relu"), float(bkg_score),
            int(bool(normalize)), float(eps), fused.data_ptr(),
            attn.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = cdt == torch.float32
    if int8:
        # A frame's quantization (FrameQuant) keeps the assembled image and
        # rows by compute type: the frame's other tiles only launch.
        cache = getattr(quant_params, "packs", None) or {}
        packs = cache.get(f32)
        if packs is None:
            kq, vq = quant_params if quant_params is not None else \
                _calibrate_idx(record, idx, rayo, rays, (kwalk, vwalk), eps,
                               cdt)
            # The image in stream order: the key's int8 layers, w_k in the
            # epilogue's form, the value's int8 layers.
            head = (pack_walk_wgmma_f32 if f32 else pack_walk_wgmma)([wkT],
                                                                     dev)
            kimg, vimg = (pack_walk_wgmma_q(q, pd, dev).view(torch.uint8)
                          for q, pd in ((kq, kpd), (vq, vpd)))
            wpack = torch.cat([kimg, head.view(torch.uint8), vimg])
            packs = (wpack, *quant_rows(kq, kpd, dev),
                     *quant_rows(vq, vpd, dev))
            if isinstance(quant_params, FrameQuant):
                quant_params.packs = {**cache, f32: packs}
        wpack, kinv, kdq, vinv, vdq = packs
        name = "papr_attend_eval_i8_f32" if f32 else "papr_attend_eval_i8"
        build.check(getattr(lib, name)(
            *args, kinv.data_ptr(), kdq.data_ptr(), vinv.data_ptr(),
            vdq.data_ptr(), wpack.data_ptr(), wpack.numel(), stream), name)
        if f32:
            attend_eval_i8_f32.launches += 1
        else:
            attend_eval_i8.launches += 1
    else:
        mats = _walk_mats(kw, kpd) + [wkT] + _walk_mats(vw, vpd)
        name = "papr_attend_eval_f32" if f32 else "papr_attend_eval"
        wpack = (pack_walk_wgmma_f32 if f32 else pack_walk_wgmma)(mats, dev)
        build.check(getattr(lib, name)(
            *args, wpack.data_ptr(), wpack.numel() * wpack.element_size(),
            stream), name)
        if f32:
            attend_eval_f32.launches += 1
        else:
            attend_eval_idx.launches += 1
    return fused, attn


attend_eval_idx.launches = 0


def _layer_offsets(pd):
    """(pd_in, pd_out, offset) of each layer in ``pack_walk``'s weights."""
    out, o = [], 0
    for a, b in zip(pd[:-1], pd[1:]):
        out.append((a, b, o))
        o += a * b
    return out


def _walk_mats(w, pd) -> list:
    """The input-major (pd_in, pd_out) matrices of ``pack_walk``'s weights."""
    return [w[o:o + a * b].view(a, b) for a, b, o in _layer_offsets(pd)]


def attend_eval_f32(record, idx, rayo, rays, qq, kwalk: Walk, wk, bk,
                    vwalk: Walk, score_act="relu", bkg_score=5.0,
                    normalize=True, eps=1e-6):
    """``attend_eval_idx`` on the fp32 walks (the kernel ``attend_eval_f32``
    in ``csrc/attend_eval.cu``); ``launches`` counts that kernel's
    launches."""
    return attend_eval_idx(record, idx, rayo, rays, qq, kwalk, wk, bk, vwalk,
                           score_act, bkg_score, normalize, eps,
                           torch.float32)


attend_eval_f32.launches = 0


def attend_eval_i8(*args, **kwargs):
    """``attend_eval_idx`` with both walks in int8 (the kernel
    ``attend_eval_i8`` in ``csrc/attend_eval.cu``); ``launches`` counts that
    kernel's launches."""
    return attend_eval_idx(*args, int8=True, **kwargs)


attend_eval_i8.launches = 0


def attend_eval_i8_f32(*args, **kwargs):
    """``attend_eval_idx`` with both walks in int8 beside fp32 compute (the
    kernel ``attend_eval_i8_f32``); ``launches`` counts its launches."""
    return attend_eval_idx(*args, cdt=torch.float32, int8=True, **kwargs)


attend_eval_i8_f32.launches = 0


def attend_stream_eval(rec, rayo, rays, qq, kwalk: Walk, wk, bk, vwalk: Walk,
                       score_act="relu", bkg_score=5.0, normalize=True,
                       eps=1e-6, cdt=torch.float32, int8=False,
                       quant_params=None):
    """The JAX package's layout: rec (K, T, rp) gathered k-major (rec[k, t]
    is ray t's k-th point). Returns fused (T, C) fp32, attn (T, K+1) fp32.
    ``int8`` / ``quant_params`` as in ``attend_eval_idx``."""
    K, T, rp = rec.shape
    idx = (torch.arange(K * T, dtype=torch.int32, device=rec.device)
           .reshape(K, T).T)
    return attend_eval_idx(rec.reshape(K * T, rp), idx, rayo, rays, qq,
                           kwalk, wk, bk, vwalk, score_act, bkg_score,
                           normalize, eps, cdt, int8, quant_params)


# ------------------------------------------------------- training streams ----
#
# The rec-native key and value streams of the training path
# (``key_stream_scores_rec`` / ``value_stream_fuse_rec``), forward and
# backward. The record is read pre-gathered k-major, rec (K, T, rp), as the
# JAX kernels read it: d_rec comes out as a plain (K, T, rp) tensor and
# autograd scatter-adds it into the (P, rp) point record through the gather.
# Each direction has a CUDA kernel (``csrc/key_stream.cu``,
# ``csrc/value_stream.cu``, weight gradients through ``csrc/wgrad.cu``; the
# bf16 and fp32 forms on wgmma, their weights packed per call by
# ``fwd_wgmma_pack`` / ``bwd_wgmma_pack`` and ``fwd_wgmma_pack_f32`` /
# ``bwd_wgmma_pack_f32``) and a plain version; a backward's plain version is the
# plain forward recomputed under autograd, independent of the kernels' hand
# derivation.

def _geometry_km(rec, rayo, rays, eps):
    """point_ray_geometry on (K, T, 3) selections against (T, 3) rays."""
    sel = rec[..., :3]
    v = sel - rayo
    t_al = (v * rays).sum(-1, keepdim=True)
    dd = (rays * rays).sum(-1, keepdim=True)
    proj = rays * (t_al / (dd + eps))
    return sel, proj, v - proj


def _rec_encoding(rec, rayo, rays, walk: Walk, eps, detach_pos: bool):
    """Geometry + posenc of every (k, t) token -> (K * T, d_enc) fp32.
    ``detach_pos`` detaches the position FEATURE (the key stream's reference
    detach); proj / perp keep their gradient to the positions."""
    K, T, rp = rec.shape
    sel, proj, perp = _geometry_km(rec, rayo, rays, eps)
    raw_in = torch.cat([sel.detach() if detach_pos else sel, proj, perp,
                        rec[..., REC_FEATS:]], dim=-1)
    return encode_plain(raw_in.reshape(K * T, -1), walk.cols)


def _walk_rec(rec, rayo, rays, walk: Walk, eps, cdt, detach_pos: bool,
              int8: bool = False, kernel_grads: bool = False):
    """Geometry + posenc + walk over every (k, t) token -> (K, T, d_out)
    fp32. ``int8``: the int8 walk, calibrated on these inputs;
    ``kernel_grads``: gradients at the TPU kernels' rounding points."""
    K, T, _ = rec.shape
    quant = calibrate_walk(rec, rayo, rays, walk, eps, cdt) if int8 else None
    y = _run_walk_plain(_rec_encoding(rec, rayo, rays, walk, eps, detach_pos),
                        walk, cdt, quant, kernel_grads)
    return y.reshape(K, T, -1)


@torch.no_grad()
def rec_relu_margin(rec, rayo, rays, walk: Walk, eps=1e-6) -> torch.Tensor:
    """``fused_mlp.walk_relu_margin`` of a stream's walk per ray: the
    smallest over the ray's K tokens, (T,)."""
    K, T, _ = rec.shape
    enc = _rec_encoding(rec, rayo, rays, walk, eps, False)
    return walk_relu_margin(enc, walk).reshape(K, T).amin(dim=0)


def _score_softmax(y, qq, wk, bk, influ, alive, score_act, bkg_score, cdt,
                   relu_on=None, raw_saved=None, kernel_grads=False):
    """The key streams' tail on the walk outputs y (K, T, d_out) fp32:
    ``w_k`` in the compute dtype, the scaled dot with qq (T, dm), score_act x
    influence (T, K) masked by alive (T, K) bool, and the background-token
    softmax -> attn (T, K+1), raw dots (T, K), masked scores (T, K).
    With ``raw_saved`` (T, K) the dots take a saved forward's values and keep
    this computation's gradient: what a backward that recomputes the walk
    does with the raw dots its forward saved. ``kernel_grads``: gradients
    at the TPU kernels' rounding points."""
    _check_score_act(score_act)
    dm = wk.shape[0]
    c = lambda t: cast_c(t, cdt, kernel_grads)
    kk = c(dense_c(c(y), wk.T, None, cdt, kernel_grads))
    kk = c(kk + c(bk)).float()                                # (K, T, dm)
    raw = ((qq.float()[None] * kk).sum(-1) / math.sqrt(dm)).T  # (T, K)
    if raw_saved is not None:
        # Straight-through: the saved forward's values, this walk's gradient.
        raw = raw + (raw_saved - raw).detach()
    if score_act != "relu":
        sact = raw
    elif relu_on is None:
        sact = torch.clamp_min(raw, 0.0)
    else:
        sact = raw * relu_on
    ss = torch.where(alive, sact * influ, NEG_BIG)
    m = torch.clamp_min(ss.amax(dim=1, keepdim=True), bkg_score)
    e = torch.exp(ss - m)
    eb = torch.exp(bkg_score - m)
    z = e.sum(dim=1, keepdim=True) + eb
    return torch.cat([e / z, eb / z], dim=1), raw, ss


def _key_math(rec, rayo, rays, qq, kwalk, wk, bk, score_act, bkg_score, eps,
              cdt, relu_on=None, int8=False, raw_saved=None,
              kernel_grads=False):
    y = _walk_rec(rec, rayo, rays, kwalk, eps, cdt, detach_pos=True,
                  int8=int8, kernel_grads=kernel_grads)
    return _score_softmax(y, qq, wk, bk, rec[..., REC_INFLU].T,
                          (rec[..., REC_ALIVE] > 0.5).T, score_act,
                          bkg_score, cdt, relu_on, raw_saved, kernel_grads)


def key_stream_plain(rec, rayo, rays, qq, kwalk: Walk, wk, bk,
                     score_act="relu", bkg_score=5.0, eps=1e-6,
                     cdt=torch.float32, relu_on=None, int8=False):
    """Plain PyTorch version of the key stream forward. rec (K, T, rp),
    rayo / rays (T, 3), qq (T, dm) fp32 -> attn (T, K+1), raw dots (T, K),
    masked scores ss (T, K), all fp32.

    ``relu_on`` (T, K) bool, optional: the score relu's on-pattern to apply
    instead of ``raw > 0``. Given the kernel forward's ``raw > 0``, the
    plain version computes the same piecewise-linear function as the kernel
    and its backward, which reads the saved raw: a dot near 0 whose sign
    the two bf16 forwards round differently then no longer switches a
    gradient path on in one and off in the other. ``int8``: the int8 walk,
    self-calibrated (``key_stream_fwd``)."""
    key_stream_plain.calls += 1
    return _key_math(rec, rayo, rays, qq, kwalk, wk, bk, score_act,
                     bkg_score, eps, cdt, relu_on, int8)


key_stream_plain.calls = 0


def _grads_of(fn, tensors, cotangent):
    """Gradients of fn(*leaves) against ``cotangent`` for fresh leaves made
    from ``tensors`` (zeros where a tensor does not reach the output)."""
    leaves = [t.detach().requires_grad_(True) for t in tensors]
    with torch.enable_grad():
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, cotangent, allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(grads, leaves)]


def key_stream_bwd_plain(rec, rayo, rays, qq, kwalk: Walk, wk, bk, dattn,
                         score_act="relu", bkg_score=5.0, eps=1e-6,
                         cdt=torch.float32, relu_on=None, raw_saved=None,
                         kernel_grads=False):
    """Plain version of the key stream backward -> [d_rec, d_rayo, d_rays,
    dqq, dwk, dbk, walk grads (walk_tensors order)]; ``relu_on`` as in
    ``key_stream_plain``. ``raw_saved`` (T, K): the raw dots the forward
    saved; the walk is recomputed in ``cdt`` whatever the forward ran, and
    the score and softmax backward read the saved dots (as the kernel does:
    straight-through around an int8 forward). ``kernel_grads``: at the TPU
    kernels' rounding points (``fused_mlp._DenseST``) instead of
    autograd's."""
    key_stream_bwd_plain.calls += 1
    fn = lambda r, o, d, q, w, b, *wt: _key_math(
        r, o, d, q, walk_with(kwalk, wt), w, b, score_act, bkg_score, eps,
        cdt, relu_on, raw_saved=raw_saved, kernel_grads=kernel_grads)[0]
    return _grads_of(fn, [rec, rayo, rays, qq, wk, bk] + walk_tensors(kwalk),
                     dattn)


key_stream_bwd_plain.calls = 0


def _check_rec_args(rec, rayo, rays, walks, what):
    K, T, rp = rec.shape
    for name, t in (("rec", rec), ("rayo", rayo), ("rays", rays)):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{what}: {name} must be float32 on the card")
    if tuple(rayo.shape) != (T, 3) or tuple(rays.shape) != (T, 3):
        raise ValueError(f"{what}: rayo / rays must be ({T}, 3)")
    if K > 64:
        raise NotImplementedError(f"{what}: K <= 64 (got {K})")
    need = max(c[0] for w in walks for c in w.cols) - N_GEO
    if REC_FEATS + need >= rp:
        raise ValueError(f"{what}: posenc plan reads past the record width")


def _nsrc(walk: Walk) -> int:
    return max(N_GEO, max(int(c[0]) for c in walk.cols) + 1)


def _wk_packs(wk, bk, pdn, dev, cdt=torch.bfloat16):
    """w_k as the forward's (pd_out, dm_pad) and the backward's
    (dm_pad, pd_out) input-major layouts in ``cdt``, and the padded fp32
    bias."""
    dm, d_out = wk.shape
    dm_pad = round_up(dm, 16)
    wkf = torch.zeros(pdn, dm_pad, dtype=cdt, device=dev)
    wkf[:d_out, :dm] = wk.T.to(device=dev, dtype=cdt)
    wkb = torch.zeros(dm_pad, pdn, dtype=cdt, device=dev)
    wkb[:dm, :d_out] = wk.to(device=dev, dtype=cdt)
    bkp = torch.zeros(dm_pad, dtype=torch.float32, device=dev)
    bkp[:dm] = bk.to(device=dev, dtype=torch.float32)
    return wkf, wkb, bkp, dm_pad


def fwd_wgmma_pack(w, pd, dev, head=()) -> torch.Tensor:
    """The bf16 stream forwards' weight image (``csrc/walk_wgmma.cuh``) in
    the order a k step streams it: the walk's layers (``pack_walk``'s
    ``w``), then the head (key: w_k), through ``pack_walk_wgmma``."""
    return pack_walk_wgmma(_walk_mats(w, pd) + list(head), dev)


def fwd_wgmma_pack_f32(w, pd, dev, head=()) -> torch.Tensor:
    """The fp32 stream forwards' weight image (``csrc/walk_wgmma.cuh``, the
    fp32 operand form) of the walk's layers and then the head (key: w_k),
    through ``pack_walk_wgmma_f32``: 16 KB hi / lo stages in stream order."""
    return pack_walk_wgmma_f32(_walk_mats(w, pd) + list(head), dev)


def _bwd_mats(w, wt, pd, head) -> list:
    """The backwards' matrices in the order a k step streams them: the
    forward layers (``pack_walk``'s ``w``), the head's pair (key: w_k,
    w_k^T), then W_l^T for l = n-1 .. 0 (``pack_walk_t``'s ``wt``)."""
    offs = _layer_offsets(pd)
    return (_walk_mats(w, pd) + list(head)
            + [wt[o:o + a * b].view(b, a) for a, b, o in reversed(offs)])


def bwd_wgmma_pack(w, wt, pd, dev, head=()) -> torch.Tensor:
    """The bf16 backwards' weight image (``csrc/walk_wgmma_bwd.cuh``) of
    ``_bwd_mats``, through ``pack_walk_wgmma``."""
    return pack_walk_wgmma(_bwd_mats(w, wt, pd, head), dev)


def bwd_wgmma_pack_f32(w, wt, pd, dev, head=()) -> torch.Tensor:
    """The fp32 backwards' weight image (``csrc/walk_wgmma_bwd.cuh``, the
    fp32 operand form) of ``_bwd_mats`` on the fp32 packs, through
    ``pack_walk_wgmma_f32``: 16 KB hi / lo stages, each 8-row K group
    permuted, in stream order (the kernel's chunk table is every stage in
    turn)."""
    return pack_walk_wgmma_f32(_bwd_mats(w, wt, pd, head), dev)


def key_stream_fwd(rec, rayo, rays, qq, kwalk: Walk, wk, bk,
                   score_act="relu", bkg_score=5.0, eps=1e-6,
                   cdt=torch.float32, int8=False):
    """Key stream forward -> (attn (T, K+1), raw (T, K), ss (T, K)): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``int8=True`` (``tpu.int8_train``): the walk's dense stack in int8,
    calibrated on this call's own record (the kernel
    ``key_stream_i8_fwd``); raw / ss are the int8 forward's."""
    if not rec.is_cuda:
        return key_stream_plain(rec, rayo, rays, qq, kwalk, wk, bk,
                                score_act, bkg_score, eps, cdt, int8=int8)
    from ..kernels import build

    _check_score_act(score_act)
    check_walk_for_kernel(kwalk, cdt, "key stream")
    _check_rec_args(rec, rayo, rays, (kwalk,), "key stream")
    K, T, rp = rec.shape
    dm = int(wk.shape[0])
    if tuple(qq.shape) != (T, dm) or dm > 256:
        raise ValueError(f"key stream: qq want ({T}, {dm}), d_model <= 256")
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    qq = qq.float().contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    wkf, _, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    raw = torch.empty(T, K, dtype=torch.float32, device=dev)
    ss = torch.empty(T, K, dtype=torch.float32, device=dev)
    args = (rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
            qq.data_ptr(), dm, float(math.sqrt(dm)),
            ctypes.cast(c_ints(kmeta), ctypes.c_void_p), kw.data_ptr(),
            kb.data_ptr(), kln.data_ptr(), kplan.data_ptr(), wkf.data_ptr(),
            bkp.data_ptr(), dm_pad, int(score_act == "relu"),
            float(bkg_score), float(eps), attn.data_ptr(), raw.data_ptr(),
            ss.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()
    f32 = cdt == torch.float32
    if int8:
        qp = pack_walk_q(calibrate_walk(rec, rayo, rays, kwalk, eps, cdt),
                         kpd, dev)
        name = ("papr_key_stream_i8_f32_fwd" if f32
                else "papr_key_stream_i8_fwd")
        build.check(getattr(lib, name)(*args, *(t.data_ptr() for t in qp),
                                       stream), name)
        if f32:
            key_stream_i8_f32_fwd.launches += 1
        else:
            key_stream_i8_fwd.launches += 1
    else:
        wpack = (fwd_wgmma_pack_f32 if f32 else fwd_wgmma_pack)(
            kw, kpd, dev, (wkf,))
        name = "papr_key_stream_f32_fwd" if f32 else "papr_key_stream_fwd"
        build.check(getattr(lib, name)(
            *args, wpack.data_ptr(), wpack.numel() * wpack.element_size(),
            fm.wgmma_grid(T), stream), name)
        if f32:
            key_stream_f32_fwd.launches += 1
        else:
            key_stream_fwd.launches += 1
    return attn, raw, ss


key_stream_fwd.launches = 0


def key_stream_f32_fwd(rec, rayo, rays, qq, kwalk: Walk, wk, bk,
                       score_act="relu", bkg_score=5.0, eps=1e-6):
    """``key_stream_fwd`` on the fp32 walk (the kernel
    ``key_stream_f32_fwd`` in ``csrc/key_stream.cu``); ``launches`` counts
    that kernel's launches."""
    return key_stream_fwd(rec, rayo, rays, qq, kwalk, wk, bk, score_act,
                          bkg_score, eps, torch.float32)


key_stream_f32_fwd.launches = 0


def key_stream_i8_fwd(*args, **kwargs):
    """``key_stream_fwd`` with the walk in int8 (the kernel
    ``key_stream_i8_fwd`` in ``csrc/key_stream.cu``); ``launches`` counts
    that kernel's launches."""
    return key_stream_fwd(*args, int8=True, **kwargs)


key_stream_i8_fwd.launches = 0


def key_stream_i8_f32_fwd(*args, **kwargs):
    """``key_stream_fwd`` with the walk in int8 beside fp32 compute (the
    kernel ``key_stream_i8_f32_fwd``); ``launches`` counts its launches."""
    return key_stream_fwd(*args, cdt=torch.float32, int8=True, **kwargs)


key_stream_i8_f32_fwd.launches = 0


def key_stream_bwd(rec, rayo, rays, qq, kwalk: Walk, wk, bk, raw, ss, dattn,
                   score_act="relu", bkg_score=5.0, eps=1e-6,
                   cdt=torch.float32):
    """Key stream backward -> [d_rec (K, T, rp), d_rayo, d_rays (T, 3),
    dqq (T, dm), dwk, dbk, walk grads]: the CUDA kernels for CUDA tensors
    (raw / ss saved by the forward), the plain version for CPU tensors."""
    if not rec.is_cuda:
        return key_stream_bwd_plain(rec, rayo, rays, qq, kwalk, wk, bk,
                                    dattn, score_act, bkg_score, eps, cdt,
                                    raw_saved=raw)
    what = "key stream backward"
    _check_score_act(score_act)
    check_walk_for_kernel(kwalk, cdt, what)
    _check_rec_args(rec, rayo, rays, (kwalk,), what)
    out = _key_bwd_launch(rec, rayo, rays, qq, kwalk, wk, bk, raw, ss, dattn,
                          score_act, bkg_score, eps, cdt, what)
    if cdt == torch.float32:
        key_stream_f32_bwd.launches += 1
    else:
        key_stream_bwd.launches += 1
    return out


def _key_bwd_launch(rec, rayo, rays, qq, kwalk: Walk, wk, bk, raw, ss, dattn,
                    score_act, bkg_score, eps, cdt, what):
    """``key_stream_bwd``'s launch on checked CUDA arguments (its entry
    point, then the dW reduction), counted by the caller: the key stream
    backward's and the fp32 folded key stream backward's key half."""
    from ..kernels import build

    K, T, rp = rec.shape
    dm = int(wk.shape[0])
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    qq = qq.float().contiguous()
    raw, ss = raw.contiguous(), ss.contiguous()
    dattn = dattn.float().contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    kwt = pack_walk_t(kwalk, kpd, dev, cdt)
    wkf, wkb, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    nsrc = _nsrc(kwalk)
    seg = source_segments(kwalk.cols, nsrc, dev)
    f32 = cdt == torch.float32
    check_pe_pairs(kwalk, what)
    buf = bwd_wgmma_buffers(kwalk, kpd, K, T, dev, head=(kpd[-1], dm_pad),
                            extra=dm_pad, cdt=cdt)
    wpack = (bwd_wgmma_pack_f32 if f32 else bwd_wgmma_pack)(
        kw, kwt, kpd, dev, (wkf, wkb))
    aux = [torch.zeros(T, w, dtype=torch.float32, device=dev)
           for w in (dm, 3, 3)]
    tail = (wpack.data_ptr(), wpack.numel() * wpack.element_size(),
            fm.wgmma_grid(T), *(a.data_ptr() for a in aux))
    drec = torch.zeros(K, T, rp, dtype=torch.float32, device=dev)
    drayo = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    drays = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    dqq = torch.zeros(T, dm, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "papr_key_stream_f32_bwd" if f32 else "papr_key_stream_bwd"
    rc = getattr(lib, name)(
        rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
        qq.data_ptr(), dm, float(math.sqrt(dm)), raw.data_ptr(),
        ss.data_ptr(), dattn.data_ptr(),
        ctypes.cast(c_ints(kmeta), ctypes.c_void_p), kw.data_ptr(),
        kb.data_ptr(), kln.data_ptr(), kplan.data_ptr(), bkp.data_ptr(),
        dm_pad, int(score_act == "relu"), float(bkg_score), float(eps),
        buf.stash.data_ptr(), ctypes.cast(buf.off_arg, ctypes.c_void_p),
        seg.data_ptr(), nsrc, drec.data_ptr(), drayo.data_ptr(),
        drays.data_ptr(), dqq.data_ptr(), buf.part.data_ptr(), buf.part_w,
        buf.scratch.data_ptr(), *tail, stream)
    build.check(rc, name)
    dws, psum = buf.reduce(lib, stream)
    d_out = int(wk.shape[1])
    dwk = dws[-1][:d_out, :dm].T
    dbk = psum[buf.extra_off:buf.extra_off + dm]
    return ([drec, drayo, drays, dqq, dwk, dbk]
            + buf.walk_grads(kwalk, dws, psum))


key_stream_bwd.launches = 0


def key_stream_f32_bwd(rec, rayo, rays, qq, kwalk: Walk, wk, bk, raw, ss,
                       dattn, score_act="relu", bkg_score=5.0, eps=1e-6):
    """``key_stream_bwd`` on the fp32 walk (the kernel
    ``key_stream_f32_bwd``); ``launches`` counts that kernel's launches."""
    return key_stream_bwd(rec, rayo, rays, qq, kwalk, wk, bk, raw, ss, dattn,
                          score_act, bkg_score, eps, torch.float32)


key_stream_f32_bwd.launches = 0


class KeyStream(torch.autograd.Function):
    """``key_stream_scores_rec`` with its backward; saves raw / ss from the
    forward for the softmax backward, as the JAX kernel does. ``opts`` is
    (walk, score_act, bkg_score, eps, cdt, int8); the backward takes no
    ``int8``."""

    @staticmethod
    def forward(ctx, opts, rec, rayo, rays, qq, wk, bk, *tensors):
        kwalk = walk_with(opts[0], tensors)
        attn, raw, ss = key_stream_fwd(rec, rayo, rays, qq, kwalk, wk, bk,
                                       *opts[1:])
        ctx.opts = opts
        ctx.save_for_backward(rec, rayo, rays, qq, wk, bk, raw, ss, *tensors)
        return attn

    @staticmethod
    def backward(ctx, dattn):
        rec, rayo, rays, qq, wk, bk, raw, ss, *tensors = ctx.saved_tensors
        kwalk = walk_with(ctx.opts[0], tensors)
        return (None, *key_stream_bwd(rec, rayo, rays, qq, kwalk, wk, bk, raw,
                                      ss, dattn, *ctx.opts[1:5]))


def key_stream_scores_rec(rec, rayo, rays, qq, kwalk: Walk, wk, bk,
                          score_act="relu", bkg_score=5.0, eps=1e-6,
                          cdt=torch.float32, int8=False):
    """Differentiable rec-native key stream (JAX ``key_stream_scores_rec``):
    rec (K, T, rp) gathered k-major, rayo / rays (T, 3) (rays normalized),
    qq (T, dm) -> attn (T, K+1) fp32, background token last. ``int8``: the
    forward walk in int8, the backward unchanged (straight-through)."""
    return KeyStream.apply((kwalk, score_act, float(bkg_score), float(eps),
                            cdt, bool(int8)), rec, rayo, rays, qq, wk, bk,
                           *walk_tensors(kwalk))


def _value_math(rec, rayo, rays, attn, vwalk, normalize, eps, cdt,
                int8=False, kernel_grads=False):
    K = rec.shape[0]
    y = _walk_rec(rec, rayo, rays, vwalk, eps, cdt, detach_pos=False,
                  int8=int8, kernel_grads=kernel_grads)
    y = cast_c(y, cdt, kernel_grads).float()                  # (K, T, C)
    w = attn[:, :K]
    if normalize:
        s = w.sum(dim=1, keepdim=True)
        w = w / torch.where(s > 0, s, torch.ones_like(s))
    return (w.T[..., None] * y).sum(0)


def value_stream_plain(rec, rayo, rays, attn, vwalk: Walk, normalize=True,
                       eps=1e-6, cdt=torch.float32, int8=False):
    """Plain PyTorch version of the value stream forward: rec (K, T, rp),
    attn (T, K+1) -> fused (T, C) fp32. ``int8``: the int8 walk,
    self-calibrated (``value_stream_fwd``)."""
    value_stream_plain.calls += 1
    return _value_math(rec, rayo, rays, attn, vwalk, normalize, eps, cdt,
                       int8)


value_stream_plain.calls = 0


def value_stream_bwd_plain(rec, rayo, rays, attn, vwalk: Walk, dfused,
                           normalize=True, eps=1e-6, cdt=torch.float32,
                           kernel_grads=False):
    """Plain version of the value stream backward -> [d_rec, d_rayo,
    d_rays, d_attn, walk grads]; ``kernel_grads`` as in
    ``key_stream_bwd_plain``."""
    value_stream_bwd_plain.calls += 1
    fn = lambda r, o, d, a, *wt: _value_math(
        r, o, d, a, walk_with(vwalk, wt), normalize, eps, cdt,
        kernel_grads=kernel_grads)
    return _grads_of(fn, [rec, rayo, rays, attn] + walk_tensors(vwalk),
                     dfused)


value_stream_bwd_plain.calls = 0


def value_stream_fwd(rec, rayo, rays, attn, vwalk: Walk, normalize=True,
                     eps=1e-6, cdt=torch.float32, int8=False):
    """Value stream forward -> fused (T, C) fp32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. ``int8=True``
    (``tpu.int8_train``): the walk's dense stack in int8, calibrated on this
    call's own record (the kernel ``value_stream_i8_fwd``)."""
    if not rec.is_cuda:
        return value_stream_plain(rec, rayo, rays, attn, vwalk, normalize,
                                  eps, cdt, int8)
    from ..kernels import build

    check_walk_for_kernel(vwalk, cdt, "value stream")
    _check_rec_args(rec, rayo, rays, (vwalk,), "value stream")
    K, T, rp = rec.shape
    if tuple(attn.shape) != (T, K + 1):
        raise ValueError(f"value stream: attn want ({T}, {K + 1})")
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    attn = attn.float().contiguous()
    vmeta, vw, vb, vln, vplan, vpd = pack_walk(vwalk, len(vwalk.cols), dev,
                                               cdt)
    f32 = cdt == torch.float32
    if f32 and not int8 and vpd[-1] > F32_FWD_MAX_ROWS:
        raise NotImplementedError(
            f"value stream: value rows of {vpd[-1]} > {F32_FWD_MAX_ROWS} "
            "(the fp32 forward keeps its fuse rows beside the fp32 "
            "activations in shared memory)")
    # The wgmma kernels add each block's per-ray sums into a zeroed output.
    fused = (torch.empty if int8 else torch.zeros)(
        T, int(vwalk.ws[-1].shape[1]), dtype=torch.float32, device=dev)
    args = (rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
            attn.data_ptr(), ctypes.cast(c_ints(vmeta), ctypes.c_void_p),
            vw.data_ptr(), vb.data_ptr(), vln.data_ptr(), vplan.data_ptr(),
            int(bool(normalize)), float(eps), fused.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()
    if int8:
        qp = pack_walk_q(calibrate_walk(rec, rayo, rays, vwalk, eps, cdt),
                         vpd, dev)
        name = ("papr_value_stream_i8_f32_fwd" if f32
                else "papr_value_stream_i8_fwd")
        build.check(getattr(lib, name)(*args, *(t.data_ptr() for t in qp),
                                       stream), name)
        if f32:
            value_stream_i8_f32_fwd.launches += 1
        else:
            value_stream_i8_fwd.launches += 1
    else:
        wpack = (fwd_wgmma_pack_f32 if f32 else fwd_wgmma_pack)(vw, vpd, dev)
        name = ("papr_value_stream_f32_fwd" if f32
                else "papr_value_stream_fwd")
        build.check(getattr(lib, name)(
            *args, wpack.data_ptr(), wpack.numel() * wpack.element_size(),
            fm.wgmma_grid(T), stream), name)
        if f32:
            value_stream_f32_fwd.launches += 1
        else:
            value_stream_fwd.launches += 1
    return fused


value_stream_fwd.launches = 0


def value_stream_f32_fwd(rec, rayo, rays, attn, vwalk: Walk, normalize=True,
                         eps=1e-6):
    """``value_stream_fwd`` on the fp32 walk (the kernel
    ``value_stream_f32_fwd`` in ``csrc/value_stream.cu``); ``launches``
    counts that kernel's launches."""
    return value_stream_fwd(rec, rayo, rays, attn, vwalk, normalize, eps,
                            torch.float32)


value_stream_f32_fwd.launches = 0


def value_stream_i8_fwd(*args, **kwargs):
    """``value_stream_fwd`` with the walk in int8 (the kernel
    ``value_stream_i8_fwd`` in ``csrc/value_stream.cu``); ``launches``
    counts that kernel's launches."""
    return value_stream_fwd(*args, int8=True, **kwargs)


value_stream_i8_fwd.launches = 0


def value_stream_i8_f32_fwd(*args, **kwargs):
    """``value_stream_fwd`` with the walk in int8 beside fp32 compute (the
    kernel ``value_stream_i8_f32_fwd``); ``launches`` counts its launches."""
    return value_stream_fwd(*args, cdt=torch.float32, int8=True, **kwargs)


value_stream_i8_f32_fwd.launches = 0


def value_stream_bwd(rec, rayo, rays, attn, vwalk: Walk, dfused,
                     normalize=True, eps=1e-6, cdt=torch.float32):
    """Value stream backward -> [d_rec (K, T, rp), d_rayo, d_rays (T, 3),
    d_attn (T, K+1), walk grads]: the CUDA kernels for CUDA tensors, the
    plain version for CPU tensors."""
    if not rec.is_cuda:
        return value_stream_bwd_plain(rec, rayo, rays, attn, vwalk, dfused,
                                      normalize, eps, cdt)
    from ..kernels import build

    check_walk_for_kernel(vwalk, cdt, "value stream backward")
    _check_rec_args(rec, rayo, rays, (vwalk,), "value stream backward")
    K, T, rp = rec.shape
    C = int(vwalk.ws[-1].shape[1])
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    attn = attn.float().contiguous()
    dfused = dfused.float().contiguous()
    if tuple(dfused.shape) != (T, C):
        raise ValueError(f"value stream backward: dfused want ({T}, {C})")
    vmeta, vw, vb, vln, vplan, vpd = pack_walk(vwalk, len(vwalk.cols), dev,
                                               cdt)
    vwt = pack_walk_t(vwalk, vpd, dev, cdt)
    nsrc = _nsrc(vwalk)
    seg = source_segments(vwalk.cols, nsrc, dev)
    f32 = cdt == torch.float32
    check_pe_pairs(vwalk, "value stream backward")
    if vpd[-1] > 128:
        raise NotImplementedError(
            f"value stream backward: value rows of {vpd[-1]} > 128 (one "
            "wgmma pass of the bf16 form; the fp32 form takes the same)")
    buf = bwd_wgmma_buffers(vwalk, vpd, K, T, dev, cdt=cdt)
    wpack = (bwd_wgmma_pack_f32 if f32 else bwd_wgmma_pack)(vw, vwt, vpd, dev)
    aux = [torch.empty(T, K, dtype=torch.float32, device=dev)] + [
        torch.zeros(T, 3, dtype=torch.float32, device=dev) for _ in range(2)]
    tail = (wpack.data_ptr(), wpack.numel() * wpack.element_size(),
            fm.wgmma_grid(T), *(a.data_ptr() for a in aux))
    drec = torch.zeros(K, T, rp, dtype=torch.float32, device=dev)
    drayo = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    drays = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    dattn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "papr_value_stream_f32_bwd" if f32 else "papr_value_stream_bwd"
    rc = getattr(lib, name)(
        rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
        attn.data_ptr(), dfused.data_ptr(),
        ctypes.cast(c_ints(vmeta), ctypes.c_void_p), vw.data_ptr(),
        vb.data_ptr(), vln.data_ptr(), vplan.data_ptr(),
        int(bool(normalize)), float(eps), buf.stash.data_ptr(),
        ctypes.cast(buf.off_arg, ctypes.c_void_p), seg.data_ptr(), nsrc,
        drec.data_ptr(), drayo.data_ptr(), drays.data_ptr(),
        dattn.data_ptr(), buf.part.data_ptr(), buf.part_w,
        buf.scratch.data_ptr(), *tail, stream)
    build.check(rc, name)
    dws, psum = buf.reduce(lib, stream)
    if f32:
        value_stream_f32_bwd.launches += 1
    else:
        value_stream_bwd.launches += 1
    return [drec, drayo, drays, dattn] + buf.walk_grads(vwalk, dws, psum)


value_stream_bwd.launches = 0


def value_stream_f32_bwd(rec, rayo, rays, attn, vwalk: Walk, dfused,
                         normalize=True, eps=1e-6):
    """``value_stream_bwd`` on the fp32 walk (the kernel
    ``value_stream_f32_bwd``); ``launches`` counts that kernel's
    launches."""
    return value_stream_bwd(rec, rayo, rays, attn, vwalk, dfused, normalize,
                            eps, torch.float32)


value_stream_f32_bwd.launches = 0


class ValueStream(torch.autograd.Function):
    """``value_stream_fuse_rec`` with its backward. ``opts`` is (walk,
    normalize, eps, cdt, int8); the backward takes no ``int8``."""

    @staticmethod
    def forward(ctx, opts, rec, rayo, rays, attn, *tensors):
        ctx.opts = opts
        ctx.save_for_backward(rec, rayo, rays, attn, *tensors)
        return value_stream_fwd(rec, rayo, rays, attn,
                                walk_with(opts[0], tensors), *opts[1:])

    @staticmethod
    def backward(ctx, dfused):
        rec, rayo, rays, attn, *tensors = ctx.saved_tensors
        vwalk = walk_with(ctx.opts[0], tensors)
        return (None, *value_stream_bwd(rec, rayo, rays, attn, vwalk, dfused,
                                        *ctx.opts[1:4]))


def value_stream_fuse_rec(rec, rayo, rays, attn, vwalk: Walk, normalize=True,
                          eps=1e-6, cdt=torch.float32, int8=False):
    """Differentiable rec-native value stream (JAX ``value_stream_fuse_rec``):
    rec (K, T, rp), attn (T, K+1) -> fused (T, C) fp32. ``int8``: the
    forward walk in int8, the backward unchanged (straight-through)."""
    return ValueStream.apply((vwalk, bool(normalize), float(eps), cdt,
                              bool(int8)), rec, rayo, rays, attn,
                             *walk_tensors(vwalk))


# ------------------------------------------------- query-folded key stream ----
#
# ``key_stream_scores_recq``: the record-native key stream with the query
# chain (posenc of the RAW ray direction -> query embedder -> ``w_q``) folded
# in (``csrc/key_stream_q.cu``; bf16: inside one WMMA kernel; fp32: the query
# chain on the fp32 embedder's wgmma walk with ``w_q`` as its head and the
# fp32 key stream's kernels: forward, one entry point; backward, the key
# stream's fp32 entry point, then the query's). The forward also returns qq
# (T, dm) as a residual; the backward sums dqq over k and runs the query
# backward once per ray, giving dW_q / db_q, the query stack's gradients and
# d_rayd.

def _query_math(rayd, qwalk, wq, bq, cdt):
    """posenc -> query walk -> ``w_q`` in the compute dtype (nn/mlp.py
    linear_apply: product rounded, bias added in the compute dtype)."""
    eq = walk_plain(encode_plain(rayd, qwalk.cols), qwalk, cdt)
    qq = (eq.to(cdt).float() @ wq.to(cdt).float().T).to(cdt)
    return (qq + bq.to(cdt)).float()


def key_stream_q_plain(rec, rayo, rays, rayd, kwalk: Walk, wk, bk,
                       qwalk: Walk, wq, bq, score_act="relu", bkg_score=5.0,
                       eps=1e-6, cdt=torch.float32, relu_on=None):
    """Plain PyTorch version of the query-folded key stream forward ->
    attn (T, K+1), raw (T, K), ss (T, K), qq (T, dm), all fp32; ``relu_on``
    as in ``key_stream_plain``."""
    key_stream_q_plain.calls += 1
    qq = _query_math(rayd, qwalk, wq, bq, cdt)
    return (*_key_math(rec, rayo, rays, qq, kwalk, wk, bk, score_act,
                       bkg_score, eps, cdt, relu_on), qq)


key_stream_q_plain.calls = 0


def key_stream_q_bwd_plain(rec, rayo, rays, rayd, kwalk: Walk, wk, bk,
                           qwalk: Walk, wq, bq, dattn, score_act="relu",
                           bkg_score=5.0, eps=1e-6, cdt=torch.float32,
                           relu_on=None, raw_saved=None):
    """Plain version of the query-folded backward -> [d_rec, d_rayo, d_rays,
    d_rayd, dwk, dbk, dwq, dbq, key walk grads, query walk grads];
    ``relu_on`` and ``raw_saved`` (the raw dots the forward saved, which
    the score and softmax backward read) as in ``key_stream_bwd_plain``."""
    key_stream_q_bwd_plain.calls += 1
    nk = len(walk_tensors(kwalk))

    def fn(r, o, d, rd, w, b, w2, b2, *wt):
        qq = _query_math(rd, walk_with(qwalk, wt[nk:]), w2, b2, cdt)
        return _key_math(r, o, d, qq, walk_with(kwalk, wt[:nk]), w, b,
                         score_act, bkg_score, eps, cdt, relu_on,
                         raw_saved=raw_saved)[0]

    return _grads_of(fn, [rec, rayo, rays, rayd, wk, bk, wq, bq]
                     + walk_tensors(kwalk) + walk_tensors(qwalk), dattn)


key_stream_q_bwd_plain.calls = 0


def _check_query_args(rayd, qwalk, wk, wq, T, cdt, what):
    check_walk_for_kernel(qwalk, cdt, f"{what} query walk")
    if tuple(rayd.shape) != (T, 3) or rayd.dtype != torch.float32 \
            or not rayd.is_cuda:
        raise ValueError(f"{what}: rayd must be ({T}, 3) float32 on the card")
    if max(c[0] for c in qwalk.cols) >= 3:
        raise ValueError(f"{what}: the query posenc reads past the ray "
                         "direction")
    dm = int(wk.shape[0])
    if tuple(wq.shape) != (dm, int(qwalk.ws[-1].shape[1])) or dm > 256:
        raise ValueError(f"{what}: w_q {tuple(wq.shape)} against d_model "
                         f"{dm} (<= 256)")


def key_stream_q_fwd(rec, rayo, rays, rayd, kwalk: Walk, wk, bk, qwalk: Walk,
                     wq, bq, score_act="relu", bkg_score=5.0, eps=1e-6,
                     cdt=torch.float32):
    """Query-folded key stream forward -> (attn, raw, ss, qq): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not rec.is_cuda:
        return key_stream_q_plain(rec, rayo, rays, rayd, kwalk, wk, bk,
                                  qwalk, wq, bq, score_act, bkg_score, eps,
                                  cdt)
    from ..kernels import build

    what = "query-folded key stream"
    _check_score_act(score_act)
    check_walk_for_kernel(kwalk, cdt, what)
    _check_rec_args(rec, rayo, rays, (kwalk,), what)
    K, T, rp = rec.shape
    _check_query_args(rayd, qwalk, wk, wq, T, cdt, what)
    dm = int(wk.shape[0])
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    rayd = rayd.contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    qmeta, qw, qb, qln, qplan, qpd = pack_walk(qwalk, len(qwalk.cols), dev,
                                               cdt)
    wkf, _, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    wqf, _, bqp, _ = _wk_packs(wq, bq, qpd[-1], dev, cdt)
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    raw = torch.empty(T, K, dtype=torch.float32, device=dev)
    ss = torch.empty(T, K, dtype=torch.float32, device=dev)
    qq = torch.empty(T, dm, dtype=torch.float32, device=dev)
    vp = lambda a: ctypes.cast(c_ints(a), ctypes.c_void_p)
    f32 = cdt == torch.float32
    # The fp32 form reads w_k and w_q from its images.
    wk_arg = () if f32 else (wkf.data_ptr(),)
    wq_arg = () if f32 else (wqf.data_ptr(),)
    args = (rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
            rayd.data_ptr(), dm, float(math.sqrt(dm)),
            vp(kmeta), kw.data_ptr(), kb.data_ptr(), kln.data_ptr(),
            kplan.data_ptr(), *wk_arg, bkp.data_ptr(),
            vp(qmeta), qw.data_ptr(), qb.data_ptr(), qln.data_ptr(),
            qplan.data_ptr(), *wq_arg, bqp.data_ptr(), dm_pad,
            int(score_act == "relu"), float(bkg_score), float(eps),
            attn.data_ptr(), raw.data_ptr(), ss.data_ptr(), qq.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = build.load()
    if f32:
        # The query walk then w_q, and the key walk then w_k, as the fp32
        # wgmma forwards stream them.
        kimg = fwd_wgmma_pack_f32(kw, kpd, dev, (wkf,))
        qimg = fwd_wgmma_pack_f32(qw, qpd, dev, (wqf,))
        name = "papr_key_stream_q_f32_fwd"
        build.check(getattr(lib, name)(
            *args, kimg.data_ptr(), kimg.numel() * kimg.element_size(),
            qimg.data_ptr(), qimg.numel() * qimg.element_size(),
            fm.wgmma_grid(T), stream), name)
        key_stream_q_f32_fwd.launches += 1
    else:
        name = "papr_key_stream_q_fwd"
        build.check(getattr(lib, name)(*args, stream), name)
        key_stream_q_fwd.launches += 1
    return attn, raw, ss, qq


key_stream_q_fwd.launches = 0


def key_stream_q_f32_fwd(*args, **kwargs):
    """``key_stream_q_fwd`` on the fp32 walks (the kernel
    ``key_stream_q_f32_fwd`` in ``csrc/key_stream_q.cu``); ``launches``
    counts that kernel's launches."""
    return key_stream_q_fwd(*args, cdt=torch.float32, **kwargs)


key_stream_q_f32_fwd.launches = 0


def key_stream_q_bwd(rec, rayo, rays, rayd, kwalk: Walk, wk, bk, qwalk: Walk,
                     wq, bq, qq, raw, ss, dattn, score_act="relu",
                     bkg_score=5.0, eps=1e-6, cdt=torch.float32):
    """Query-folded key stream backward -> [d_rec (K, T, rp), d_rayo, d_rays,
    d_rayd (T, 3), dwk, dbk, dwq, dbq, key walk grads, query walk grads]: the
    CUDA kernels for CUDA tensors (qq / raw / ss saved by the forward), the
    plain version for CPU tensors."""
    if not rec.is_cuda:
        return key_stream_q_bwd_plain(rec, rayo, rays, rayd, kwalk, wk, bk,
                                      qwalk, wq, bq, dattn, score_act,
                                      bkg_score, eps, cdt)
    from ..kernels import build

    what = "query-folded key stream backward"
    _check_score_act(score_act)
    check_walk_for_kernel(kwalk, cdt, what)
    _check_rec_args(rec, rayo, rays, (kwalk,), what)
    K, T, rp = rec.shape
    _check_query_args(rayd, qwalk, wk, wq, T, cdt, what)
    if cdt == torch.float32:
        return _key_stream_q_f32_bwd(rec, rayo, rays, rayd, kwalk, wk, bk,
                                     qwalk, wq, bq, qq, raw, ss, dattn,
                                     score_act, bkg_score, eps, what)
    dm = int(wk.shape[0])
    dev = rec.device
    rec, rayo, rays = rec.contiguous(), rayo.contiguous(), rays.contiguous()
    rayd, qq = rayd.contiguous(), qq.float().contiguous()
    raw, ss = raw.contiguous(), ss.contiguous()
    dattn = dattn.float().contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    qmeta, qw, qb, qln, qplan, qpd = pack_walk(qwalk, len(qwalk.cols), dev,
                                               cdt)
    kwt = pack_walk_t(kwalk, kpd, dev, cdt)
    qwt = pack_walk_t(qwalk, qpd, dev, cdt)
    wkf, wkb, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    _, wqb, _, _ = _wk_packs(wq, bq, qpd[-1], dev, cdt)
    nsrc = _nsrc(kwalk)
    seg = source_segments(kwalk.cols, nsrc, dev)
    qseg = source_segments(qwalk.cols, 3, dev)
    nblk = -(-T // 64)
    # Two walks' buffers: the key stashes hold K * T rows, the query's T.
    kbuf = BwdBuffers(kpd, K * nblk * 64, nblk, dev, head=(kpd[-1], dm_pad),
                      extra=dm_pad, cdt=cdt)
    qbuf = BwdBuffers(qpd, nblk * 64, nblk, dev, head=(qpd[-1], dm_pad),
                      extra=dm_pad, cdt=cdt)
    drec = torch.zeros(K, T, rp, dtype=torch.float32, device=dev)
    drayo = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    drays = torch.zeros(T, 3, dtype=torch.float32, device=dev)
    drayd = torch.empty(T, 3, dtype=torch.float32, device=dev)
    dqq = torch.zeros(T, dm, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vp = lambda a: ctypes.cast(a, ctypes.c_void_p)
    name = "papr_key_stream_q_bwd"
    build.check(getattr(lib, name)(
        rec.data_ptr(), rp, T, K, rayo.data_ptr(), rays.data_ptr(),
        rayd.data_ptr(), qq.data_ptr(), dm, float(math.sqrt(dm)),
        raw.data_ptr(), ss.data_ptr(), dattn.data_ptr(),
        vp(c_ints(kmeta)), kw.data_ptr(), kb.data_ptr(), kln.data_ptr(),
        kplan.data_ptr(), kwt.data_ptr(), wkf.data_ptr(), wkb.data_ptr(),
        bkp.data_ptr(),
        vp(c_ints(qmeta)), qw.data_ptr(), qb.data_ptr(), qln.data_ptr(),
        qplan.data_ptr(), qwt.data_ptr(), wqb.data_ptr(), dm_pad,
        int(score_act == "relu"), float(bkg_score), float(eps),
        kbuf.stash.data_ptr(), vp(kbuf.off_arg), qbuf.stash.data_ptr(),
        vp(qbuf.off_arg), seg.data_ptr(), nsrc, qseg.data_ptr(),
        drec.data_ptr(), drayo.data_ptr(), drays.data_ptr(),
        drayd.data_ptr(), dqq.data_ptr(), kbuf.part.data_ptr(), kbuf.part_w,
        kbuf.scratch.data_ptr(), qbuf.part.data_ptr(), qbuf.part_w,
        qbuf.scratch.data_ptr(), stream), name)
    kdws, kpsum = kbuf.reduce(lib, stream)
    qdws, qpsum = qbuf.reduce(lib, stream)
    key_stream_q_bwd.launches += 1
    d_k, d_q = int(wk.shape[1]), int(wq.shape[1])
    return ([drec, drayo, drays, drayd,
             kdws[-1][:d_k, :dm].T, kpsum[kbuf.extra_off:kbuf.extra_off + dm],
             qdws[-1][:d_q, :dm].T, qpsum[qbuf.extra_off:qbuf.extra_off + dm]]
            + kbuf.walk_grads(kwalk, kdws, kpsum)
            + qbuf.walk_grads(qwalk, qdws, qpsum))


def _key_stream_q_f32_bwd(rec, rayo, rays, rayd, kwalk: Walk, wk, bk,
                          qwalk: Walk, wq, bq, qq, raw, ss, dattn, score_act,
                          bkg_score, eps, what):
    """The fp32 folded backward on the wgmma walks: the key's half is
    ``key_stream_bwd``'s launch (row 5f: d_rec, d_rayo, d_rays, dqq summed
    over k, dW_k / db_k, the key walk's gradients), then the query's,
    ``papr_key_stream_q_f32_bwd`` (dqq through w_q and the query walk to
    d_rayd, the stashes for dW_q and the walk's dW), then its dW
    reduction."""
    from ..kernels import build

    f32 = torch.float32
    T, dm = int(rec.shape[1]), int(wk.shape[0])
    dev = rec.device
    check_pe_pairs(qwalk, f"{what} query walk")
    qmeta, qw, qb, qln, qplan, qpd = pack_walk(qwalk, len(qwalk.cols), dev,
                                               f32)
    qwt = pack_walk_t(qwalk, qpd, dev, f32)
    _, wqb, _, dm_pad = _wk_packs(wq, bq, qpd[-1], dev, f32)
    qseg = source_segments(qwalk.cols, 3, dev)
    # The query's stash over T rows with w_q; its image: the walk, w_q^T
    # (dqq's way into the reverse walk), W_l^T for l = n-1 .. 0.
    qbuf = bwd_wgmma_buffers(qwalk, qpd, 1, T, dev, head=(qpd[-1], dm_pad),
                             extra=dm_pad, cdt=f32)
    qimg = bwd_wgmma_pack_f32(qw, qwt, qpd, dev, (wqb,))
    rayd = rayd.contiguous()
    drayd = torch.empty(T, 3, dtype=torch.float32, device=dev)
    key = _key_bwd_launch(rec, rayo, rays, qq, kwalk, wk, bk, raw, ss, dattn,
                          score_act, bkg_score, eps, f32, what)
    drec, drayo, drays, dqq, dwk, dbk = key[:6]
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    name = "papr_key_stream_q_f32_bwd"
    build.check(getattr(lib, name)(
        rayd.data_ptr(), T, dm, ctypes.cast(c_ints(qmeta), ctypes.c_void_p),
        qw.data_ptr(), qb.data_ptr(), qln.data_ptr(), qplan.data_ptr(),
        dm_pad, qbuf.stash.data_ptr(),
        ctypes.cast(qbuf.off_arg, ctypes.c_void_p), qseg.data_ptr(),
        dqq.data_ptr(), drayd.data_ptr(), qbuf.part.data_ptr(), qbuf.part_w,
        qbuf.scratch.data_ptr(), qimg.data_ptr(),
        qimg.numel() * qimg.element_size(), fm.wgmma_grid(T), stream), name)
    qdws, qpsum = qbuf.reduce(lib, stream)
    key_stream_q_f32_bwd.launches += 1
    return ([drec, drayo, drays, drayd, dwk, dbk,
             qdws[-1][:int(wq.shape[1]), :dm].T,
             qpsum[qbuf.extra_off:qbuf.extra_off + dm]]
            + key[6:] + qbuf.walk_grads(qwalk, qdws, qpsum))


key_stream_q_bwd.launches = 0


def key_stream_q_f32_bwd(*args, **kwargs):
    """``key_stream_q_bwd`` on the fp32 walks (the kernel
    ``key_stream_q_f32_bwd``); ``launches`` counts that kernel's
    launches."""
    return key_stream_q_bwd(*args, cdt=torch.float32, **kwargs)


key_stream_q_f32_bwd.launches = 0


class KeyStreamQ(torch.autograd.Function):
    """``key_stream_scores_recq`` with its backward; saves qq / raw / ss
    from the forward, as the JAX kernel does."""

    @staticmethod
    def forward(ctx, opts, rec, rayo, rays, rayd, wk, bk, wq, bq, *tensors):
        nk = len(walk_tensors(opts[0]))
        kwalk = walk_with(opts[0], tensors[:nk])
        qwalk = walk_with(opts[1], tensors[nk:])
        attn, raw, ss, qq = key_stream_q_fwd(rec, rayo, rays, rayd, kwalk, wk,
                                             bk, qwalk, wq, bq, *opts[2:])
        ctx.opts = opts
        ctx.save_for_backward(rec, rayo, rays, rayd, wk, bk, wq, bq, qq, raw,
                              ss, *tensors)
        return attn

    @staticmethod
    def backward(ctx, dattn):
        (rec, rayo, rays, rayd, wk, bk, wq, bq, qq, raw, ss,
         *tensors) = ctx.saved_tensors
        nk = len(walk_tensors(ctx.opts[0]))
        kwalk = walk_with(ctx.opts[0], tensors[:nk])
        qwalk = walk_with(ctx.opts[1], tensors[nk:])
        return (None, *key_stream_q_bwd(rec, rayo, rays, rayd, kwalk, wk, bk,
                                        qwalk, wq, bq, qq, raw, ss, dattn,
                                        *ctx.opts[2:]))


def key_stream_scores_recq(rec, rayo, rays, rayd, kwalk: Walk, wk, bk,
                           qwalk: Walk, wq, bq, score_act="relu",
                           bkg_score=5.0, eps=1e-6, cdt=torch.float32):
    """Differentiable query-folded key stream (JAX
    ``key_stream_scores_recq``): rec (K, T, rp) gathered k-major, rayo / rays
    (T, 3) (rays normalized), rayd (T, 3) the RAW ray directions (the query
    feature) -> attn (T, K+1) fp32, background token last."""
    return KeyStreamQ.apply((kwalk, qwalk, score_act, float(bkg_score),
                             float(eps), cdt), rec, rayo, rays, rayd, wk, bk,
                            wq, bq, *walk_tensors(kwalk),
                            *walk_tensors(qwalk))
