"""Training streams that read raw feature tensors
(``papr_tpu/ops/stream_attn.py`` ``key_stream_scores`` /
``value_stream_fuse``, the kernels of ``tpu.fused_attn: stream``), forward
and backward.

The key stream takes xk (K, T, d_raw) fp32, k-major raw key features
([position, proj, perp, point features?]; the posenc runs inside), the
projected query qq (T, dm) and the (T, K) influence scores and alive mask,
and returns the background-token softmax attn (T, K+1). The value stream
takes xv (K, T, d_raw) ([proj, perp, point features?]) and attn and returns
the renormalized fuse (T, C). Neither materializes an embedding in device
memory.

Each direction has a CUDA kernel (``csrc/key_stream_feat.cu``,
``csrc/value_stream_feat.cu``; weight gradients through ``csrc/wgrad.cu``)
and a plain PyTorch version; a backward's plain version is the plain forward
recomputed under autograd. A CPU tensor takes the plain version; a CUDA
tensor takes the kernel or raises. Numerics as ``ops/stream_attn.py``; the
compute dtype picks the kernel: bf16, or fp32 (``use_amp: false``: the
``_f32`` entry points, counted apart by ``key_stream_feat_f32_fwd`` /
``_bwd`` and ``value_stream_feat_f32_fwd`` / ``_bwd``). The forwards, both
forms, run on wgmma (``csrc/walk_wgmma.cuh`` ``stream_fwd_wg``, the record
streams' function with the feature rows as its token source): they take the
weight image of ``stream_attn.fwd_wgmma_pack`` (bf16) or
``fwd_wgmma_pack_f32`` (fp32) and the persistent grid, the key writes its
masked scores to a (T, K) buffer that a softmax kernel reads, the value
adds into a zeroed output; K <= 64, fp32 value rows <= ``F32_FWD_MAX_ROWS``
and bf16 value rows <= ``bf16_fwd_max_rows`` of the walk wide, refused
before any launch. Both backwards keep the WMMA walk.

The key backward returns ALL of dxk: the caller detaches the position
columns before they enter xk (``model/papr.py``), so autograd drops that
part there, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import fused_mlp as fm
from .fused_mlp import (BwdBuffers, Walk, c_ints, check_walk_for_kernel,
                        encode_plain, pack_walk, pack_walk_t,
                        source_segments, walk_plain, walk_tensors, walk_with)
from .stream_attn import (F32_FWD_MAX_ROWS, _check_score_act, _grads_of,
                          _score_softmax, _wk_packs, bf16_fwd_max_rows,
                          fwd_wgmma_pack, fwd_wgmma_pack_f32)


def _walk_feat(x, walk: Walk, cdt):
    """posenc + walk over every (k, t) token of x (K, T, d_raw) ->
    (K, T, d_out) fp32."""
    K, T, d_raw = x.shape
    y = walk_plain(encode_plain(x.reshape(K * T, d_raw), walk.cols), walk, cdt)
    return y.reshape(K, T, -1)


def _key_feat_math(xk, qq, kwalk, wk, bk, influ, alive, score_act, bkg_score,
                   cdt, relu_on=None):
    return _score_softmax(_walk_feat(xk, kwalk, cdt), qq, wk, bk, influ,
                          alive > 0.5, score_act, bkg_score, cdt, relu_on)


def key_stream_feat_plain(xk, qq, kwalk: Walk, wk, bk, influ, alive,
                          score_act="relu", bkg_score=5.0, cdt=torch.float32,
                          relu_on=None):
    """Plain PyTorch version of the key stream forward: xk (K, T, d_raw),
    qq (T, dm), influ / alive (T, K) fp32 -> attn (T, K+1), raw dots (T, K),
    fp32. ``relu_on`` as in ``stream_attn.key_stream_plain``."""
    key_stream_feat_plain.calls += 1
    return _key_feat_math(xk, qq, kwalk, wk, bk, influ, alive, score_act,
                          bkg_score, cdt, relu_on)[:2]


key_stream_feat_plain.calls = 0


def key_stream_feat_bwd_plain(xk, qq, kwalk: Walk, wk, bk, influ, alive,
                              dattn, score_act="relu", bkg_score=5.0,
                              cdt=torch.float32, relu_on=None):
    """Plain version of the key stream backward -> [dxk, dqq, dinflu, dwk,
    dbk, walk grads (walk_tensors order)]."""
    key_stream_feat_bwd_plain.calls += 1
    fn = lambda x, q, i, w, b, *wt: _key_feat_math(
        x, q, walk_with(kwalk, wt), w, b, i, alive, score_act, bkg_score,
        cdt, relu_on)[0]
    return _grads_of(fn, [xk, qq, influ, wk, bk] + walk_tensors(kwalk), dattn)


key_stream_feat_bwd_plain.calls = 0


def _check_feat_args(x, walk: Walk, cdt, what):
    check_walk_for_kernel(walk, cdt, what)
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_cuda:
        raise ValueError(f"{what}: features must be (K, T, d_raw) float32 on "
                         f"the card, got {tuple(x.shape)} {x.dtype} "
                         f"{x.device}")
    K, T, d_raw = x.shape
    if K > 64:
        raise NotImplementedError(f"{what}: K <= 64 (got {K})")
    if max(c[0] for c in walk.cols) >= d_raw or d_raw > 256:
        raise ValueError(f"{what}: the posenc plan reads past the {d_raw} raw "
                         "features (at most 256)")


def _check_key_args(xk, qq, wk, influ, alive, what):
    K, T, _ = xk.shape
    dm = int(wk.shape[0])
    if tuple(qq.shape) != (T, dm) or dm > 256 or not qq.is_cuda:
        raise ValueError(f"{what}: qq want ({T}, {dm}) on the card, "
                         "d_model <= 256")
    for name, t in (("influ", influ), ("alive", alive)):
        if tuple(t.shape) != (T, K) or not t.is_cuda:
            raise ValueError(f"{what}: {name} must be ({T}, {K}) on the card")


def key_stream_feat_fwd(xk, qq, kwalk: Walk, wk, bk, influ, alive,
                        score_act="relu", bkg_score=5.0, cdt=torch.float32):
    """Key stream forward -> (attn (T, K+1), raw (T, K)): the CUDA kernel for
    CUDA tensors (``key_feat_fwd_wgmma_kernel`` / ``_f32_kernel``, then the
    softmax kernel), the plain version for CPU tensors."""
    if not xk.is_cuda:
        return key_stream_feat_plain(xk, qq, kwalk, wk, bk, influ, alive,
                                     score_act, bkg_score, cdt)
    from ..kernels import build

    _check_score_act(score_act)
    _check_feat_args(xk, kwalk, cdt, "key stream (features)")
    _check_key_args(xk, qq, wk, influ, alive, "key stream (features)")
    K, T, d_raw = xk.shape
    dm = int(wk.shape[0])
    dev = xk.device
    xk, qq = xk.contiguous(), qq.float().contiguous()
    influ, alive = influ.float().contiguous(), alive.float().contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    wkf, _, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    raw = torch.empty(T, K, dtype=torch.float32, device=dev)
    f32 = cdt == torch.float32
    args = (xk.data_ptr(), d_raw, T, K, qq.data_ptr(), dm,
            float(math.sqrt(dm)), influ.data_ptr(), alive.data_ptr(),
            ctypes.cast(c_ints(kmeta), ctypes.c_void_p), kw.data_ptr(),
            kb.data_ptr(), kln.data_ptr(), kplan.data_ptr(), wkf.data_ptr(),
            bkp.data_ptr(), dm_pad, int(score_act == "relu"),
            float(bkg_score), attn.data_ptr(), raw.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The wgmma forward: its masked scores, then the walk's layers and w_k
    # as one image in the compute dtype, its bytes and the grid.
    ss = torch.empty(T, K, dtype=torch.float32, device=dev)
    wpack = (fwd_wgmma_pack_f32 if f32 else fwd_wgmma_pack)(kw, kpd, dev,
                                                            (wkf,))
    name = ("papr_key_stream_feat_f32_fwd" if f32
            else "papr_key_stream_feat_fwd")
    rc = getattr(build.load(), name)(
        *args, ss.data_ptr(), wpack.data_ptr(),
        wpack.numel() * wpack.element_size(), fm.wgmma_grid(T), stream)
    build.check(rc, name)
    if f32:
        key_stream_feat_f32_fwd.launches += 1
    else:
        key_stream_feat_fwd.launches += 1
    return attn, raw


key_stream_feat_fwd.launches = 0


def key_stream_feat_f32_fwd(*args, **kwargs):
    """``key_stream_feat_fwd`` on the fp32 walk (the kernel
    ``key_stream_feat_f32_fwd`` in ``csrc/key_stream_feat.cu``:
    ``key_feat_fwd_wgmma_f32_kernel``, then the softmax kernel);
    ``launches`` counts that kernel's launches."""
    return key_stream_feat_fwd(*args, cdt=torch.float32, **kwargs)


key_stream_feat_f32_fwd.launches = 0


def key_stream_feat_bwd(xk, qq, kwalk: Walk, wk, bk, influ, alive, raw, dattn,
                        score_act="relu", bkg_score=5.0, cdt=torch.float32):
    """Key stream backward -> [dxk (K, T, d_raw), dqq (T, dm), dinflu (T, K),
    dwk, dbk, walk grads]: the CUDA kernels for CUDA tensors (raw saved by
    the forward), the plain version for CPU tensors."""
    if not xk.is_cuda:
        return key_stream_feat_bwd_plain(xk, qq, kwalk, wk, bk, influ, alive,
                                         dattn, score_act, bkg_score, cdt)
    from ..kernels import build

    what = "key stream (features) backward"
    _check_score_act(score_act)
    _check_feat_args(xk, kwalk, cdt, what)
    _check_key_args(xk, qq, wk, influ, alive, what)
    K, T, d_raw = xk.shape
    dm = int(wk.shape[0])
    dev = xk.device
    xk, qq = xk.contiguous(), qq.float().contiguous()
    influ, alive = influ.float().contiguous(), alive.float().contiguous()
    raw, dattn = raw.contiguous(), dattn.float().contiguous()
    kmeta, kw, kb, kln, kplan, kpd = pack_walk(kwalk, len(kwalk.cols), dev,
                                               cdt)
    kwt = pack_walk_t(kwalk, kpd, dev, cdt)
    wkf, wkb, bkp, dm_pad = _wk_packs(wk, bk, kpd[-1], dev, cdt)
    seg = source_segments(kwalk.cols, d_raw, dev)
    nblk = -(-T // 64)
    buf = BwdBuffers(kpd, K * nblk * 64, nblk, dev, head=(kpd[-1], dm_pad),
                     extra=dm_pad, cdt=cdt)
    dxk = torch.empty(K, T, d_raw, dtype=torch.float32, device=dev)
    dqq = torch.zeros(T, dm, dtype=torch.float32, device=dev)
    dinflu = torch.empty(T, K, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = cdt == torch.float32
    name = ("papr_key_stream_feat_f32_bwd" if f32
            else "papr_key_stream_feat_bwd")
    rc = getattr(lib, name)(
        xk.data_ptr(), d_raw, T, K, qq.data_ptr(), dm, float(math.sqrt(dm)),
        influ.data_ptr(), alive.data_ptr(), raw.data_ptr(), dattn.data_ptr(),
        ctypes.cast(c_ints(kmeta), ctypes.c_void_p), kw.data_ptr(),
        kb.data_ptr(), kln.data_ptr(), kplan.data_ptr(), kwt.data_ptr(),
        wkf.data_ptr(), wkb.data_ptr(), bkp.data_ptr(), dm_pad,
        int(score_act == "relu"), float(bkg_score), buf.stash.data_ptr(),
        ctypes.cast(buf.off_arg, ctypes.c_void_p), seg.data_ptr(),
        dxk.data_ptr(), dqq.data_ptr(), dinflu.data_ptr(),
        buf.part.data_ptr(), buf.part_w, buf.scratch.data_ptr(), stream)
    build.check(rc, name)
    dws, psum = buf.reduce(lib, stream)
    if f32:
        key_stream_feat_f32_bwd.launches += 1
    else:
        key_stream_feat_bwd.launches += 1
    d_out = int(wk.shape[1])
    return ([dxk, dqq, dinflu, dws[-1][:d_out, :dm].T,
             psum[buf.extra_off:buf.extra_off + dm]]
            + buf.walk_grads(kwalk, dws, psum))


key_stream_feat_bwd.launches = 0


def key_stream_feat_f32_bwd(*args, **kwargs):
    """``key_stream_feat_bwd`` on the fp32 walk (the kernel
    ``key_stream_feat_f32_bwd``); ``launches`` counts its launches."""
    return key_stream_feat_bwd(*args, cdt=torch.float32, **kwargs)


key_stream_feat_f32_bwd.launches = 0


class KeyStreamFeat(torch.autograd.Function):
    """``key_stream_scores`` with its backward; saves the raw dots from the
    forward and recomputes the softmax from them, as the JAX kernel does."""

    @staticmethod
    def forward(ctx, opts, xk, qq, influ, alive, wk, bk, *tensors):
        kwalk = walk_with(opts[0], tensors)
        attn, raw = key_stream_feat_fwd(xk, qq, kwalk, wk, bk, influ, alive,
                                        *opts[1:])
        ctx.opts = opts
        ctx.save_for_backward(xk, qq, influ, alive, wk, bk, raw, *tensors)
        return attn

    @staticmethod
    def backward(ctx, dattn):
        xk, qq, influ, alive, wk, bk, raw, *tensors = ctx.saved_tensors
        kwalk = walk_with(ctx.opts[0], tensors)
        dxk, dqq, dinflu, *rest = key_stream_feat_bwd(
            xk, qq, kwalk, wk, bk, influ, alive, raw, dattn, *ctx.opts[1:])
        return (None, dxk, dqq, dinflu, None, *rest)


def key_stream_scores(xk, qq, kwalk: Walk, wk, bk, influ, alive,
                      score_act="relu", bkg_score=5.0, cdt=torch.float32):
    """Differentiable key stream on raw features (JAX ``key_stream_scores``):
    xk (K, T, d_raw) k-major, qq (T, dm), influ / alive (T, K) fp32 ->
    attn (T, K+1) fp32, background token last."""
    return KeyStreamFeat.apply((kwalk, score_act, float(bkg_score), cdt), xk,
                               qq, influ, alive, wk, bk, *walk_tensors(kwalk))


def _value_feat_math(xv, attn, vwalk, normalize, cdt):
    K = xv.shape[0]
    y = _walk_feat(xv, vwalk, cdt).to(cdt).float()            # (K, T, C)
    w = attn[:, :K]
    if normalize:
        s = w.sum(dim=1, keepdim=True)
        w = w / torch.where(s > 0, s, torch.ones_like(s))
    return (w.T[..., None] * y).sum(0)


def value_stream_feat_plain(xv, attn, vwalk: Walk, normalize=True,
                            cdt=torch.float32):
    """Plain PyTorch version of the value stream forward: xv (K, T, d_raw),
    attn (T, K+1) -> fused (T, C) fp32."""
    value_stream_feat_plain.calls += 1
    return _value_feat_math(xv, attn, vwalk, normalize, cdt)


value_stream_feat_plain.calls = 0


def value_stream_feat_bwd_plain(xv, attn, vwalk: Walk, dfused, normalize=True,
                                cdt=torch.float32):
    """Plain version of the value stream backward -> [dxv, d_attn, walk
    grads]."""
    value_stream_feat_bwd_plain.calls += 1
    fn = lambda x, a, *wt: _value_feat_math(x, a, walk_with(vwalk, wt),
                                            normalize, cdt)
    return _grads_of(fn, [xv, attn] + walk_tensors(vwalk), dfused)


value_stream_feat_bwd_plain.calls = 0


def value_stream_feat_fwd(xv, attn, vwalk: Walk, normalize=True,
                          cdt=torch.float32):
    """Value stream forward -> fused (T, C) fp32: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if not xv.is_cuda:
        return value_stream_feat_plain(xv, attn, vwalk, normalize, cdt)
    from ..kernels import build

    _check_feat_args(xv, vwalk, cdt, "value stream (features)")
    K, T, d_raw = xv.shape
    if tuple(attn.shape) != (T, K + 1) or not attn.is_cuda:
        raise ValueError(f"value stream (features): attn want ({T}, {K + 1}) "
                         "on the card")
    dev = xv.device
    xv, attn = xv.contiguous(), attn.float().contiguous()
    vmeta, vw, vb, vln, vplan, vpd = pack_walk(vwalk, len(vwalk.cols), dev,
                                               cdt)
    f32 = cdt == torch.float32
    d_out = int(vwalk.ws[-1].shape[1])
    if f32 and vpd[-1] > F32_FWD_MAX_ROWS:
        raise NotImplementedError(
            f"value stream (features): value rows of {vpd[-1]} > "
            f"{F32_FWD_MAX_ROWS} (the fp32 forward keeps its fuse rows beside "
            "the fp32 activations in shared memory)")
    if not f32 and d_out > bf16_fwd_max_rows(vpd):
        raise NotImplementedError(
            f"value stream (features): value rows of {d_out} > "
            f"{bf16_fwd_max_rows(vpd)} (the bf16 forward keeps its fuse rows "
            "beside the encoding rows in shared memory)")
    # The wgmma forward adds each block's per-ray sums into a zeroed output.
    fused = torch.zeros(T, d_out, dtype=torch.float32, device=dev)
    wpack = (fwd_wgmma_pack_f32 if f32 else fwd_wgmma_pack)(vw, vpd, dev)
    name = ("papr_value_stream_feat_f32_fwd" if f32
            else "papr_value_stream_feat_fwd")
    build.check(getattr(build.load(), name)(
        xv.data_ptr(), d_raw, T, K, attn.data_ptr(),
        ctypes.cast(c_ints(vmeta), ctypes.c_void_p), vw.data_ptr(),
        vb.data_ptr(), vln.data_ptr(), vplan.data_ptr(), int(bool(normalize)),
        fused.data_ptr(), wpack.data_ptr(),
        wpack.numel() * wpack.element_size(), fm.wgmma_grid(T),
        torch.cuda.current_stream(dev).cuda_stream), name)
    if f32:
        value_stream_feat_f32_fwd.launches += 1
    else:
        value_stream_feat_fwd.launches += 1
    return fused


value_stream_feat_fwd.launches = 0


def value_stream_feat_f32_fwd(*args, **kwargs):
    """``value_stream_feat_fwd`` on the fp32 walk (the kernel
    ``value_stream_feat_f32_fwd`` in ``csrc/value_stream_feat.cu``:
    ``value_feat_fwd_wgmma_f32_kernel``); ``launches`` counts that kernel's
    launches."""
    return value_stream_feat_fwd(*args, cdt=torch.float32, **kwargs)


value_stream_feat_f32_fwd.launches = 0


def value_stream_feat_bwd(xv, attn, vwalk: Walk, dfused, normalize=True,
                          cdt=torch.float32):
    """Value stream backward -> [dxv (K, T, d_raw), d_attn (T, K+1), walk
    grads]: the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if not xv.is_cuda:
        return value_stream_feat_bwd_plain(xv, attn, vwalk, dfused, normalize,
                                           cdt)
    from ..kernels import build

    what = "value stream (features) backward"
    _check_feat_args(xv, vwalk, cdt, what)
    K, T, d_raw = xv.shape
    C = int(vwalk.ws[-1].shape[1])
    if tuple(attn.shape) != (T, K + 1) or tuple(dfused.shape) != (T, C) \
            or not attn.is_cuda or not dfused.is_cuda:
        raise ValueError(f"{what}: attn want ({T}, {K + 1}), dfused "
                         f"({T}, {C}), on the card")
    dev = xv.device
    xv, attn = xv.contiguous(), attn.float().contiguous()
    dfused = dfused.float().contiguous()
    vmeta, vw, vb, vln, vplan, vpd = pack_walk(vwalk, len(vwalk.cols), dev,
                                               cdt)
    vwt = pack_walk_t(vwalk, vpd, dev, cdt)
    seg = source_segments(vwalk.cols, d_raw, dev)
    nblk = -(-T // 64)
    buf = BwdBuffers(vpd, K * nblk * 64, nblk, dev, cdt=cdt)
    dxv = torch.empty(K, T, d_raw, dtype=torch.float32, device=dev)
    dattn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = cdt == torch.float32
    name = ("papr_value_stream_feat_f32_bwd" if f32
            else "papr_value_stream_feat_bwd")
    rc = getattr(lib, name)(
        xv.data_ptr(), d_raw, T, K, attn.data_ptr(), dfused.data_ptr(),
        ctypes.cast(c_ints(vmeta), ctypes.c_void_p), vw.data_ptr(),
        vb.data_ptr(), vln.data_ptr(), vplan.data_ptr(), vwt.data_ptr(),
        int(bool(normalize)), buf.stash.data_ptr(),
        ctypes.cast(buf.off_arg, ctypes.c_void_p), seg.data_ptr(),
        dxv.data_ptr(), dattn.data_ptr(), buf.part.data_ptr(), buf.part_w,
        buf.scratch.data_ptr(), stream)
    build.check(rc, name)
    dws, psum = buf.reduce(lib, stream)
    if f32:
        value_stream_feat_f32_bwd.launches += 1
    else:
        value_stream_feat_bwd.launches += 1
    return [dxv, dattn] + buf.walk_grads(vwalk, dws, psum)


value_stream_feat_bwd.launches = 0


def value_stream_feat_f32_bwd(*args, **kwargs):
    """``value_stream_feat_bwd`` on the fp32 walk (the kernel
    ``value_stream_feat_f32_bwd``); ``launches`` counts its launches."""
    return value_stream_feat_bwd(*args, cdt=torch.float32, **kwargs)


value_stream_feat_f32_bwd.launches = 0


class ValueStreamFeat(torch.autograd.Function):
    """``value_stream_fuse`` with its backward."""

    @staticmethod
    def forward(ctx, opts, xv, attn, *tensors):
        ctx.opts = opts
        ctx.save_for_backward(xv, attn, *tensors)
        return value_stream_feat_fwd(xv, attn, walk_with(opts[0], tensors),
                                     *opts[1:])

    @staticmethod
    def backward(ctx, dfused):
        xv, attn, *tensors = ctx.saved_tensors
        vwalk = walk_with(ctx.opts[0], tensors)
        return (None, *value_stream_feat_bwd(xv, attn, vwalk, dfused,
                                             *ctx.opts[1:]))


def value_stream_fuse(xv, attn, vwalk: Walk, normalize=True,
                      cdt=torch.float32):
    """Differentiable value stream on raw features (JAX
    ``value_stream_fuse``): xv (K, T, d_raw), attn (T, K+1) -> fused (T, C)
    fp32."""
    return ValueStreamFeat.apply((vwalk, bool(normalize), cdt), xv, attn,
                                 *walk_tensors(vwalk))
