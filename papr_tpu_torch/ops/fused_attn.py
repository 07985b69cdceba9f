"""Fused score -> softmax with its backward (``papr_tpu/ops/fused_attn.py``),
k-major layout.

The attention tail between the k / q embedder outputs and feature fusion:

    kk = embedk @ w_k^T + b_k          (per selected point)
    qq = embedq @ w_q^T + b_q          (per ray)
    raw = <qq, kk> / sqrt(d_model)
    s   = score_act(raw) * influ
    s   = where(alive, s, NEG_BIG)
    attn = softmax([s, bkg_score])     (background token last)

``fused_scores_fwd`` / ``fused_scores_bwd`` wrap the CUDA kernels in
``csrc/fused_attn.cu`` (the ports of the Pallas ``_fwd_kernel`` and
``_bwd_kernel``; the weight gradients finish in ``csrc/wgrad.cu``);
``fused_scores_plain`` / ``fused_scores_bwd_plain`` are the same functions
in plain PyTorch, and ``fused_scores`` joins the directions in an autograd
``Function``. A CPU tensor takes the plain version; a CUDA tensor takes the
kernel or raises. The renormalize-and-fuse epilogue stays outside, as in the
JAX package. The compute dtype picks the kernel: bf16, or fp32
(``use_amp: false``: ``fused_scores_f32_fwd`` / ``_bwd``; the backward the
bf16 kernel with fp32 operands and 3xTF32 products, fp32 gradients and
stashes; the forward on wgmma, its w_q and w_k heads as 3xTF32 products on
rows staged from memory, their weights one image, ``fwd_wgmma_image``, qq
and the masked scores in device rows between its kernels, the persistent
grid of ``fused_mlp.wgmma_grid``; K <= 64 and widths <= 256, refused before
any launch).

Numerics: scores and softmax in fp32; the two projections in the compute
dtype with the bias added in the compute dtype (``nn/mlp.py linear_apply``),
promoted to fp32 after. The key embeddings enter k-major, (K, T, Dk): the
(K*T, Dk) embedder output over k-major tokens viewed 3D.
"""

from __future__ import annotations

import math

import torch

from . import fused_mlp as fm
from .fused_mlp import pack_walk_wgmma_f32, round_up, wgrad

NEG_BIG = -1e30


def _cdt_of(x: torch.Tensor, compute) -> torch.dtype:
    if compute is not None:
        return compute
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _check_score_act(score_act: str) -> None:
    if score_act not in ("relu", "none"):
        raise NotImplementedError(score_act)


def _linear(x, w, b, cdt):
    """``linear_apply`` semantics: product accumulated in fp32 and rounded
    to ``cdt``, bias added in ``cdt``, promoted to fp32."""
    y = (x.to(cdt).float() @ w.to(cdt).float().T).to(cdt)
    return (y + b.to(cdt)).float()


def _score_math(embedk, embedq, wk, bk, wq, bq, influ, alive, score_act,
                bkg_score, cdt, relu_on=None):
    _check_score_act(score_act)
    dm = wk.shape[0]
    qq = _linear(embedq, wq, bq, cdt)                         # (T, dm)
    kk = _linear(embedk, wk, bk, cdt)                         # (K, T, dm)
    raw = ((qq[None] * kk).sum(-1) * (1.0 / math.sqrt(dm))).T  # (T, K)
    if score_act != "relu":
        sact = raw
    elif relu_on is None:
        sact = torch.clamp_min(raw, 0.0)
    else:
        sact = raw * relu_on
    s = torch.where(alive > 0.5, sact * influ.float(), NEG_BIG)
    m = torch.clamp_min(s.amax(dim=1, keepdim=True), bkg_score)
    e = torch.exp(s - m)
    eb = torch.exp(bkg_score - m)
    z = e.sum(dim=1, keepdim=True) + eb
    return torch.cat([e / z, eb / z], dim=1), raw


def fused_scores_plain(embedk, embedq, wk, bk, wq, bq, influ, alive,
                       score_act="relu", bkg_score=5.0, cdt=torch.float32,
                       relu_on=None):
    """Plain PyTorch version of the forward -> (attn (T, K+1), raw (T, K))
    fp32. ``relu_on`` (T, K) bool, optional: the score relu's on-pattern to
    apply instead of ``raw > 0`` (given the kernel forward's pattern, the
    plain version and its backward differentiate the same piecewise-linear
    function as the kernel: a dot that rounds to opposite signs in two bf16
    forwards no longer switches a gradient path on in one only)."""
    fused_scores_plain.calls += 1
    return _score_math(embedk, embedq, wk, bk, wq, bq, influ, alive,
                       score_act, float(bkg_score), cdt, relu_on)


fused_scores_plain.calls = 0


def fused_scores_bwd_plain(embedk, embedq, wk, bk, wq, bq, influ, alive, dattn,
                           score_act="relu", bkg_score=5.0, cdt=torch.float32,
                           relu_on=None):
    """Plain version of the backward: the plain forward recomputed under
    autograd -> [d_embedk, d_embedq, dwk, dbk, dwq, dbq, d_influ]."""
    fused_scores_bwd_plain.calls += 1
    leaves = [t.detach().requires_grad_(True)
              for t in (embedk, embedq, wk, bk, wq, bq, influ.float())]
    with torch.enable_grad():
        attn = _score_math(*leaves[:6], leaves[6], alive, score_act,
                           float(bkg_score), cdt, relu_on)[0]
        grads = torch.autograd.grad(attn, leaves, dattn.float(),
                                    allow_unused=True)
    return [torch.zeros_like(l) if g is None else g
            for g, l in zip(grads, leaves)]


fused_scores_bwd_plain.calls = 0


def _pack(embedk, embedq, wk, bk, wq, bq, influ, alive, cdt, what,
          weights: bool = True):
    """Checks and kernel layouts in the compute dtype ``cdt``, shared by
    both directions; without ``weights`` (the fp32 forward, which reads the
    packed image instead) the padded weight layouts are left out."""
    if cdt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{what}: compute dtype {cdt} (the CUDA "
                                  "kernels run bf16 or fp32)")
    K, T, Dk = embedk.shape
    Dq = embedq.shape[-1]
    dm = int(wk.shape[0])
    if (tuple(embedq.shape) != (T, Dq) or tuple(wk.shape) != (dm, Dk)
            or tuple(wq.shape) != (dm, Dq) or tuple(influ.shape) != (T, K)
            or tuple(alive.shape) != (T, K)):
        raise ValueError(
            f"{what}: embedk {tuple(embedk.shape)}, embedq "
            f"{tuple(embedq.shape)}, wk {tuple(wk.shape)}, wq "
            f"{tuple(wq.shape)}, influ {tuple(influ.shape)}, alive "
            f"{tuple(alive.shape)} do not fit together")
    if K > 64 or max(Dk, Dq, dm) > 256:
        raise NotImplementedError(f"{what}: K <= 64 and widths <= 256 "
                                  f"(K={K}, Dk={Dk}, Dq={Dq}, dm={dm})")
    for name, t in (("embedk", embedk), ("embedq", embedq), ("wk", wk),
                    ("wq", wq), ("influ", influ), ("alive", alive)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be on the card")
    dev = embedk.device
    pdk, pdq, pdm = round_up(Dk, 16), round_up(Dq, 16), round_up(dm, 16)

    def padded(w, rows, cols):
        out = torch.zeros(rows, cols, dtype=cdt, device=dev)
        out[:w.shape[0], :w.shape[1]] = w.to(device=dev, dtype=cdt)
        return out

    def padded_bias(b):
        out = torch.zeros(pdm, dtype=torch.float32, device=dev)
        out[:dm] = b.to(device=dev, dtype=torch.float32)
        return out

    mats = (dict(wkT=padded(wk.T, pdk, pdm), wqT=padded(wq.T, pdq, pdm),
                 wkB=padded(wk, pdm, pdk), wqB=padded(wq, pdm, pdq))
            if weights else {})
    return dict(
        ek=embedk.to(cdt).contiguous(), eq=embedq.to(cdt).contiguous(),
        influ=influ.float().contiguous(), alive=alive.float().contiguous(),
        bk=padded_bias(bk), bq=padded_bias(bq),
        dims=(T, K, Dk, Dq, dm, pdk, pdq, pdm), dev=dev, **mats)


def _head_args(p, score_act, bkg_score):
    T, K, Dk, Dq, dm, pdk, pdq, pdm = p["dims"]
    ptr = lambda name: p[name].data_ptr() if name in p else None
    return (p["ek"].data_ptr(), p["eq"].data_ptr(), p["influ"].data_ptr(),
            p["alive"].data_ptr(), ptr("wkT"), ptr("wqT"),
            p["bk"].data_ptr(), p["bq"].data_ptr(), T, K, Dk, Dq, dm, pdk,
            pdq, pdm, float(math.sqrt(dm)), float(bkg_score),
            int(score_act == "relu"))


def _qq_rows(p) -> torch.Tensor:
    """The fp32 kernels' (T, pdm) buffer of qq rows: qq stays fp32 there
    (the forward's query head writes it, its key head reads it back)."""
    T, pdm = p["dims"][0], p["dims"][7]
    return torch.empty(T, pdm, dtype=torch.float32, device=p["dev"])


def _fwd_wgmma_rows(p):
    """The fp32 forward's device rows: qq (T, pdm), which its query head
    writes and its key head reads, and the masked scores ss (T, K), which
    the key head writes and the softmax kernel reads; fp32."""
    T, K = p["dims"][:2]
    return _qq_rows(p), torch.empty(T, K, dtype=torch.float32,
                                    device=p["dev"])


def fwd_wgmma_image(wk, wq, dev) -> torch.Tensor:
    """The fp32 forward's weight image (``csrc/fused_attn.cu``, on
    ``walk_wgmma.cuh``'s fp32 operand form): w_q^T, then w_k^T, input-major
    fp32, as ``pack_walk_wgmma_f32``'s 16 KB hi / lo stages (the layout of
    ``stream_attn.fwd_wgmma_pack_f32``); the kernel reads w_q's stages for
    the query head and w_k's for the key head."""
    return pack_walk_wgmma_f32([wq.T.float(), wk.T.float()], dev)


def fused_scores_fwd(embedk, embedq, wk, bk, wq, bq, influ, alive,
                     score_act="relu", bkg_score=5.0, cdt=torch.float32,
                     with_raw: bool = False):
    """Forward -> attn (T, K+1) fp32 (and the raw dots (T, K) with
    ``with_raw``): the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not embedk.is_cuda:
        attn, raw = fused_scores_plain(embedk, embedq, wk, bk, wq, bq, influ,
                                       alive, score_act, bkg_score, cdt)
        return (attn, raw) if with_raw else attn
    from ..kernels import build

    _check_score_act(score_act)
    f32 = cdt == torch.float32
    p = _pack(embedk, embedq, wk, bk, wq, bq, influ, alive, cdt,
              "fused_scores", weights=not f32)
    T, K = p["dims"][:2]
    dev = p["dev"]
    attn = torch.empty(T, K + 1, dtype=torch.float32, device=dev)
    raw = (torch.empty(T, K, dtype=torch.float32, device=dev)
           if with_raw else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*_head_args(p, score_act, bkg_score), attn.data_ptr(),
            raw.data_ptr() if with_raw else None)
    lib = build.load()
    if f32:
        # The wgmma forward: qq's rows, the masked scores, then w_q and w_k
        # as one fp32 image, its bytes and the grid.
        qq, ss = _fwd_wgmma_rows(p)
        wpack = fwd_wgmma_image(wk, wq, dev)
        rc = lib.papr_fused_scores_f32_fwd(
            *args, qq.data_ptr(), ss.data_ptr(), wpack.data_ptr(),
            wpack.numel() * wpack.element_size(), fm.wgmma_grid(T), stream)
        build.check(rc, "papr_fused_scores_f32_fwd")
        fused_scores_f32_fwd.launches += 1
    else:
        build.check(lib.papr_fused_scores_fwd(*args, stream),
                    "papr_fused_scores_fwd")
        fused_scores_fwd.launches += 1
    return (attn, raw) if with_raw else attn


fused_scores_fwd.launches = 0


def fused_scores_f32_fwd(*args, **kwargs):
    """``fused_scores_fwd`` in fp32 (the kernel ``fused_scores_f32_fwd`` in
    ``csrc/fused_attn.cu``); ``launches`` counts that kernel's launches."""
    return fused_scores_fwd(*args, cdt=torch.float32, **kwargs)


fused_scores_f32_fwd.launches = 0


def fused_scores_bwd(embedk, embedq, wk, bk, wq, bq, influ, alive, dattn,
                     score_act="relu", bkg_score=5.0, cdt=torch.float32):
    """Backward -> [d_embedk (K, T, Dk), d_embedq (T, Dq) in the inputs'
    dtypes, dwk, dbk, dwq, dbq, d_influ (T, K) fp32]: the CUDA kernels for
    CUDA tensors (the forward is recomputed), the plain version for CPU
    tensors."""
    if not embedk.is_cuda:
        return fused_scores_bwd_plain(embedk, embedq, wk, bk, wq, bq, influ,
                                      alive, dattn, score_act, bkg_score, cdt)
    from ..kernels import build

    _check_score_act(score_act)
    p = _pack(embedk, embedq, wk, bk, wq, bq, influ, alive, cdt,
              "fused_scores backward")
    T, K, Dk, Dq, dm, pdk, pdq, pdm = p["dims"]
    if Dk % 8 or Dq % 8:
        raise NotImplementedError(
            f"fused_scores backward: embedding widths must be multiples of 8 "
            f"for the dW reduction (Dk={Dk}, Dq={Dq})")
    dev = p["dev"]
    if tuple(dattn.shape) != (T, K + 1) or not dattn.is_cuda:
        raise ValueError(f"fused_scores backward: dattn want ({T}, {K + 1}) "
                         f"on the card, got {tuple(dattn.shape)} "
                         f"{dattn.device}")
    dattn = dattn.float().contiguous()
    nblk = -(-T // 64)
    # d_embedk / d_embedq and the dW stashes in the compute dtype (fp32:
    # the dkk stash is K * T * pdm * 4 bytes).
    dek = torch.empty(K, T, Dk, dtype=cdt, device=dev)
    deq = torch.empty(T, Dq, dtype=cdt, device=dev)
    dinflu = torch.empty(T, K, dtype=torch.float32, device=dev)
    dkk = torch.empty(K * T, pdm, dtype=cdt, device=dev)
    dqq = torch.empty(T, pdm, dtype=cdt, device=dev)
    part = torch.empty(nblk, 2 * pdm, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (*_head_args(p, score_act, bkg_score), dattn.data_ptr(),
            p["wkB"].data_ptr(), p["wqB"].data_ptr(), dek.data_ptr(),
            deq.data_ptr(), dinflu.data_ptr(), dkk.data_ptr(), dqq.data_ptr(),
            part.data_ptr())
    f32 = cdt == torch.float32
    if f32:
        qq = _qq_rows(p)
        rc = lib.papr_fused_scores_f32_bwd(*args, qq.data_ptr(), stream)
        build.check(rc, "papr_fused_scores_f32_bwd")
    else:
        build.check(lib.papr_fused_scores_bwd(*args, stream),
                    "papr_fused_scores_bwd")
    dwkT = wgrad(lib, p["ek"].data_ptr(), dkk.data_ptr(), K * T, Dk, pdm, dev,
                 stream, cdt)
    dwqT = wgrad(lib, p["eq"].data_ptr(), dqq.data_ptr(), T, Dq, pdm, dev,
                 stream, cdt)
    psum = torch.empty(2 * pdm, dtype=torch.float32, device=dev)
    build.check(lib.papr_colsum(part.data_ptr(), nblk, 2 * pdm,
                                psum.data_ptr(), stream), "papr_colsum")
    if f32:
        fused_scores_f32_bwd.launches += 1
    else:
        fused_scores_bwd.launches += 1
    return [dek.to(embedk.dtype), deq.to(embedq.dtype), dwkT[:, :dm].T,
            psum[:dm], dwqT[:, :dm].T, psum[pdm:pdm + dm], dinflu]


fused_scores_bwd.launches = 0


def fused_scores_f32_bwd(*args, **kwargs):
    """``fused_scores_bwd`` in fp32 (the kernel ``fused_scores_f32_bwd`` and
    ``wgrad_f32``); ``launches`` counts that kernel's launches."""
    return fused_scores_bwd(*args, cdt=torch.float32, **kwargs)


fused_scores_f32_bwd.launches = 0


class FusedScores(torch.autograd.Function):
    """``fused_scores`` with its backward (the forward is recomputed there,
    as in the JAX kernel). ``alive`` gets no gradient."""

    @staticmethod
    def forward(ctx, opts, embedk, embedq, wk, bk, wq, bq, influ, alive):
        ctx.opts = opts
        ctx.save_for_backward(embedk, embedq, wk, bk, wq, bq, influ, alive)
        return fused_scores_fwd(embedk, embedq, wk, bk, wq, bq, influ, alive,
                                *opts)

    @staticmethod
    def backward(ctx, dattn):
        saved = ctx.saved_tensors
        dek, deq, dwk, dbk, dwq, dbq, dinflu = fused_scores_bwd(
            *saved, dattn, *ctx.opts)
        wk, bk, wq, bq, influ = saved[2:7]
        return (None, dek, deq, dwk.to(wk.dtype), dbk.to(bk.dtype),
                dwq.to(wq.dtype), dbq.to(bq.dtype), dinflu.to(influ.dtype),
                None)


def fused_scores(embedk, embedq, wk, bk, wq, bq, influ, alive,
                 score_act="relu", bkg_score=5.0, compute=None):
    """Differentiable fused attention scores.

    embedk (K, T, Dk) k-major key embeddings, embedq (T, Dq), wk / wq
    (d_model, D) with biases, influ (T, K) fp32, alive (T, K) {0, 1} ->
    attn (T, K+1) fp32 softmax weights, background token last. ``compute``
    is the projections' dtype (default: bf16 for bf16 embeddings, else
    fp32)."""
    cdt = _cdt_of(embedk, compute)
    return FusedScores.apply((score_act, float(bkg_score), cdt), embedk,
                             embedq, wk, bk, wq, bq, influ, alive)


def score_fusible(attn_cfg) -> bool:
    """True when the config's attention tail is covered by this kernel."""
    return (attn_cfg.score_act in ("relu", "none")
            and attn_cfg.get("kernel_type", "scaled-dot") == "scaled-dot")
