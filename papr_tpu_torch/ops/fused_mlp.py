"""Fused embedder: posenc -> [LayerNorm] -> dense stack -> [LayerNorm]
(``papr_tpu/ops/fused_mlp.py``), forward and backward.

``fused_mlp`` is the wrapper of the CUDA kernel in ``csrc/fused_mlp.cu``
(the port of the Pallas ``_fwd_kernel``); ``fused_mlp_bwd`` wraps the
backward (``csrc/fused_mlp_bwd.cu`` + the dW reduction in ``csrc/wgrad.cu``,
the port of ``_bwd_kernel``); both forms run on wgmma
(``csrc/walk_wgmma.cuh`` / ``walk_wgmma_bwd.cuh``, weights packed by
``pack_embed_wgmma``); ``fused_mlp_plain`` / ``fused_mlp_bwd_plain``
are the same functions in plain PyTorch, and ``fused_mlp_apply`` joins the
two directions in an autograd ``Function``. A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises.

The compute dtype picks the kernel, as ``_cdt`` picks the Pallas kernel's
operand type: bf16 (``use_amp: true``) or fp32 (``use_amp: false``: the
``_f32`` entry points, the same functions in the walk's fp32 operand form:
fp32 activations and 3xTF32 products on weights split into hi / lo at pack
time). ``fused_mlp_f32`` / ``fused_mlp_bwd_f32`` / ``wgrad_f32`` count the
fp32 kernels' launches.

Numerics follow the TPU kernel's walk (``walk_body_fwd``): the posenc is
computed in fp32 from the raw features; the input LayerNorm runs on the fp32
encoding; each dense layer takes operands in the compute dtype, accumulates
in fp32, adds an fp32 bias, applies relu/none and rounds to the compute dtype
for the next layer; the last layer's fp32 result feeds the output LayerNorm;
the output is cast to the compute dtype. The LayerNorm is the reference's
(fp32 statistics over the true width, unbiased std, ``1 / (std + eps)`` with
eps fixed at 1e-6). The walk helpers here are shared with
``ops/stream_attn.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

_ALIGN = 16          # WMMA tile edge: every walk width is padded to it
_ACT_CODES = {"none": 0, "relu": 1}
LN_EPS = 1e-6


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------- posenc ----

@functools.lru_cache(maxsize=None)
def posenc_plan(dims, Ls, embed_type, factor, mult, extra_dim):
    """Column plan of the interleaved posenc (nn/posenc.py layout) over
    concatenated raw features: one (source column, frequency, kind) triple
    per encoded column, kind 0 = the raw value, 1 = sin, 2 = cos. Raw
    extras pass through un-encoded after the encoded features. Returns
    (raw width, columns)."""
    cols, raw = [], 0
    for fi, d in enumerate(dims):
        for j in range(d):
            if embed_type == 1:
                cols.append((raw + j, 0.0, 0))
            for i in range(Ls[fi]):
                s = (factor ** i) * mult
                cols.append((raw + j, s, 1))
                cols.append((raw + j, s, 2))
        raw += d
    for j in range(extra_dim):
        cols.append((raw + j, 0.0, 0))
    return raw + extra_dim, tuple(cols)


def encode_plain(raw: torch.Tensor, cols) -> torch.Tensor:
    """(R, d_raw) fp32 raw features -> (R, len(cols)) fp32 encoding."""
    dev = raw.device
    src = torch.tensor([c[0] for c in cols], dtype=torch.long, device=dev)
    freq = torch.tensor([c[1] for c in cols], dtype=torch.float32, device=dev)
    kind = torch.tensor([c[2] for c in cols], dtype=torch.int32, device=dev)
    xg = raw.float()[:, src]
    t = xg * freq
    return torch.where(kind == 0, xg,
                       torch.where(kind == 1, torch.sin(t), torch.cos(t)))


# ------------------------------------------------------------------ walk ----

class Walk(NamedTuple):
    """One embedder block in kernel form: input-major weights (d_i, d_i+1),
    biases, optional (a, b) LayerNorms, activations and the posenc plan."""
    ws: tuple
    bs: tuple
    ln_in: tuple | None
    ln_out: tuple | None
    act: str
    last_act: str
    cols: tuple


def ln_rows(x: torch.Tensor, a, b) -> torch.Tensor:
    """The TPU kernel's LayerNorm form (fused_mlp.py _ln_fwd) on fp32 rows."""
    n = x.shape[-1]
    mu = x.sum(-1, keepdim=True) / n
    d = x - mu
    var = (d * d).sum(-1, keepdim=True) / max(n - 1, 1)
    r = 1.0 / (torch.sqrt(var) + LN_EPS)
    return d * r * a.float() + b.float()


def _act(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp_min(z, 0.0)
    if kind == "none":
        return z
    raise NotImplementedError(kind)


# The gradients of the plain versions. Autograd's own rule rounds a
# gradient wherever the forward cast to the compute dtype (a bf16 tensor's
# gradient is bf16); the TPU kernels' backwards (walk_body_bwd) keep every
# gradient fp32 and round only dz, for the dX and dW products, taking db from
# the fp32 dz. With ``kernel_grads=True`` the plain versions take their
# gradients at those rounding points (same forward values): a cast passes its
# gradient through in fp32, a dense layer rounds dz for its two products only.
# The checks hold the kernels' bias gradients to these.


class _CastST(torch.autograd.Function):
    """x rounded to cdt, kept fp32; the gradient passes through in fp32."""

    @staticmethod
    def forward(ctx, x, cdt):
        return x.to(cdt).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _DenseST(torch.autograd.Function):
    """h @ w + b on operands rounded to cdt (fp32 products); backward as
    walk_body_bwd: dz rounded to cdt for dX and dW, db from the fp32 dz."""

    @staticmethod
    def forward(ctx, h, w, b, cdt):
        h32, wc = h.to(cdt).float(), w.to(cdt).float()
        ctx.save_for_backward(h32, wc)
        ctx.cdt, ctx.has_b = cdt, b is not None
        z = h32 @ wc
        return z + b.float() if b is not None else z

    @staticmethod
    def backward(ctx, g):
        h32, wc = ctx.saved_tensors
        gc = g.to(ctx.cdt).float()
        dw = h32.reshape(-1, h32.shape[-1]).T @ gc.reshape(-1, gc.shape[-1])
        db = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_b else None
        return gc @ wc.T, dw, db, None


def cast_c(x: torch.Tensor, cdt: torch.dtype,
           kernel_grads: bool = False) -> torch.Tensor:
    """x rounded to the compute dtype (a bf16 tensor, or with
    ``kernel_grads`` fp32 with a pass-through gradient)."""
    return _CastST.apply(x, cdt) if kernel_grads else x.to(cdt)


def dense_c(h, w, b, cdt: torch.dtype,
            kernel_grads: bool = False) -> torch.Tensor:
    """h @ w (+ b) in fp32 on operands rounded to the compute dtype; with
    ``kernel_grads`` the backward of ``_DenseST``."""
    if kernel_grads:
        return _DenseST.apply(h, w, b, cdt)
    z = h.float() @ w.to(cdt).float()
    return z + b.float() if b is not None else z


def walk_plain(enc: torch.Tensor, walk: Walk, cdt: torch.dtype,
               inputs: list | None = None,
               kernel_grads: bool = False) -> torch.Tensor:
    """Dense walk on an fp32 encoding; returns the fp32 output (before any
    final cast). Operands are rounded to ``cdt``; products accumulate in
    fp32 (exact fp32 matmul of the rounded operands). With ``inputs`` (a
    list) each dense layer's input, in ``cdt``, is appended to it;
    ``kernel_grads``: gradients at the TPU kernels' rounding points."""
    h = ln_rows(enc, *walk.ln_in) if walk.ln_in is not None else enc
    h = cast_c(h, cdt, kernel_grads)
    n = len(walk.ws)
    z = None
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        if inputs is not None:
            inputs.append(h)
        z = dense_c(h, w, b, cdt, kernel_grads)
        z = _act(z, walk.last_act if i == n - 1 else walk.act)
        if i < n - 1:
            h = cast_c(z, cdt, kernel_grads)
    if walk.ln_out is not None:
        z = ln_rows(z, *walk.ln_out)
    return z


def walk_relu_margin(enc: torch.Tensor, walk: Walk) -> torch.Tensor:
    """Per row of an fp32 encoding, how far the walk's relu pattern is from
    flipping: the smallest |z| / rms(z) over the inputs z of its relus, in
    the plain fp32 forward. Two fp32 forwards that sum in different orders
    put a z within ~1e-6 rms of 0 on opposite sides now and then; on a row
    whose margin is well above that, both forwards switch the same paths on,
    so a backward kernel can be held to its plain version there at fp32
    precision."""
    h = ln_rows(enc, *walk.ln_in) if walk.ln_in is not None else enc
    n = len(walk.ws)
    margin = torch.full((enc.shape[0],), float("inf"), device=enc.device)
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        z = h.float() @ w.float() + b.float()
        act = walk.last_act if i == n - 1 else walk.act
        if act == "relu":
            rms = z.square().mean().sqrt().clamp_min(1e-30)
            margin = torch.minimum(margin, (z.abs() / rms).amin(dim=-1))
        h = _act(z, act)
    return margin


class WalkQuant(NamedTuple):
    """Int8 form of a walk's dense stack (``ops/stream_attn.py
    quantize_walk``): per layer the int8 weights, input-major (d_i, d_i+1),
    with the layer's activation scale folded into their rows; the inverse
    activation scale of each input column (d_i,), 0 for a dead column; and
    the dequantization scale of each output channel (d_i+1,)."""
    wq: tuple
    inv: tuple
    dq: tuple


class FrameQuant(tuple):
    """(key WalkQuant, value WalkQuant) of one frame (``model/papr.py
    eval_quant_params``). ``packs`` keeps the kernels' packed form after the
    frame's first tile: the one quantized pack that is kept, because it is
    made for one frame and dropped with it (a tiled frame would otherwise
    repack the same quantization for every tile)."""
    packs = None


def quantize_rows(h: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """clip(round(h * inv), +-127) as integer-valued fp32 (round half to
    even, like ``jnp.round`` and the kernel's ``__float2int_rn``)."""
    return torch.clamp(torch.round(h * inv), -127.0, 127.0)


def int_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact product of integer-valued q (R, d) and int8 weights (d, e) as
    fp32: summed in fp64, where every partial sum (< 2^53) is exact, so the
    result is the int32 accumulator's."""
    return (q.double() @ wq.double()).float()


def walk_plain_q(enc: torch.Tensor, walk: Walk, quant: WalkQuant) -> torch.Tensor:
    """Plain version of the int8 walk (``papr_tpu/ops/fused_mlp.py
    walk_body_fwd_q``) on an fp32 encoding -> the fp32 output: [LN fp32] ->
    per layer the input quantized per column, an exact integer product,
    ``* dq + b`` and the activation in fp32 -> [LN fp32]. Activations stay
    fp32 between layers (no rounding to a compute dtype)."""
    h = ln_rows(enc, *walk.ln_in) if walk.ln_in is not None else enc
    h = h.float()
    n = len(walk.ws)
    for i in range(n):
        z = int_matmul(quantize_rows(h, quant.inv[i]), quant.wq[i])
        z = z * quant.dq[i] + walk.bs[i].float()
        h = _act(z, walk.last_act if i == n - 1 else walk.act)
    if walk.ln_out is not None:
        h = ln_rows(h, *walk.ln_out)
    return h


@functools.lru_cache(maxsize=64)
def _plan_rows(cols, pd0: int, device) -> torch.Tensor:
    """The posenc plan as 3 fp32 rows of pd0 (source, frequency, kind)."""
    plan = torch.zeros(3, pd0, dtype=torch.float32)
    plan[:, :len(cols)] = torch.tensor(cols, dtype=torch.float32).T
    return plan.reshape(-1).to(device)


def pack_walk(walk: Walk, d_enc: int, device,
              cdt: torch.dtype = torch.bfloat16) -> tuple:
    """Kernel layout of a walk: widths padded to 16, all weights in one
    buffer of the compute dtype ``cdt`` (bf16, or fp32 for the fp32 walk)
    and biases in one fp32 buffer (zero padding), the LayerNorm
    tables, the posenc plan rows, and the int meta row ``csrc/walk.cuh``
    reads. Packed on every call (a few small copies): training rewrites the
    weights in place every step, which no cache key on the tensors' address
    and version can see (a write through ``.data`` leaves ``_version``
    alone)."""
    n = len(walk.ws)
    dims = [d_enc] + [int(w.shape[1]) for w in walk.ws]
    pd = [round_up(d, _ALIGN) for d in dims]
    w_off, b_off, wparts, bparts, wo, bo = [], [], [], [], 0, 0
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        wp = torch.zeros(pd[i], pd[i + 1], dtype=cdt, device=device)
        wp[:dims[i], :dims[i + 1]] = w.to(device=device, dtype=cdt)
        bp = torch.zeros(pd[i + 1], dtype=torch.float32, device=device)
        bp[:dims[i + 1]] = b.to(device=device, dtype=torch.float32)
        wparts.append(wp.reshape(-1))
        bparts.append(bp)
        w_off.append(wo)
        b_off.append(bo)
        wo += pd[i] * pd[i + 1]
        bo += pd[i + 1]
    ln = torch.zeros(2 * pd[0] + 2 * pd[-1], dtype=torch.float32, device=device)
    for (ab, base, width, d) in ((walk.ln_in, 0, pd[0], dims[0]),
                                 (walk.ln_out, 2 * pd[0], pd[-1], dims[-1])):
        if ab is not None:
            ln[base:base + d] = ab[0].to(device=device, dtype=torch.float32)
            ln[base + width:base + width + d] = ab[1].to(
                device=device, dtype=torch.float32)
    meta = ([n, d_enc, dims[-1], _ACT_CODES[walk.act],
             _ACT_CODES[walk.last_act], int(walk.ln_in is not None),
             int(walk.ln_out is not None)] + pd + w_off + b_off)
    return (meta, torch.cat(wparts), torch.cat(bparts), ln,
            _plan_rows(walk.cols, pd[0], torch.device(device)), pd)


def pack_walk_t(walk: Walk, pd, device,
                cdt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The transposed weights W_i^T in ``cdt``, each zero-padded to
    (pd[i+1], pd[i]) and laid out at the same offsets as ``pack_walk``'s
    weights: the reverse walk's dX = dz @ W^T runs through the forward's
    dense layer on them."""
    parts = []
    for i, w in enumerate(walk.ws):
        wt = torch.zeros(pd[i + 1], pd[i], dtype=cdt, device=device)
        wt[:w.shape[1], :w.shape[0]] = w.T.to(device=device, dtype=cdt)
        parts.append(wt.reshape(-1))
    return torch.cat(parts)


def wgmma_tile_n(pd_out: int) -> int:
    """The packed width of a layer's chunks for the wgmma walk
    (``csrc/walk_wgmma.cuh wg_tile_n``): the narrowest of 32 / 64 / 128 / 256
    that holds pd_out."""
    return next(n for n in (32, 64, 128, 256) if pd_out <= n)


def pack_walk_wgmma(mats, device) -> torch.Tensor:
    """Weights of the bf16 wgmma walk (``csrc/walk_wgmma.cuh``), from the
    input-major (pd_in, pd_out) matrices in the order the kernel streams
    them: per layer, ceil(pd_in / 64) chunks of ``wgmma_tile_n(pd_out)``
    rows of 64 bf16 along the input axis (K-major, zero beyond the
    matrix), each row's 16-byte groups XOR-swizzled by row % 8, so one TMA
    bulk copy lands a chunk in shared memory as wgmma reads it. One gather
    per call (the weights change every training step, so the image is never
    cached; only its index map, which depends on the widths alone)."""
    ents, base = [], 0
    for m in mats:
        a, b = int(m.shape[0]), int(m.shape[1])
        ents.append((a, b, base, b, 1))
        base += a * b
    flat = torch.cat([m.reshape(-1).to(device=device, dtype=torch.bfloat16)
                      for m in mats]
                     + [torch.zeros(1, dtype=torch.bfloat16, device=device)])
    return flat[_gather_index(tuple(ents), base, torch.device(device))]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def pack_walk_wgmma_f32(mats, device) -> torch.Tensor:
    """Weights of the fp32 wgmma walk (``csrc/walk_wgmma.cuh``, the fp32
    operand form), from the input-major (pd_in, pd_out) fp32 matrices in the
    order the kernel streams them: per matrix, ceil(pd_out / 64) passes of
    ceil(pd_in / 32) stages, each stage the 64 output rows of 32 tf32 along
    the input axis (K-major, zero beyond the matrix) as a hi image,
    ``tf32_rna(w)``, then a lo image, ``tf32_rna(w - hi)``; each row's
    16-byte groups XOR-swizzled by row % 8, and in each 8-deep group input
    row 2 q at position q, 2 q + 1 at q + 4 (a tf32 A fragment's columns q,
    q + 4 are the accumulator's 2 q, 2 q + 1). One gather per call; the
    index map depends on the widths alone."""
    ents, base = [], 0
    for m in mats:
        a, b = int(m.shape[0]), int(m.shape[1])
        ents.append((a, b, base, b, 1))
        base += a * b
    flat = torch.cat([m.reshape(-1).to(device=device, dtype=torch.float32)
                      for m in mats]
                     + [torch.zeros(1, dtype=torch.float32, device=device)])
    return split_tf32_stages(
        flat[_gather_index_f32(tuple(ents), base, torch.device(device))])


def split_tf32_stages(g: torch.Tensor) -> torch.Tensor:
    """An fp32 image gathered as stages of 64 x 32 values -> each stage's hi
    image, ``tf32_rna(g)``, then its lo image, ``tf32_rna(g - hi)``."""
    g = g.view(-1, 2048)
    hi = tf32_rna(g)
    return torch.stack([hi, tf32_rna(g - hi)], dim=1).reshape(-1)


@functools.lru_cache(maxsize=16)
def _gather_index_f32(entries: tuple, total: int, device) -> torch.Tensor:
    """Where each element of an fp32 wgmma image's stages (before the hi /
    lo split) comes from in a flat source buffer, or its zero slot
    ``total``: per entry (a, b, base, sk, sn) the matrix M (a x b,
    input-major) with M[k, n] at base + k * sk + n * sn, in
    ``pack_walk_wgmma_f32``'s layout (per matrix ceil(b / 64) passes of
    ceil(a / 32) stages of 64 output rows x 32 along k, 16-byte groups
    XOR-swizzled by row % 8, each 8-deep k group permuted)."""
    parts = []
    n = torch.arange(64).view(64, 1)
    pos = torch.arange(32).view(1, 32)            # 4-byte slot in the row
    kk = ((pos // 4) ^ (n % 8)) * 4 + pos % 4     # logical k in the chunk
    lk = kk % 8
    phys = kk - lk + torch.where(lk < 4, 2 * lk, 2 * (lk - 4) + 1)
    for a, b, base, sk, sn in entries:
        for p in range(-(-b // 64)):
            for c in range(-(-a // 32)):
                k, col = 32 * c + phys, 64 * p + n
                parts.append(torch.where((k < a) & (col < b),
                                         base + k * sk + col * sn,
                                         torch.full_like(k, total))
                             .reshape(-1))
    return torch.cat(parts).to(device)


_WG_TILE = 128          # rows (rays, tokens) a tile of the bf16 wgmma kernels
_WG_PART_ROWS = 8       # their backwards' partial-sum rows a block: a warp's
_WG_GRID = 132          # their persistent grid at most: an H100's SMs


def wgmma_grid(T: int) -> int:
    """Blocks of a bf16 wgmma walk kernel on T rows (rays, tokens): one an
    SM, at most one a 128-row tile."""
    return min(_WG_GRID, -(-T // _WG_TILE))


def check_pe_pairs(walk: Walk, what: str) -> None:
    """The bf16 backwards take a posenc column's derivative from its
    partner in the saved encoding (sin then cos of one source and frequency,
    adjacent, as ``posenc_plan`` / ``rec_pe_plan`` lay them out)."""
    cols = [(int(a), float(f), int(k)) for a, f, k in walk.cols]
    for c, (src, f, kind) in enumerate(cols):
        mate = c + 1 if kind == 1 else c - 1
        if kind and not (0 <= mate < len(cols)
                         and cols[mate] == (src, f, 3 - kind)):
            raise NotImplementedError(
                f"{what}: posenc column {c} has no sin / cos partner beside "
                "it")


@functools.lru_cache(maxsize=16)
def _gather_index(entries: tuple, total: int, device) -> torch.Tensor:
    """Where each element of a wgmma weight image comes from in a flat source
    buffer, or its zero slot ``total``: per entry (a, b, base, sk, sn) the
    matrix M (a x b, input-major) with M[k, n] at base + k * sk + n * sn,
    in ceil(a / 64) chunks of ``wgmma_tile_n(b)`` rows of 64 along k, each
    row's 16-byte groups XOR-swizzled by row % 8 (the 128-byte swizzle)."""
    parts = []
    for a, b, base, sk, sn in entries:
        ni, nch = wgmma_tile_n(b), -(-a // 64)
        c = torch.arange(nch).view(nch, 1, 1, 1)
        n = torch.arange(ni).view(1, ni, 1, 1)
        p = torch.arange(8).view(1, 1, 8, 1)
        e = torch.arange(8).view(1, 1, 1, 8)
        k = c * 64 + (p ^ (n % 8)) * 8 + e
        src = torch.where((k < a) & (n < b), base + k * sk + n * sn,
                          torch.full_like(k, total))
        parts.append(src.reshape(-1))
    return torch.cat(parts).to(device)


@functools.lru_cache(maxsize=16)
def _zero(device, dtype) -> torch.Tensor:
    return torch.zeros(1, dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _embed_layout(dims: tuple, has_li: bool, has_lo: bool, backward: bool,
                  device, f32: bool = False) -> tuple:
    """What the embedder kernels' packs take from a walk of widths ``dims``
    (encoding, then each layer's output), a function of the widths alone:
    the padded widths pd, the tail of the meta row (pd, ``pack_walk``'s
    weight and bias offsets), the gather index of the weight image
    (``f32``: the fp32 form's stages before their hi / lo split) from the
    weights concatenated as stored (W_i^T, output-major: nn/mlp.py's
    layout) -- the forward layers, then with ``backward`` W_l^T for
    l = n-1 .. 0 from the same values -- and the gather index of the bias
    rows then the LayerNorm table (``pack_walk``'s layouts) from the biases
    then the LayerNorms' (a, b) that exist, concatenated."""
    n = len(dims) - 1
    pd = [round_up(d, _ALIGN) for d in dims]
    bases, o = [], 0
    for i in range(n):
        bases.append(o)
        o += dims[i] * dims[i + 1]
    ents = [(dims[i], dims[i + 1], bases[i], 1, dims[i]) for i in range(n)]
    if backward:
        ents += [(dims[l + 1], dims[l], bases[l], dims[l], 1)
                 for l in reversed(range(n))]
    widx = (_gather_index_f32 if f32 else _gather_index)(tuple(ents), o,
                                                          device)
    n_src = sum(dims[1:]) + 2 * (dims[0] * has_li + dims[-1] * has_lo)
    bsrc, o = [], 0

    def rows(width, d, present):
        nonlocal o
        c = torch.arange(width)
        if not present:
            return torch.full_like(c, n_src)
        out = torch.where(c < d, o + c, torch.full_like(c, n_src))
        o += d
        return out

    for i in range(n):
        bsrc.append(rows(pd[i + 1], dims[i + 1], True))
    for present, width, d in ((has_li, pd[0], dims[0]),
                              (has_lo, pd[-1], dims[-1])):
        bsrc += [rows(width, d, present), rows(width, d, present)]
    w_off, b_off, wo, bo = [], [], 0, 0
    for i in range(n):
        w_off.append(wo)
        b_off.append(bo)
        wo += pd[i] * pd[i + 1]
        bo += pd[i + 1]
    return (pd, pd + w_off + b_off, widx, torch.cat(bsrc).to(device),
            sum(pd[1:]))


def pack_embed_wgmma(walk: Walk, device, backward: bool = False,
                     cdt: torch.dtype = torch.bfloat16) -> tuple:
    """The embedder kernels' operands (``csrc/fused_mlp.cu`` /
    ``fused_mlp_bwd.cu`` on ``walk_wgmma.cuh``): (meta, b_all, ln, plan,
    wpack, pd) with ``pack_walk``'s meta row, bias rows, LayerNorm table and
    plan rows, and the weight image of the forward layers, then with
    ``backward`` W_l^T for l = n-1 .. 0: bf16 in ``pack_walk_wgmma``'s
    layout, or (``cdt`` fp32) hi / lo stages in ``pack_walk_wgmma_f32``'s.
    Packed on every call (training rewrites the weights in place; see
    ``pack_walk``), in a fixed handful of device operations whatever the
    depth: one concatenation and one gather each for the weights (fp32:
    then one hi / lo split) and for the biases with the LayerNorms; the
    plan rows are cached on the device."""
    f32 = cdt == torch.float32
    dims = (len(walk.cols),) + tuple(int(w.shape[1]) for w in walk.ws)
    device = torch.device(device)
    lns = [t for ln in (walk.ln_in, walk.ln_out) if ln is not None for t in ln]
    pd, tail, widx, bidx, nb = _embed_layout(
        dims, walk.ln_in is not None, walk.ln_out is not None, backward,
        device, f32)
    flat = torch.cat([w.T.reshape(-1) for w in walk.ws]
                     + [_zero(device, walk.ws[0].dtype)])
    if f32:
        wpack = split_tf32_stages(flat.float().index_select(0, widx))
    else:
        wpack = flat.to(torch.bfloat16).index_select(0, widx)
    vec = torch.cat([b.reshape(-1).float() for b in walk.bs]
                    + [t.reshape(-1).float() for t in lns]
                    + [_zero(device, torch.float32)]).index_select(0, bidx)
    meta = [len(walk.ws), dims[0], dims[-1], _ACT_CODES[walk.act],
            _ACT_CODES[walk.last_act], int(walk.ln_in is not None),
            int(walk.ln_out is not None)] + tail
    return (meta, vec[:nb], vec[nb:], _plan_rows(walk.cols, pd[0], device),
            wpack, pd)


def pack_walk_q(quant: WalkQuant, pd, device) -> tuple:
    """Kernel layout of a quantized walk (``csrc/walk.cuh WalkQuant``): the
    int8 weights OUTPUT-major, W_i^T zero-padded to (pd[i+1], pd[i]), in one
    buffer at ``pack_walk``'s weight offsets (the tensor cores read both
    operands along the reduction axis); the inverse activation scales as
    rows of pd[i]; the dequantization scales as rows of pd[i+1] at
    ``pack_walk``'s bias offsets. Padding is zero: a pad column quantizes to
    0 and a pad channel comes out as its (zero) bias."""
    wparts, iparts, dparts = [], [], []
    for i, (w, inv, dq) in enumerate(zip(quant.wq, quant.inv, quant.dq)):
        wt = torch.zeros(pd[i + 1], pd[i], dtype=torch.int8, device=device)
        wt[:w.shape[1], :w.shape[0]] = w.T.to(device=device, dtype=torch.int8)
        ip = torch.zeros(pd[i], dtype=torch.float32, device=device)
        ip[:inv.shape[0]] = inv.to(device=device, dtype=torch.float32)
        dp = torch.zeros(pd[i + 1], dtype=torch.float32, device=device)
        dp[:dq.shape[0]] = dq.to(device=device, dtype=torch.float32)
        wparts.append(wt.reshape(-1))
        iparts.append(ip)
        dparts.append(dp)
    return torch.cat(wparts), torch.cat(iparts), torch.cat(dparts)


def source_segments(cols, nsrc: int, device) -> torch.Tensor:
    """int32 [start_0..start_{nsrc-1}, end_0..end_{nsrc-1}]: the encoded
    columns of each raw source, contiguous in the posenc layout (the
    backward kernels sum a source's gradient over its segment). Cached on
    the device (read only): no host-to-device copy a call."""
    return _segments(tuple(tuple(c) for c in cols), nsrc, torch.device(device))


@functools.lru_cache(maxsize=64)
def _segments(cols, nsrc: int, device) -> torch.Tensor:
    start, end = [0] * nsrc, [0] * nsrc
    for c, (src, _, _) in enumerate(cols):
        src = int(src)
        if end[src] == 0:
            start[src] = c
        elif end[src] != c:
            raise ValueError(f"posenc source {src} is not contiguous")
        end[src] = c + 1
    return torch.tensor(start + end, dtype=torch.int32, device=device)


def walk_tensors(walk: Walk) -> list:
    """The walk's parameter tensors: weights, biases, then the LayerNorms'
    (a, b) pairs that exist."""
    return (list(walk.ws) + list(walk.bs)
            + [t for ln in (walk.ln_in, walk.ln_out) if ln is not None
               for t in ln])


def walk_with(walk: Walk, tensors) -> Walk:
    """``walk`` with its parameter tensors replaced (``walk_tensors`` order)."""
    n = len(walk.ws)
    rest = list(tensors[2 * n:])
    ln_in = ln_out = None
    if walk.ln_in is not None:
        ln_in, rest = (rest[0], rest[1]), rest[2:]
    if walk.ln_out is not None:
        ln_out = (rest[0], rest[1])
    return walk._replace(ws=tuple(tensors[:n]), bs=tuple(tensors[n:2 * n]),
                         ln_in=ln_in, ln_out=ln_out)


class BwdBuffers:
    """Device buffers of one walk backward launch (``csrc/walk_bwd.cuh``):
    the stash in the compute dtype (one (N, width) matrix per layer input
    and per layer output gradient, plus a caller's head layer; fp32 for the
    fp32 walk, twice the bytes), the per-block partial-sum rows (biases,
    LayerNorms, then ``extra`` columns) and the per-block fp32 scratch.
    ``reduce`` runs the wgrad / colsum kernels afterwards. ``nblk`` is the
    number of partial rows; ``scratch`` the scratch floats, by default the
    WMMA walk's (nblk, 64 * (pd[0] + pd[-1]))."""

    def __init__(self, pd, N: int, nblk: int, device, head=None,
                 extra: int = 0, cdt: torch.dtype = torch.bfloat16,
                 scratch: int | None = None):
        self.pd, self.N, self.nblk, self.dev = list(pd), N, nblk, device
        self.cdt = cdt
        n = len(pd) - 1
        self.hs_w = self.pd[:n] + ([head[0]] if head else [])
        self.dz_w = self.pd[1:] + ([head[1]] if head else [])
        offs, o = [], 0
        for w in self.hs_w + self.dz_w:
            offs.append(o)
            o += N * w
        self.offs = offs
        self.stash = torch.empty(o, dtype=cdt, device=device)
        self.off_arg = (ctypes.c_longlong * len(offs))(*offs)
        self.bias_len = sum(self.pd[1:])
        self.extra_off = self.bias_len + 2 * self.pd[0] + 2 * self.pd[-1]
        self.part_w = self.extra_off + extra
        self.part = torch.zeros(nblk, self.part_w, dtype=torch.float32,
                                device=device)
        if scratch is None:
            scratch = nblk * 64 * (self.pd[0] + self.pd[-1])
        self.scratch = torch.empty(scratch, dtype=torch.float32,
                                   device=device)

    def reduce(self, lib, stream):
        """-> (dW per stashed layer as (hs width, dz width) fp32, the
        reduced partial row)."""
        from ..kernels import build
        m = len(self.hs_w)
        base, esz = self.stash.data_ptr(), self.stash.element_size()
        dws = [wgrad(lib, base + esz * self.offs[i],
                     base + esz * self.offs[m + i], self.N, self.hs_w[i],
                     self.dz_w[i], self.dev, stream, self.cdt)
               for i in range(m)]
        psum = torch.empty(self.part_w, dtype=torch.float32, device=self.dev)
        build.check(lib.papr_colsum(self.part.data_ptr(), self.nblk,
                                    self.part_w, psum.data_ptr(), stream),
                    "papr_colsum")
        return dws, psum

    def walk_grads(self, walk: Walk, dws, psum) -> list:
        """Gradients in ``walk_tensors`` order from the reduced buffers."""
        pd, n = self.pd, len(walk.ws)
        dims = [int(walk.ws[0].shape[0])] + [int(w.shape[1]) for w in walk.ws]
        out = [dws[i][:dims[i], :dims[i + 1]] for i in range(n)]
        o = 0
        for i in range(n):
            out.append(psum[o:o + dims[i + 1]])
            o += pd[i + 1]
        L = self.bias_len
        if walk.ln_in is not None:
            out += [psum[L:L + dims[0]], psum[L + pd[0]:L + pd[0] + dims[0]]]
        if walk.ln_out is not None:
            lo = L + 2 * pd[0]
            out += [psum[lo:lo + dims[-1]],
                    psum[lo + pd[-1]:lo + pd[-1] + dims[-1]]]
        return out


def bwd_wgmma_buffers(walk: Walk, pd, K: int, T: int, dev, head=None,
                      extra: int = 0,
                      cdt: torch.dtype = torch.bfloat16) -> BwdBuffers:
    """``BwdBuffers`` of a backward on wgmma over K x T rows (the streams: K
    tokens a ray; the embedder: K = 1): the stash in ``cdt`` (bf16, or fp32
    for the fp32 stream backwards) with rows k * Tp + t (T padded to the
    128-row tile), one partial row a warp (8 a block), and a scratch slice a
    warpgroup: its 64 rows of the fp32 encoding and, with an output
    LayerNorm, its fp32 input (128 x 128 floats)."""
    grid = wgmma_grid(T)
    per_wg = 64 * pd[0] + (128 * 128 if walk.ln_out is not None else 0)
    return BwdBuffers(pd, K * -(-T // _WG_TILE) * _WG_TILE,
                      _WG_PART_ROWS * grid, dev, head=head, extra=extra,
                      cdt=cdt, scratch=2 * grid * per_wg)


def wgrad_splits(N: int, da: int, db: int, f32: bool) -> int:
    """Token ranges of one ``wgrad`` launch (``csrc/wgrad.cu``): enough
    blocks of (128 rows, tile_n columns) x range for one per SM of an H100
    (132), each range at least eight stages of tokens."""
    tile_n = 64 if db <= 64 else (128 if f32 or db <= 128 else 256)
    tiles = -(-da // 128) * -(-db // tile_n)
    return max(1, min(-(-132 // tiles), -(-N // (8 * (32 if f32 else 64)))))


def wgrad(lib, h_ptr: int, dz_ptr: int, N: int, da: int, db: int, dev,
          stream, cdt: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dW (da, db) fp32 = H^T DZ for row-major H (N, da), DZ (N, db) of
    ``cdt`` (bf16, or fp32 with 3xTF32 products) at the given device
    addresses (``csrc/wgrad.cu``: wgmma on TMA-fed tiles, split-K partials
    summed in a fixed order)."""
    from ..kernels import build
    f32 = cdt == torch.float32
    splits = wgrad_splits(N, da, db, f32)
    tmp = torch.empty(splits * da * db, dtype=torch.float32, device=dev)
    out = torch.empty(da, db, dtype=torch.float32, device=dev)
    name = "papr_wgrad_f32" if f32 else "papr_wgrad"
    build.check(getattr(lib, name)(h_ptr, dz_ptr, N, da, db, splits,
                                   tmp.data_ptr(), out.data_ptr(), stream),
                name)
    if f32:
        wgrad_f32.launches += 1
    else:
        wgrad.launches += 1
    return out


wgrad.launches = 0


def wgrad_f32(lib, h_ptr: int, dz_ptr: int, N: int, da: int, db: int, dev,
              stream) -> torch.Tensor:
    """``wgrad`` on fp32 operands (``papr_wgrad_f32``); ``launches`` counts
    that kernel's launches."""
    return wgrad(lib, h_ptr, dz_ptr, N, da, db, dev, stream, torch.float32)


wgrad_f32.launches = 0


def c_ints(vals) -> ctypes.Array:
    return (ctypes.c_int * len(vals))(*[int(v) for v in vals])


def check_walk_for_kernel(walk: Walk, cdt: torch.dtype, what: str) -> None:
    """What the CUDA walk takes: bf16 or fp32 compute (every walk kernel has
    both forms); relu/none; widths <= 256."""
    if cdt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{what}: compute dtype {cdt} (the CUDA "
                                  "walks run bf16 or fp32)")
    if walk.act not in _ACT_CODES or walk.last_act not in _ACT_CODES:
        raise NotImplementedError(f"{what}: activation {walk.act}/"
                                  f"{walk.last_act}")
    if len(walk.ws) > 12 or any(max(w.shape) > 256 for w in walk.ws):
        raise NotImplementedError(f"{what}: walks up to 12 layers of "
                                  "width <= 256")


# ------------------------------------------------------------ fused_mlp ----

def fused_mlp_plain(x: torch.Tensor, walk: Walk, cdt: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the fused embedder: (R, d_raw) -> (R, d_out)
    in ``cdt``."""
    fused_mlp_plain.calls += 1
    return walk_plain(encode_plain(x, walk.cols), walk, cdt).to(cdt)


fused_mlp_plain.calls = 0


def fused_mlp(x: torch.Tensor, walk: Walk, cdt: torch.dtype) -> torch.Tensor:
    """Fused embedder forward, (R, d_raw) fp32 raw features -> (R, d_out)
    in ``cdt``: the CUDA kernel on wgmma for a CUDA tensor (bf16:
    ``papr_fused_mlp_fwd``; fp32: ``papr_fused_mlp_f32_fwd``), the plain
    version for a CPU tensor."""
    if not x.is_cuda:
        return fused_mlp_plain(x, walk, cdt)
    from ..kernels import build

    check_walk_for_kernel(walk, cdt, "fused_mlp")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"fused_mlp takes (R, d_raw) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    R, d_raw = x.shape
    if max(c[0] for c in walk.cols) >= d_raw:
        raise ValueError("posenc plan reads past the raw features")
    d_out = int(walk.ws[-1].shape[1])
    y = torch.empty(R, d_out, dtype=cdt, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    f32 = cdt == torch.float32
    meta, b_all, ln, plan, wpack, _ = pack_embed_wgmma(walk, x.device,
                                                       cdt=cdt)
    name = "papr_fused_mlp_f32_fwd" if f32 else "papr_fused_mlp_fwd"
    # w_all (unread by the wgmma kernels): the packed image's address.
    build.check(getattr(lib, name)(
        x.data_ptr(), R, d_raw, ctypes.cast(c_ints(meta), ctypes.c_void_p),
        wpack.data_ptr(), b_all.data_ptr(), ln.data_ptr(), plan.data_ptr(),
        y.data_ptr(), wpack.data_ptr(),
        wpack.numel() * wpack.element_size(), wgmma_grid(R), stream), name)
    if f32:
        fused_mlp_f32.launches += 1
    else:
        fused_mlp.launches += 1
    return y


fused_mlp.launches = 0


def fused_mlp_f32(x: torch.Tensor, walk: Walk) -> torch.Tensor:
    """``fused_mlp`` on the fp32 walk (the kernel ``fused_mlp_f32``);
    ``launches`` counts that kernel's launches."""
    return fused_mlp(x, walk, torch.float32)


fused_mlp_f32.launches = 0


def fused_mlp_bwd_plain(x: torch.Tensor, dy: torch.Tensor, walk: Walk,
                        cdt: torch.dtype, kernel_grads: bool = False):
    """Plain PyTorch version of the embedder backward: the plain forward
    recomputed under autograd. Returns (dx, [grads in walk_tensors
    order]); ``kernel_grads``: at the TPU kernels' rounding points
    (``_DenseST``) instead of autograd's."""
    fused_mlp_bwd_plain.calls += 1
    leaves = [t.detach().requires_grad_(True)
              for t in [x.float()] + walk_tensors(walk)]
    with torch.enable_grad():
        y = walk_plain(encode_plain(leaves[0], walk.cols),
                       walk_with(walk, leaves[1:]), cdt,
                       kernel_grads=kernel_grads).to(cdt)
        grads = torch.autograd.grad(y, leaves, dy.to(y.dtype),
                                    allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    return grads[0], grads[1:]


fused_mlp_bwd_plain.calls = 0


def embed_bwd_prep(walk: Walk, R: int, d_raw: int, dev,
                   cdt: torch.dtype = torch.bfloat16) -> tuple:
    """What the embedder backward reads besides its inputs: the packed walk
    (``pack_embed_wgmma``, both directions, in ``cdt``'s form), the posenc
    source segments and the ``BwdBuffers`` (a ``cdt`` stash with rows of R
    padded to the 128-row tile, the persistent grid's partial rows and
    scratch) -> (meta, b_all, ln, plan, wpack, seg, buf)."""
    meta, b_all, ln, plan, wpack, pd = pack_embed_wgmma(walk, dev, True, cdt)
    return (meta, b_all, ln, plan, wpack,
            source_segments(walk.cols, d_raw, dev),
            bwd_wgmma_buffers(walk, pd, 1, R, dev, cdt=cdt))


def fused_mlp_bwd(x: torch.Tensor, dy: torch.Tensor, walk: Walk,
                  cdt: torch.dtype):
    """Embedder backward, (R, d_raw) raw features and (R, d_out) output
    gradient -> (dx fp32, [dW, db, dLN in walk_tensors order] fp32): the
    CUDA kernels for a CUDA tensor (on wgmma, bf16: ``papr_fused_mlp_bwd``,
    fp32: ``papr_fused_mlp_f32_bwd``; then ``wgrad`` per layer and
    ``colsum``), the plain version for a CPU tensor. Both kernels take a
    walk whose posenc sin / cos columns sit in adjacent pairs and at most 96
    raw columns; another raises ``NotImplementedError``."""
    if not x.is_cuda:
        return fused_mlp_bwd_plain(x, dy, walk, cdt)
    from ..kernels import build

    check_walk_for_kernel(walk, cdt, "fused_mlp backward")
    x = x.float().contiguous()
    R, d_raw = x.shape
    d_out = int(walk.ws[-1].shape[1])
    if tuple(dy.shape) != (R, d_out) or not dy.is_cuda:
        raise ValueError(f"dy: want ({R}, {d_out}) on the card, got "
                         f"{tuple(dy.shape)} {dy.device}")
    dy = dy.float().contiguous()
    dev = x.device
    dx = torch.empty(R, d_raw, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = cdt == torch.float32
    check_pe_pairs(walk, "fused_mlp backward")
    if d_raw > 96:
        raise NotImplementedError(f"fused_mlp backward: {d_raw} raw columns "
                                  "(the kernel sums up to 96 sources)")
    meta, b_all, ln, plan, wpack, seg, buf = embed_bwd_prep(walk, R, d_raw,
                                                            dev, cdt)
    # w_all / wt_all (unread by the wgmma kernels): the image's address.
    wp = wpack.data_ptr()
    name = "papr_fused_mlp_f32_bwd" if f32 else "papr_fused_mlp_bwd"
    rc = getattr(lib, name)(
        x.data_ptr(), R, d_raw, dy.data_ptr(),
        ctypes.cast(c_ints(meta), ctypes.c_void_p), wp, b_all.data_ptr(),
        ln.data_ptr(), plan.data_ptr(), wp, buf.stash.data_ptr(),
        ctypes.cast(buf.off_arg, ctypes.c_void_p), seg.data_ptr(),
        dx.data_ptr(), buf.part.data_ptr(), buf.part_w,
        buf.scratch.data_ptr(), wp, wpack.numel() * wpack.element_size(),
        wgmma_grid(R), stream)
    build.check(rc, name)
    dws, psum = buf.reduce(lib, stream)
    if f32:
        fused_mlp_bwd_f32.launches += 1
    else:
        fused_mlp_bwd.launches += 1
    return dx, buf.walk_grads(walk, dws, psum)


fused_mlp_bwd.launches = 0


def fused_mlp_bwd_f32(x: torch.Tensor, dy: torch.Tensor, walk: Walk):
    """``fused_mlp_bwd`` on the fp32 walk (the kernel ``fused_mlp_f32_bwd``
    and ``wgrad_f32``); ``launches`` counts that kernel's launches."""
    return fused_mlp_bwd(x, dy, walk, torch.float32)


fused_mlp_bwd_f32.launches = 0


class FusedMLP(torch.autograd.Function):
    """The fused embedder with its backward: forward ``fused_mlp``, backward
    ``fused_mlp_bwd`` (kernels for CUDA tensors, plain versions for CPU
    tensors). Returns dx, and dW / db / dLN for the walk's tensors."""

    @staticmethod
    def forward(ctx, walk, cdt, x, *tensors):
        ctx.walk, ctx.cdt = walk, cdt
        ctx.save_for_backward(x, *tensors)
        return fused_mlp(x, walk_with(walk, tensors), cdt)

    @staticmethod
    def backward(ctx, dy):
        x, *tensors = ctx.saved_tensors
        dx, grads = fused_mlp_bwd(x, dy, walk_with(ctx.walk, tensors),
                                  ctx.cdt)
        return (None, None, dx.to(x.dtype), *grads)


def fused_mlp_apply(x: torch.Tensor, walk: Walk, cdt: torch.dtype):
    """Differentiable fused embedder (R, d_raw) -> (R, d_out) in ``cdt``."""
    return FusedMLP.apply(walk, cdt, x, *walk_tensors(walk))


# ----------------------------------------------------------- integration ----

def feedforward_fusible(ff_cfg) -> bool:
    """True when the config's FFN is a plain dense chain the kernel covers."""
    return (not tuple(ff_cfg.skip_layers)
            and not tuple(ff_cfg.half_layers)
            and not tuple(ff_cfg.get("residual_layers", []))
            and not ff_cfg.use_wn
            and not ff_cfg.residual_ff
                and not ff_cfg.ff_act_trainable
            and ff_cfg.ff_act in ("relu", "none")
            and ff_cfg.ff_last_act in ("relu", "none")
            and float(ff_cfg.ff_act_a) == 1.0
            and float(ff_cfg.ff_act_b) == 1.0)


def ff_lns(params):
    if "innorm" in params:
        return ((params["innorm"]["a"], params["innorm"]["b"]),
                (params["outnorm"]["a"], params["outnorm"]["b"]))
    return None, None


def walk_from_params(params: dict, ff_cfg, cols) -> Walk:
    """A FeedForward's params (nn/mlp.py tree) as a kernel walk."""
    ln_in, ln_out = ff_lns(params)
    return Walk(tuple(l["w"].T for l in params["mlp"]["layers"]),
                tuple(l["bias"] for l in params["mlp"]["layers"]),
                ln_in, ln_out, ff_cfg.ff_act, ff_cfg.ff_last_act, tuple(cols))


def fused_embedder_apply(params, raw_features, extras, Ls, embed_cfg, ff_cfg,
                         policy) -> torch.Tensor:
    """The whole embedder — posenc + [LN] + MLP + [LN] — in one dispatch.

    raw_features: list of (..., d_i) un-encoded features; extras: optional
    list of pass-through features appended after the encoding. The raw
    features stay fp32 into the kernel: the posenc at frequency 2^L is
    phase-sensitive."""
    dims = tuple(int(f.shape[-1]) for f in raw_features)
    extra_dim = int(sum(e.shape[-1] for e in extras)) if extras else 0
    _, cols = posenc_plan(dims, tuple(int(l) for l in Ls),
                          int(embed_cfg.embed_type),
                          float(embed_cfg.pe_factor),
                          float(embed_cfg.pe_mult_factor), extra_dim)
    parts = list(raw_features) + (list(extras) if extras else [])
    x = torch.cat([p.float() for p in parts], dim=-1)
    lead = x.shape[:-1]
    y = fused_mlp_apply(x.reshape(-1, x.shape[-1]),
                        walk_from_params(params, ff_cfg, cols),
                        policy.compute_dtype)
    return y.reshape(*lead, y.shape[-1])
