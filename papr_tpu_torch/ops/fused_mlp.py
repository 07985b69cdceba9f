"""Fused embedder: posenc -> [LayerNorm] -> dense stack -> [LayerNorm]
(``papr_tpu/ops/fused_mlp.py``), forward and backward.

``fused_mlp`` is the wrapper of the CUDA kernel in ``csrc/fused_mlp.cu``
(the port of the Pallas ``_fwd_kernel``); ``fused_mlp_bwd`` wraps the
backward (``csrc/fused_mlp_bwd.cu`` + the dW reduction in ``csrc/wgrad.cu``,
the port of ``_bwd_kernel``); ``fused_mlp_plain`` / ``fused_mlp_bwd_plain``
are the same functions in plain PyTorch, and ``fused_mlp_apply`` joins the
two directions in an autograd ``Function``. A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises.

The compute dtype picks the kernel, as ``_cdt`` picks the Pallas kernel's
operand type: bf16 (``use_amp: true``) or fp32 (``use_amp: false``: the
``_f32`` entry points, the same walk with fp32 operands and activations and
3xTF32 products, ``csrc/walk.cuh``). ``fused_mlp_f32`` / ``fused_mlp_bwd_f32``
/ ``wgrad_f32`` count the fp32 kernels' launches.

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


def walk_plain(enc: torch.Tensor, walk: Walk, cdt: torch.dtype,
               inputs: list | None = None) -> torch.Tensor:
    """Dense walk on an fp32 encoding; returns the fp32 output (before any
    final cast). Operands are rounded to ``cdt``; products accumulate in
    fp32 (exact fp32 matmul of the rounded operands). With ``inputs`` (a
    list) each dense layer's input, in ``cdt``, is appended to it."""
    h = ln_rows(enc, *walk.ln_in) if walk.ln_in is not None else enc
    h = h.to(cdt)
    n = len(walk.ws)
    z = None
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        if inputs is not None:
            inputs.append(h)
        z = h.float() @ w.to(cdt).float() + b.float()
        z = _act(z, walk.last_act if i == n - 1 else walk.act)
        if i < n - 1:
            h = z.to(cdt)
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


@functools.lru_cache(maxsize=16)
def _wgmma_index(dims: tuple, device) -> torch.Tensor:
    """Where each element of ``pack_walk_wgmma``'s image comes from in the
    matrices' flat concatenation (row-major (pd_in, pd_out) each), or the
    zero slot past its end. The layout is a function of the widths only."""
    total = sum(a * b for a, b in dims)
    parts, base = [], 0
    for a, b in dims:
        ni, nch = wgmma_tile_n(b), -(-a // 64)
        c = torch.arange(nch).view(nch, 1, 1, 1)
        n = torch.arange(ni).view(1, ni, 1, 1)
        p = torch.arange(8).view(1, 1, 8, 1)
        e = torch.arange(8).view(1, 1, 1, 8)
        k = c * 64 + (p ^ (n % 8)) * 8 + e      # the 128-byte swizzle
        src = torch.where((k < a) & (n < b), base + k * b + n,
                          torch.full_like(k, total))
        parts.append(src.reshape(-1))
        base += a * b
    return torch.cat(parts).to(device)


def pack_walk_wgmma(mats, device) -> torch.Tensor:
    """Weights of the bf16 wgmma walk (``csrc/walk_wgmma.cuh``), from the
    input-major (pd_in, pd_out) matrices in the order the kernel streams
    them: per layer, ceil(pd_in / 64) chunks of ``wgmma_tile_n(pd_out)``
    rows of 64 bf16 along the input axis (K-major, zero beyond the
    matrix), each row's 16-byte groups XOR-swizzled by row % 8, so one TMA
    bulk copy lands a chunk in shared memory as wgmma reads it. One gather
    per call (the weights change every training step, so the image is never
    cached; only its index map, which depends on the widths alone)."""
    dims = tuple((int(m.shape[0]), int(m.shape[1])) for m in mats)
    flat = torch.cat([m.reshape(-1).to(device=device, dtype=torch.bfloat16)
                      for m in mats]
                     + [torch.zeros(1, dtype=torch.bfloat16, device=device)])
    return flat[_wgmma_index(dims, torch.device(device))]


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
    backward kernels sum a source's gradient over its segment)."""
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
    in ``cdt``: the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if not x.is_cuda:
        return fused_mlp_plain(x, walk, cdt)
    from ..kernels import build

    check_walk_for_kernel(walk, cdt, "fused_mlp")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"fused_mlp takes (R, d_raw) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    R, d_raw = x.shape
    meta, w_all, b_all, ln, plan, _ = pack_walk(walk, len(walk.cols), x.device,
                                                cdt)
    if max(c[0] for c in walk.cols) >= d_raw:
        raise ValueError("posenc plan reads past the raw features")
    d_out = int(walk.ws[-1].shape[1])
    y = torch.empty(R, d_out, dtype=cdt, device=x.device)
    f32 = cdt == torch.float32
    name = "papr_fused_mlp_f32_fwd" if f32 else "papr_fused_mlp_fwd"
    rc = getattr(build.load(), name)(
        x.data_ptr(), R, d_raw, ctypes.cast(c_ints(meta), ctypes.c_void_p),
        w_all.data_ptr(), b_all.data_ptr(), ln.data_ptr(), plan.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, name)
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
                        cdt: torch.dtype):
    """Plain PyTorch version of the embedder backward: the plain forward
    recomputed under autograd. Returns (dx, [grads in walk_tensors
    order])."""
    fused_mlp_bwd_plain.calls += 1
    leaves = [t.detach().requires_grad_(True)
              for t in [x.float()] + walk_tensors(walk)]
    with torch.enable_grad():
        y = walk_plain(encode_plain(leaves[0], walk.cols),
                       walk_with(walk, leaves[1:]), cdt).to(cdt)
        grads = torch.autograd.grad(y, leaves, dy.to(y.dtype),
                                    allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for g, l in zip(grads, leaves)]
    return grads[0], grads[1:]


fused_mlp_bwd_plain.calls = 0


def fused_mlp_bwd(x: torch.Tensor, dy: torch.Tensor, walk: Walk,
                  cdt: torch.dtype):
    """Embedder backward, (R, d_raw) raw features and (R, d_out) output
    gradient -> (dx fp32, [dW, db, dLN in walk_tensors order] fp32): the
    CUDA kernels (``csrc/fused_mlp_bwd.cu`` + ``csrc/wgrad.cu``) for a CUDA
    tensor, the plain version for a CPU tensor."""
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
    meta, w_all, b_all, ln, plan, pd = pack_walk(walk, len(walk.cols), dev,
                                                 cdt)
    wt_all = pack_walk_t(walk, pd, dev, cdt)
    seg = source_segments(walk.cols, d_raw, dev)
    nblk = -(-R // 64)
    buf = BwdBuffers(pd, nblk * 64, nblk, dev, cdt=cdt)
    dx = torch.empty(R, d_raw, dtype=torch.float32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = cdt == torch.float32
    name = "papr_fused_mlp_f32_bwd" if f32 else "papr_fused_mlp_bwd"
    rc = getattr(lib, name)(
        x.data_ptr(), R, d_raw, dy.data_ptr(),
        ctypes.cast(c_ints(meta), ctypes.c_void_p), w_all.data_ptr(),
        b_all.data_ptr(), ln.data_ptr(), plan.data_ptr(), wt_all.data_ptr(),
        buf.stash.data_ptr(), ctypes.cast(buf.off_arg, ctypes.c_void_p),
        seg.data_ptr(), dx.data_ptr(), buf.part.data_ptr(), buf.part_w,
        buf.scratch.data_ptr(), stream)
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
