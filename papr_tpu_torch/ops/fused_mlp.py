"""Fused embedder: posenc -> [LayerNorm] -> dense stack -> [LayerNorm]
(``papr_tpu/ops/fused_mlp.py``, forward only).

``fused_mlp`` is the wrapper of the CUDA kernel in ``csrc/fused_mlp.cu``
(the port of the Pallas ``_fwd_kernel``); ``fused_mlp_plain`` is the same
function in plain PyTorch. A CPU tensor takes the plain version; a CUDA
tensor takes the kernel or raises.

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


def walk_plain(enc: torch.Tensor, walk: Walk, cdt: torch.dtype) -> torch.Tensor:
    """Dense walk on an fp32 encoding; returns the fp32 output (before any
    final cast). Operands are rounded to ``cdt``; products accumulate in
    fp32 (exact fp32 matmul of the rounded operands)."""
    h = ln_rows(enc, *walk.ln_in) if walk.ln_in is not None else enc
    h = h.to(cdt)
    n = len(walk.ws)
    z = None
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        z = h.float() @ w.to(cdt).float() + b.float()
        z = _act(z, walk.last_act if i == n - 1 else walk.act)
        if i < n - 1:
            h = z.to(cdt)
    if walk.ln_out is not None:
        z = ln_rows(z, *walk.ln_out)
    return z


_pack_cache: dict = {}


def pack_walk(walk: Walk, d_enc: int, device) -> tuple:
    """Kernel layout of a walk: widths padded to 16, all weights in one bf16
    buffer and biases in one fp32 buffer (zero padding), the LayerNorm
    tables, the posenc plan rows, and the int meta row ``csrc/walk.cuh``
    reads. Cached on the parameters' identity and version."""
    tensors = list(walk.ws) + list(walk.bs) + [
        t for ln in (walk.ln_in, walk.ln_out) if ln is not None for t in ln]
    key = (tuple((t.data_ptr(), t._version, tuple(t.shape)) for t in tensors),
           walk.cols, walk.act, walk.last_act, d_enc, str(device))
    hit = _pack_cache.get(key)
    if hit is not None:
        return hit
    n = len(walk.ws)
    dims = [d_enc] + [int(w.shape[1]) for w in walk.ws]
    pd = [round_up(d, _ALIGN) for d in dims]
    w_off, b_off, wparts, bparts, wo, bo = [], [], [], [], 0, 0
    for i, (w, b) in enumerate(zip(walk.ws, walk.bs)):
        wp = torch.zeros(pd[i], pd[i + 1], dtype=torch.bfloat16, device=device)
        wp[:dims[i], :dims[i + 1]] = w.to(device=device, dtype=torch.bfloat16)
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
    plan = torch.zeros(3, pd[0], dtype=torch.float32)
    plan[:, :len(walk.cols)] = torch.tensor(walk.cols, dtype=torch.float32).T
    meta = ([n, d_enc, dims[-1], _ACT_CODES[walk.act],
             _ACT_CODES[walk.last_act], int(walk.ln_in is not None),
             int(walk.ln_out is not None)] + pd + w_off + b_off)
    packed = (meta, torch.cat(wparts), torch.cat(bparts), ln,
              plan.reshape(-1).to(device), pd)
    if len(_pack_cache) > 16:
        _pack_cache.clear()
    _pack_cache[key] = packed
    return packed


def c_ints(vals) -> ctypes.Array:
    return (ctypes.c_int * len(vals))(*[int(v) for v in vals])


def check_walk_for_kernel(walk: Walk, cdt: torch.dtype, what: str) -> None:
    """What the CUDA walk takes: bf16 compute, relu/none, widths <= 256."""
    if cdt != torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the CUDA walk runs bf16 compute (use_amp: true); fp32 "
            "walks on the card are ROADMAP.md Queue 2 item 2b. Use "
            "tpu.fused_attn: false for the plain fp32 path.")
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
    meta, w_all, b_all, ln, plan, _ = pack_walk(walk, len(walk.cols), x.device)
    if max(c[0] for c in walk.cols) >= d_raw:
        raise ValueError("posenc plan reads past the raw features")
    d_out = int(walk.ws[-1].shape[1])
    y = torch.empty(R, d_out, dtype=torch.bfloat16, device=x.device)
    lib = build.load()
    rc = lib.papr_fused_mlp_fwd(
        x.data_ptr(), R, d_raw, ctypes.cast(c_ints(meta), ctypes.c_void_p),
        w_all.data_ptr(), b_all.data_ptr(), ln.data_ptr(), plan.data_ptr(),
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "papr_fused_mlp_fwd")
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0


# ----------------------------------------------------------- integration ----

def feedforward_fusible(ff_cfg) -> bool:
    """True when the config's FFN is a plain dense chain the kernel covers."""
    return (not tuple(ff_cfg.skip_layers)
            and not tuple(ff_cfg.half_layers)
            and not tuple(ff_cfg.get("residual_layers", []))
            and not ff_cfg.use_wn
            and not ff_cfg.residual_ff
            and float(ff_cfg.dropout_ff) == 0.0
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
    y = fused_mlp(x.reshape(-1, x.shape[-1]),
                  walk_from_params(params, ff_cfg, cols),
                  policy.compute_dtype)
    return y.reshape(*lead, y.shape[-1])
