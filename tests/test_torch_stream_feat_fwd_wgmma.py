"""The host side of the feature stream forwards on wgmma
(``papr_key_stream_feat_fwd`` / ``papr_key_stream_feat_f32_fwd`` launch
``key_feat_fwd_wgmma_kernel`` / ``key_feat_fwd_wgmma_f32_kernel``;
``papr_value_stream_feat_fwd`` / ``papr_value_stream_feat_f32_fwd`` launch
``value_feat_fwd_wgmma_kernel`` / ``value_feat_fwd_wgmma_f32_kernel``;
``csrc/walk_wgmma.cuh`` ``stream_fwd_wg`` with the raw feature rows as its
token source), on the CPU.

- The wrappers of ``ops/stream_feat.py`` reach the wgmma entry points with
  their signature's argument count: the key's WMMA-era arguments before
  the stream / the value's features, attn, walk, normalize and output,
  then (key) the (T, K) masked scores, the packed weights, their size and
  the grid; one launch counted in the compute dtype.
- The value's output starts zeroed (each block adds its rays' sums).
- The image they pass unpacks to the feature walk's layers (``pack_walk``'s
  weights: fp32 hi / lo stages, or bf16 chunks) and then (key) ``w_k``, in
  the order a k step streams them.
- K over 64, fp32 value rows over ``F32_FWD_MAX_ROWS`` and bf16 value rows
  over ``bf16_fwd_max_rows`` are refused before any launch.
- Both forms of each forward take one argument list; the backwards keep
  their WMMA list.

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card). The
plain feature paths are held against JAX by ``tests/test_torch_stream_feat.py``.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops import stream_feat as sf
from test_torch_stream_bwd_wgmma import _walk
from test_torch_wgmma import _card, lib  # noqa: F401
from test_torch_wgmma import _unpack as _unpack_bf16
from test_torch_wgmma_f32 import _stages, _unpack

P, LL = build.P, ctypes.c_longlong
KEY, VALUE = "papr_key_stream_feat", "papr_value_stream_feat"
F32, BF16 = torch.float32, torch.bfloat16


def _f32_bytes(dims):
    """The fp32 image's size (``wg_plan_f32``): per matrix ceil(pd_out / 64)
    passes of ceil(pd_in / 32) 16 KB stages."""
    return sum(math.ceil(a / 32) * math.ceil(b / 64) * 16384 for a, b in dims)


def _pd(walk):
    return [fm.round_up(d, 16)
            for d in [len(walk.cols)] + [int(w.shape[1]) for w in walk.ws]]


def _feat_args(norm, K=6, T=300, dm=40, width=24, key_dims=(64, 80),
               L=2):
    """Raw key features (K, T, 9) and value features (K, T, 6 + 4), qq,
    influence and alive (T, K), the feature walks (posenc_plan's columns,
    as model/papr.py builds them) on tensors that read as CUDA tensors."""
    rng = np.random.default_rng(17 + K + T)
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    dk, kcols = fm.posenc_plan((3, 3, 3), (L, L, L), 1, 2.0, 1.0, 0)
    dv, vcols = fm.posenc_plan((3, 3), (L, L), 1, 2.0, 1.0, 4)
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    kw = card(_walk(rng, kcols, key_dims, norm))
    vw = card(_walk(rng, vcols, (48, width), norm))
    key = (t(rng.normal(size=(K, T, dk))), t(rng.normal(size=(T, dm))), kw,
           t(rng.normal(size=(dm, key_dims[-1]))), t(rng.normal(size=dm)),
           t(rng.normal(size=(T, K))), t(rng.random((T, K)) > 0.2))
    value = (t(rng.normal(size=(K, T, dv))), t(rng.random(size=(T, K + 1))),
             vw)
    return key, value, (K, T, dm)


def _grid(monkeypatch, grid):
    if grid is not None:
        monkeypatch.setattr(fm, "wgmma_grid", lambda T: grid)
    return grid


def _bf16_bytes(dims):
    """The bf16 image's size (``wg_plan``): per matrix ceil(pd_in / 64)
    chunks of ``wgmma_tile_n(pd_out)`` rows of 128 bytes."""
    return sum(math.ceil(a / 64) * fm.wgmma_tile_n(b) * 128 for a, b in dims)


@pytest.mark.parametrize("norm,grid,cdt", [
    pytest.param(True, None, F32, id="True-None"),
    pytest.param(False, None, F32, id="False-None"),
    pytest.param(True, 2, F32, id="True-2"),
    pytest.param(True, None, BF16, id="True-None-bf16"),
    pytest.param(False, 2, BF16, id="False-2-bf16")])
def test_key_feat_fwd_f32_reaches_the_wgmma_entry_point(lib, monkeypatch,
                                                        norm, grid, cdt):
    """One launch counted in the compute dtype; the WMMA-era arguments
    (features, d_raw, T, K, ..., attn, raw), then ss, the image of the walk
    and w_k in the form (fp32 stages, or bf16 chunks; its byte size), the
    grid (``fm.wgmma_grid``, read through the module) and the stream."""
    key, _, (K, T, dm) = _feat_args(norm)
    grid = _grid(monkeypatch, grid)
    f32 = cdt == F32
    n = sf.key_stream_feat_f32_fwd.launches, sf.key_stream_feat_fwd.launches
    attn, raw = sf.key_stream_feat_fwd(*key, "relu", 5.0, cdt)
    assert (sf.key_stream_feat_f32_fwd.launches,
            sf.key_stream_feat_fwd.launches) == (n[0] + f32,
                                                 n[1] + (not f32))
    (name, a), = lib.calls
    assert name == (f"{KEY}_f32_fwd" if f32 else f"{KEY}_fwd")
    assert len(a) == len(build.SIGNATURES[name]) == 26
    assert tuple(a[1:4]) == (9, T, K)
    assert (a[19], a[20]) == (attn.data_ptr(), raw.data_ptr())
    assert a[-5] not in (a[19], a[20])                     # ss of its own
    pd = _pd(key[2])
    dims = list(zip(pd[:-1], pd[1:])) + [(pd[-1], fm.round_up(dm, 16))]
    assert a[-3] == (_f32_bytes(dims) if f32 else _bf16_bytes(dims))
    assert a[-2] == (grid or math.ceil(T / 128)) == fm.wgmma_grid(T)
    assert (attn.shape, raw.shape) == ((T, K + 1), (T, K))


@pytest.mark.parametrize("norm,grid,cdt", [
    pytest.param(True, None, F32, id="True-None"),
    pytest.param(False, 1, F32, id="False-1"),
    pytest.param(True, None, BF16, id="True-None-bf16"),
    pytest.param(False, 1, BF16, id="False-1-bf16")])
def test_value_feat_fwd_f32_reaches_the_wgmma_entry_point(lib, monkeypatch,
                                                          norm, grid, cdt):
    """One launch counted in the compute dtype, the image of the walk in
    its form (fp32 stages, or bf16 chunks), the grid; the output it is
    handed is zero (the kernel adds each block's sums; the stand-in writes
    nothing)."""
    _, value, (K, T, _) = _feat_args(norm)
    grid = _grid(monkeypatch, grid)
    n = (sf.value_stream_feat_f32_fwd.launches,
         sf.value_stream_feat_fwd.launches)
    fused = sf.value_stream_feat_fwd(*value, True, cdt)
    f32 = cdt == F32
    assert (sf.value_stream_feat_f32_fwd.launches,
            sf.value_stream_feat_fwd.launches) == (n[0] + f32,
                                                   n[1] + (not f32))
    (name, a), = lib.calls
    assert name == (f"{VALUE}_f32_fwd" if f32 else f"{VALUE}_fwd")
    assert len(a) == len(build.SIGNATURES[f"{VALUE}_fwd"]) == 16
    assert tuple(a[1:4]) == (10, T, K)
    pd = _pd(value[2])
    dims = list(zip(pd[:-1], pd[1:]))
    assert a[-3] == (_f32_bytes(dims) if f32 else sum(
        math.ceil(p_in / 64) * fm.wgmma_tile_n(p_out) * 128
        for p_in, p_out in dims))
    assert a[-2] == (grid or math.ceil(T / 128))
    assert fused.shape == (T, 24) and fused.dtype == torch.float32
    assert not fused.any() and a[-5] == fused.data_ptr()


@pytest.mark.parametrize("stream,widths", [
    ("key", "narrow"), ("value", "narrow"), ("key", "Caterpillar"),
    ("value", "narrow-bf16"), ("value", "Caterpillar-bf16"),
    ("key", "narrow-bf16"), ("key", "Caterpillar-bf16")])
def test_feat_pack_unpacks_to_the_walk_then_w_k(lib, monkeypatch, stream,
                                                widths):
    """The image the wrapper passes (its pointer) holds, per matrix in
    stream order, hi = tf32(w) and hi + lo = w to fp32 rounding (bf16: the
    bf16 matrix exactly, ``pack_walk_wgmma``'s chunks) of the feature walk's
    layers (``pack_walk``'s, the walk's weight in the corner) and then (key)
    w_k as (d_out, d_model), zero beyond each."""
    bf16 = widths.endswith("-bf16")
    if widths.startswith("Caterpillar"):  # key 81 -> 5 x 256, w_k 256 wide
        key, value, (K, T, dm) = _feat_args(True, K=2, T=10, dm=256,
                                            key_dims=(256,) * 5, L=4)
    else:
        key, value, (K, T, dm) = _feat_args(True)
    packs = []
    pack = "fwd_wgmma_pack" if bf16 else "fwd_wgmma_pack_f32"
    real = getattr(sf, pack)

    def recording(*args, **kwargs):
        packs.append(real(*args, **kwargs))
        return packs[-1]
    monkeypatch.setattr(sf, pack, recording)
    if stream == "key":
        sf.key_stream_feat_fwd(*key, "relu", 5.0, BF16 if bf16 else F32)
        walk, wk = key[2], key[3]
    else:
        sf.value_stream_feat_fwd(*value, True, BF16 if bf16 else F32)
        walk, wk = value[2], None
    (buf,), ((_, a),) = packs, lib.calls
    assert a[-4] == buf.data_ptr()
    assert buf.dtype == (BF16 if bf16 else torch.float32)
    pd = _pd(walk)
    want = []
    for w, (p_in, p_out) in zip(walk.ws, zip(pd[:-1], pd[1:])):
        m = torch.zeros(p_in, p_out)
        m[:w.shape[0], :w.shape[1]] = w
        want.append(m)
    if wk is not None:
        m = torch.zeros(pd[-1], fm.round_up(dm, 16))
        m[:wk.shape[1], :dm] = wk.T
        want.append(m)
    order = [tuple(m.shape) for m in want]
    if bf16:
        assert 2 * buf.numel() == a[-3] == _bf16_bytes(order)
        for got, m in zip(_unpack_bf16(buf, order), want):
            assert torch.equal(got, m.to(BF16))
        return
    assert 4 * buf.numel() == a[-3] == _f32_bytes(order)
    for st, m, (p_in, p_out) in zip(_stages(buf, order), want, order):
        hi, lo, lg, inside = _unpack(st, p_in, p_out)
        assert not lg[~inside].any()
        assert torch.equal(hi, fm.tf32_rna(m))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_more_than_64_slots_are_refused(lib, cdt):
    """K over 64 (the kernels' range): refused in both forms, no launch."""
    key, value, _ = _feat_args(True, K=65, T=20)
    with pytest.raises(NotImplementedError, match="K <= 64"):
        sf.key_stream_feat_fwd(*key, "relu", 5.0, cdt)
    with pytest.raises(NotImplementedError, match="K <= 64"):
        sf.value_stream_feat_fwd(*value, True, cdt)
    assert not lib.calls


@pytest.mark.parametrize("width,refused", [(96, False), (112, True),
                                           (256, True)])
def test_f32_value_rows_over_the_limit_are_refused(lib, width, refused):
    """The fp32 value forward takes value rows up to ``F32_FWD_MAX_ROWS``
    (96) wide and refuses wider ones before any launch; the bf16 form takes
    them up to ``bf16_fwd_max_rows`` of the walk (the shared-memory layout
    of ``fill_stream_fwd_wg`` computed on the host: 206-210 for these
    walks), so 96 and 112 and not 256."""
    _, value, _ = _feat_args(True, width=width)
    if refused:
        with pytest.raises(NotImplementedError, match=f"{width} > 96"):
            sf.value_stream_feat_fwd(*value, True, torch.float32)
        assert not lib.calls
    else:
        sf.value_stream_feat_fwd(*value, True, torch.float32)
        assert [c[0] for c in lib.calls] == [f"{VALUE}_f32_fwd"]
    lib.calls.clear()
    lim = sa.bf16_fwd_max_rows(_pd(value[2]))
    assert 206 <= lim <= 210
    if width > lim:
        with pytest.raises(NotImplementedError, match=f"{width} > {lim}"):
            sf.value_stream_feat_fwd(*value, True, torch.bfloat16)
        assert not lib.calls
    else:
        sf.value_stream_feat_fwd(*value, True, torch.bfloat16)
        assert [c[0] for c in lib.calls] == [f"{VALUE}_fwd"]


def test_bf16_feature_forwards_keep_their_entry_points(lib, monkeypatch):
    """The bf16 key and value forwards reach ``papr_key_stream_feat_fwd`` /
    ``papr_value_stream_feat_fwd`` with the fp32 forms' argument counts
    (their packed image, the image's bytes and the grid before the stream;
    the key's masked scores before those), one call counted as one bf16
    launch each; the key's image unpacks to the walk's layers as bf16
    chunks, then w_k; the backwards keep one WMMA argument list for both
    forms."""
    key, value, (K, T, dm) = _feat_args(True)
    packs = []
    real = sf.fwd_wgmma_pack

    def recording(*args, **kwargs):
        packs.append(real(*args, **kwargs))
        return packs[-1]
    monkeypatch.setattr(sf, "fwd_wgmma_pack", recording)
    n = (sf.key_stream_feat_fwd.launches, sf.value_stream_feat_fwd.launches,
         sf.key_stream_feat_f32_fwd.launches,
         sf.value_stream_feat_f32_fwd.launches)
    attn, raw = sf.key_stream_feat_fwd(*key, "relu", 5.0, torch.bfloat16)
    fused = sf.value_stream_feat_fwd(*value, True, torch.bfloat16)
    assert [c[0] for c in lib.calls] == [f"{KEY}_fwd", f"{VALUE}_fwd"]
    (_, ka), (_, va) = lib.calls
    sig = build.SIGNATURES
    assert (len(ka), len(va)) == (len(sig[f"{KEY}_f32_fwd"]),
                                  len(sig[f"{VALUE}_f32_fwd"])) == (26, 16)
    assert (ka[19], ka[20]) == (attn.data_ptr(), raw.data_ptr())
    assert ka[-2] == va[-2] == math.ceil(T / 128)
    assert va[11] == fused.data_ptr()
    assert (sf.key_stream_feat_fwd.launches, sf.value_stream_feat_fwd.launches,
            sf.key_stream_feat_f32_fwd.launches,
            sf.value_stream_feat_f32_fwd.launches) == (n[0] + 1, n[1] + 1,
                                                       n[2], n[3])
    # The key's image: the walk's layers, then w_k (d_out, d_model), bf16.
    buf = packs[0]
    assert ka[-4] == buf.data_ptr() and buf.dtype == BF16
    walk, wk = key[2], key[3]
    pd = _pd(walk)
    want = []
    for w, (p_in, p_out) in zip(walk.ws, zip(pd[:-1], pd[1:])):
        m = torch.zeros(p_in, p_out)
        m[:w.shape[0], :w.shape[1]] = w
        want.append(m)
    m = torch.zeros(pd[-1], fm.round_up(dm, 16))
    m[:wk.shape[1], :dm] = wk.T
    want.append(m)
    order = [tuple(m.shape) for m in want]
    assert 2 * buf.numel() == ka[-3] == _bf16_bytes(order)
    for got, m in zip(_unpack_bf16(buf, order), want):
        assert torch.equal(got, m.to(BF16))
    assert sig[f"{KEY}_fwd"] == sig[f"{KEY}_f32_fwd"] == (
        [P, build.I, build.I, build.I, P, build.I, build.F, P, P] + [P] * 7
        + [build.I, build.I, build.F, P, P] + [P, P, LL, build.I, P])
    assert sig[f"{VALUE}_fwd"] == sig[f"{VALUE}_f32_fwd"] == (
        [P, build.I, build.I, build.I, P] + [P] * 5 + [build.I, P]
        + [P, LL, build.I, P])
    # The backwards keep one argument list for both forms.
    for stem in (KEY, VALUE):
        assert sig[f"{stem}_f32_bwd"] == sig[f"{stem}_bwd"]
