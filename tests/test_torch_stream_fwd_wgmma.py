"""The host side of the stream forwards on wgmma (``csrc/walk_wgmma.cuh``:
bf16 ``papr_key_stream_fwd`` / ``papr_value_stream_fwd`` launch
``key_fwd_wgmma_kernel`` / ``value_fwd_wgmma_kernel``, fp32
``papr_key_stream_f32_fwd`` / ``papr_value_stream_f32_fwd`` launch
``key_fwd_wgmma_f32_kernel`` / ``value_fwd_wgmma_f32_kernel``), on the CPU.

- ``fwd_wgmma_pack``'s image unpacks exactly to the walk's weights
  ``pack_walk`` packs and then (key) ``w_k``, in the order a k step streams
  them (an unpacking written independently of the packer), for the
  flagship walks and narrow ones (the fp32 image: ``test_torch_wgmma_f32``).
- The wrappers of both forms reach their entry points with their
  signature's argument count: the int8 forms' arguments before the
  quantization buffers, then the packed weights (bf16 or fp32 image), their
  size and the grid; the value's output starts zeroed (each block adds its
  rays' sums). The int8 and int8-beside-fp32 forwards keep their entry
  points and argument lists.
- Limits the fp32 forms cannot run (value rows over
  ``F32_FWD_MAX_ROWS``, K over 64) raise before any launch.
- The grid helper: one block an SM, at most one a 128-ray tile.

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from test_torch_stream_bwd_wgmma import _walk
from test_torch_wgmma import _card, _unpack, lib  # noqa: F401

P, LL = build.P, ctypes.c_longlong


def _bytes(dims):
    return sum(math.ceil(a / 64) * fm.wgmma_tile_n(b) * 128 for a, b in dims)


def _f32_bytes(dims):
    """The fp32 image's size (``wg_plan_f32``): per matrix ceil(pd_out / 64)
    passes of ceil(pd_in / 32) 16 KB stages."""
    return sum(math.ceil(a / 32) * math.ceil(b / 64) * 16384 for a, b in dims)


def _pd(walk):
    return [fm.round_up(d, 16)
            for d in [len(walk.cols)] + [int(w.shape[1]) for w in walk.ws]]


def _i8_stem(name):
    """The int8 form's arguments before its quantization buffers."""
    return build.SIGNATURES[name.replace("_fwd", "_i8_fwd")][:-4]


@pytest.mark.parametrize("dims,head", [
    ((117, 256, 256, 256, 256, 256), 256),   # the key walk, w_k 256 wide
    ((142, 256, 256, 256, 256, 256, 256, 256, 32), 0),  # the value walk
    ((20, 48, 16), 40),
    ((64, 200, 130), 0),
])
def test_fwd_pack_unpacks_to_the_walk_then_w_k(dims, head):
    rng = np.random.default_rng(sum(dims) + head)
    walk = _walk(rng, [(0, 0.0, 0)] * dims[0], dims[1:], True)
    _, w, _, _, _, pd = fm.pack_walk(walk, dims[0], "cpu", torch.bfloat16)
    wk = ()
    if head:
        wk = (torch.as_tensor(rng.normal(size=(pd[-1], head)),
                              dtype=torch.bfloat16),)
    buf = sa.fwd_wgmma_pack(w, pd, "cpu", wk)
    order = list(zip(pd[:-1], pd[1:])) + [tuple(h.shape) for h in wk]
    got = _unpack(buf, order)
    o = 0
    for i, (a, b) in enumerate(zip(pd[:-1], pd[1:])):
        assert torch.equal(got[i], w[o:o + a * b].view(a, b))
        # pack_walk's layer, the walk's weight in its top-left corner
        n_in, n_out = walk.ws[i].shape
        assert torch.equal(got[i][:n_in, :n_out],
                           walk.ws[i].to(torch.bfloat16))
        o += a * b
    if head:
        assert torch.equal(got[-1], wk[0])
    assert 2 * buf.numel() == _bytes(order)


def _stream_args(norm):
    rng = np.random.default_rng(13)
    K, T, rp, dm = 6, 300, 16, 40
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    kcols = sa.rec_pe_plan(True, (2, 2, 2), 1, 2.0, 1.0, 0)
    vcols = sa.rec_pe_plan(False, (2, 2), 1, 2.0, 1.0, 4)
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    kw = card(_walk(rng, kcols, (64, 80), norm))
    vw = card(_walk(rng, vcols, (48, 24), norm))
    rec = t(rng.normal(size=(K, T, rp)))
    rayo, rays = t(rng.normal(size=(T, 3))), t(rng.normal(size=(T, 3)))
    key = (rec, rayo, rays, t(rng.normal(size=(T, dm))), kw,
           t(rng.normal(size=(dm, 80))), t(rng.normal(size=dm)))
    value = (rec, rayo, rays, t(rng.random(size=(T, K + 1))), vw)
    return key, value, (K, T, dm)


@pytest.mark.parametrize("norm", [True, False])
def test_key_fwd_bf16_reaches_the_wgmma_entry_point(lib, norm):
    key, _, (K, T, dm) = _stream_args(norm)
    n = sa.key_stream_fwd.launches
    attn, raw, ss = sa.key_stream_fwd(*key, "relu", 5.0, 1e-6, torch.bfloat16)
    assert sa.key_stream_fwd.launches == n + 1
    (name, a), = lib.calls
    assert name == "papr_key_stream_fwd"
    # ..., the pack, its bytes, the grid, the stream.
    pd = _pd(key[4])
    dims = list(zip(pd[:-1], pd[1:])) + [(pd[-1], fm.round_up(dm, 16))]
    assert a[-3] == _bytes(dims)
    assert a[-2] == math.ceil(T / 128) == fm.wgmma_grid(T)
    assert len(a) - 4 == len(_i8_stem("papr_key_stream_fwd"))
    assert (attn.shape, raw.shape, ss.shape) == ((T, K + 1), (T, K), (T, K))


@pytest.mark.parametrize("norm", [True, False])
def test_value_fwd_bf16_reaches_the_wgmma_entry_point(lib, norm):
    _, value, (K, T, _) = _stream_args(norm)
    n = sa.value_stream_fwd.launches
    fused = sa.value_stream_fwd(*value, True, 1e-6, torch.bfloat16)
    assert sa.value_stream_fwd.launches == n + 1
    (name, a), = lib.calls
    assert name == "papr_value_stream_fwd"
    pd = _pd(value[4])
    assert a[-3] == _bytes(list(zip(pd[:-1], pd[1:])))
    assert a[-2] == math.ceil(T / 128)
    # The kernel adds each block's sums: the output it is handed is zero
    # (the stand-in writes nothing).
    assert fused.shape == (T, 24) and not fused.any()
    assert a[-5] == fused.data_ptr()


@pytest.mark.parametrize("norm", [True, False])
def test_key_fwd_f32_reaches_the_wgmma_entry_point(lib, norm):
    """The fp32 key forward: one launch counted as fp32, the fp32 image of
    the walk and w_k (its byte size), the persistent grid."""
    key, _, (K, T, dm) = _stream_args(norm)
    n = sa.key_stream_f32_fwd.launches, sa.key_stream_fwd.launches
    attn, raw, ss = sa.key_stream_f32_fwd(*key, "relu", 5.0, 1e-6)
    assert (sa.key_stream_f32_fwd.launches, sa.key_stream_fwd.launches) == (
        n[0] + 1, n[1])
    (name, a), = lib.calls
    assert name == "papr_key_stream_f32_fwd"
    pd = _pd(key[4])
    dims = list(zip(pd[:-1], pd[1:])) + [(pd[-1], fm.round_up(dm, 16))]
    assert a[-3] == _f32_bytes(dims)
    assert a[-2] == math.ceil(T / 128) == fm.wgmma_grid(T)
    assert len(a) - 4 == len(_i8_stem("papr_key_stream_fwd"))
    assert (attn.shape, raw.shape, ss.shape) == ((T, K + 1), (T, K), (T, K))


@pytest.mark.parametrize("norm", [True, False])
def test_value_fwd_f32_reaches_the_wgmma_entry_point(lib, norm):
    _, value, (K, T, _) = _stream_args(norm)
    n = sa.value_stream_f32_fwd.launches, sa.value_stream_fwd.launches
    fused = sa.value_stream_f32_fwd(*value, True, 1e-6)
    assert (sa.value_stream_f32_fwd.launches,
            sa.value_stream_fwd.launches) == (n[0] + 1, n[1])
    (name, a), = lib.calls
    assert name == "papr_value_stream_f32_fwd"
    pd = _pd(value[4])
    assert a[-3] == _f32_bytes(list(zip(pd[:-1], pd[1:])))
    assert a[-2] == math.ceil(T / 128)
    # Zeroed: each block adds its rays' sums (the stand-in writes nothing).
    assert fused.shape == (T, 24) and fused.dtype == torch.float32
    assert not fused.any() and a[-5] == fused.data_ptr()


@pytest.mark.parametrize("cdt,int8,key_entry,value_entry", [
    (torch.float32, False, "papr_key_stream_f32_fwd",
     "papr_value_stream_f32_fwd"),
    (torch.bfloat16, True, "papr_key_stream_i8_fwd",
     "papr_value_stream_i8_fwd"),
    (torch.float32, True, "papr_key_stream_i8_f32_fwd",
     "papr_value_stream_i8_f32_fwd"),
])
def test_fp32_and_int8_forwards_keep_their_entry_points(lib, cdt, int8,
                                                        key_entry,
                                                        value_entry):
    """Each form keeps its entry point and launch counter. The fp32
    forwards take the wgmma tail (fp32 image, its bytes, the grid); the
    int8 forms the same arguments before that tail, then the walk's three
    quantization buffers."""
    key, value, (K, T, _) = _stream_args(True)
    before = sa.key_stream_fwd.launches, sa.value_stream_fwd.launches
    attn = sa.key_stream_fwd(*key, "relu", 5.0, 1e-6, cdt, int8)[0]
    sa.value_stream_fwd(*value[:3], attn, value[4], True, 1e-6, cdt, int8)
    assert [c[0] for c in lib.calls] == [key_entry, value_entry]
    assert (sa.key_stream_fwd.launches,
            sa.value_stream_fwd.launches) == before
    for (name, a), walk in zip(lib.calls, (key[4], value[4])):
        stem = _i8_stem(name.replace("_i8", "").replace("_f32", ""))
        assert len(a) == len(stem) + 4
        if not int8:
            pd = _pd(walk)
            dims = list(zip(pd[:-1], pd[1:]))
            if name.startswith("papr_key"):
                dims.append((pd[-1], 48))
            assert a[-3] == _f32_bytes(dims)
            assert a[-2] == fm.wgmma_grid(T)


@pytest.mark.parametrize("stem", ["papr_key_stream", "papr_value_stream"])
def test_bf16_forward_signatures_name_the_pack_bytes_and_grid(stem):
    """Both forms on wgmma take one signature: the int8 forms' arguments
    before their quantization buffers, then the packed weights, their size
    in bytes, the grid and the stream."""
    bf16 = build.SIGNATURES[f"{stem}_fwd"]
    f32 = build.SIGNATURES[f"{stem}_f32_fwd"]
    i8 = build.SIGNATURES[f"{stem}_i8_fwd"]
    assert bf16 == f32 == i8[:-4] + [P, LL, build.I, P]
    assert build.SIGNATURES[f"{stem}_i8_f32_fwd"] == i8 == i8[:-4] + [P] * 4


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_more_than_64_slots_are_refused(lib, cdt):
    """K over 64 (the kernels' range): refused in both forms, no launch."""
    rng = np.random.default_rng(21)
    key, value, (K, T, dm) = _stream_args(True)
    rec = _card(torch.as_tensor(rng.normal(size=(65, T, 16)),
                                dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="K <= 64"):
        sa.key_stream_fwd(rec, *key[1:], "relu", 5.0, 1e-6, cdt)
    attn = _card(torch.as_tensor(rng.random(size=(T, 66)),
                                 dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="K <= 64"):
        sa.value_stream_fwd(rec, *value[1:3], attn, value[4], True, 1e-6, cdt)
    assert not lib.calls


@pytest.mark.parametrize("width,refused", [(96, False), (112, True),
                                           (256, True)])
def test_f32_value_rows_over_the_limit_are_refused(lib, width, refused):
    """The fp32 value forward takes value rows up to ``F32_FWD_MAX_ROWS``
    (96) wide and refuses wider ones before any launch; the bf16 form and
    the int8 beside fp32 take them."""
    rng = np.random.default_rng(width)
    _, value, (K, T, _) = _stream_args(True)
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    wide = card(_walk(rng, value[4].cols, (48, width), True))
    if refused:
        with pytest.raises(NotImplementedError, match=f"{width} > 96"):
            sa.value_stream_fwd(*value[:4], wide, True, 1e-6, torch.float32)
        assert not lib.calls
    else:
        sa.value_stream_fwd(*value[:4], wide, True, 1e-6, torch.float32)
        assert [c[0] for c in lib.calls] == ["papr_value_stream_f32_fwd"]
    lib.calls.clear()
    sa.value_stream_fwd(*value[:4], wide, True, 1e-6, torch.bfloat16)
    assert [c[0] for c in lib.calls] == ["papr_value_stream_fwd"]


@pytest.mark.parametrize("T,grid", [(25_600, 132), (300, 3), (1, 1),
                                    (16_896, 132), (16_768, 131)])
def test_fwd_wgmma_grid(T, grid):
    """One block an SM of an H100, never more blocks than 128-ray tiles (a
    tile is then split between at most two blocks: at most two sums into a
    ray's fused row, and the key's softmax over scores that two blocks
    wrote)."""
    assert fm.wgmma_grid(T) == grid
