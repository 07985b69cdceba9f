"""The host side of the stream backwards on wgmma
(``csrc/walk_wgmma_bwd.cuh``: bf16 ``papr_key_stream_bwd`` /
``papr_value_stream_bwd``, fp32 ``papr_key_stream_f32_bwd`` /
``papr_value_stream_f32_bwd``), on the CPU.

- ``bwd_wgmma_pack``'s image unpacks exactly to the forward weights
  ``pack_walk`` packs, the head pair, and the transposed weights
  ``pack_walk_t`` packs, in the order a k step streams them (an unpacking
  written independently of the packer); ``bwd_wgmma_pack_f32``'s hi + lo
  to the fp32 weights in the same order.
- The wrappers reach the entry points of both forms with their signature's
  argument count, the packed weights (bf16 or fp32 image), their size, the
  persistent grid and three device buffers last; stash rows (bf16 or fp32)
  for T padded to the 128-ray tile, one partial row a warp (8 a block) and
  the scratch the kernel reads.
- ``BwdBuffers`` of the new kernels: stash offsets as ``reduce`` reads them.
- A posenc without adjacent sin / cos pairs and value rows over 128 are
  refused in both forms.

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card).
"""

import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from test_torch_wgmma import _card, _unpack, lib  # noqa: F401
from test_torch_wgmma_f32 import _stages
from test_torch_wgmma_f32 import _unpack as _unpack_f32


def _walk(rng, cols, dims, norm):
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    dims = [len(cols)] + list(dims)
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])))
               for i in range(len(dims) - 1))
    bs = tuple(t(rng.normal(size=dims[i + 1]) * 0.1)
               for i in range(len(dims) - 1))
    ln = lambda d: (t(1 + 0.2 * rng.normal(size=d)), t(0.1 * rng.normal(size=d)))
    return fm.Walk(ws, bs, ln(dims[0]) if norm else None,
                   ln(dims[-1]) if norm else None, "relu", "none",
                   tuple(cols))


@pytest.mark.parametrize("dims,head", [
    ((117, 256, 256, 256, 256, 256), 256),   # the key walk, w_k 256 wide
    ((142, 256, 256, 256, 32), 0),           # the value walk, out 32
    ((20, 48, 16), 32),
    ((64, 200, 130), 0),
])
def test_bwd_pack_unpacks_to_the_forward_and_transposed_weights(dims, head):
    rng = np.random.default_rng(sum(dims))
    walk = _walk(rng, [(0, 0.0, 0)] * dims[0], dims[1:], True)
    _, w, _, _, _, pd = fm.pack_walk(walk, dims[0], "cpu")
    wt = fm.pack_walk_t(walk, pd, "cpu")
    pair = ()
    if head:
        hf = torch.as_tensor(rng.normal(size=(pd[-1], head)), dtype=torch.bfloat16)
        pair = (hf, hf.T.contiguous())
    buf = sa.bwd_wgmma_pack(w, wt, pd, "cpu", pair)
    n = len(pd) - 1
    fwd = list(zip(pd[:-1], pd[1:]))
    order = fwd + [(h.shape[0], h.shape[1]) for h in pair] \
        + [(b, a) for a, b in reversed(fwd)]
    got = _unpack(buf, order)
    o = 0
    for i, (a, b) in enumerate(fwd):
        assert torch.equal(got[i], w[o:o + a * b].view(a, b))
        o += a * b
    for j, h in enumerate(pair):
        assert torch.equal(got[n + j], h)
    # The reverse walk's W_l^T, l = n-1 .. 0: pack_walk_t's matrices, each
    # the forward matrix transposed.
    offs, o = [], 0
    for a, b in fwd:
        offs.append(o)
        o += a * b
    for j, l in enumerate(range(n - 1, -1, -1)):
        a, b = fwd[l]
        m = got[n + len(pair) + j]
        assert torch.equal(m, wt[offs[l]:offs[l] + a * b].view(b, a))
        assert torch.equal(m, w[offs[l]:offs[l] + a * b].view(a, b).T)
    assert 2 * buf.numel() == sum(math.ceil(a / 64) * fm.wgmma_tile_n(b) * 128
                                  for a, b in order)


@pytest.mark.parametrize("dims,head", [
    ((81, 256, 256, 256, 256, 256), 256),    # Caterpillar's key walk, w_k
    ((118, 256, 256, 256, 32), 0),           # Caterpillar's value walk
    ((20, 48, 16), 32),
])
def test_bwd_pack_f32_unpacks_to_the_forward_and_transposed_weights(dims,
                                                                    head):
    """The fp32 image: per matrix in stream order (forward layers, the head
    pair, W_l^T for l = n-1 .. 0), hi on the TF32 grid and hi + lo equal to
    the fp32 weights to fp32 rounding, zero beyond each matrix, and the size
    ``wg_plan_f32`` computes."""
    rng = np.random.default_rng(sum(dims) + 1)
    walk = _walk(rng, [(0, 0.0, 0)] * dims[0], dims[1:], True)
    f32 = torch.float32
    _, w, _, _, _, pd = fm.pack_walk(walk, dims[0], "cpu", f32)
    wt = fm.pack_walk_t(walk, pd, "cpu", f32)
    pair = ()
    if head:
        hf = torch.as_tensor(rng.normal(size=(pd[-1], head)), dtype=f32)
        pair = (hf, hf.T.contiguous())
    buf = sa.bwd_wgmma_pack_f32(w, wt, pd, "cpu", pair)
    assert buf.dtype == f32
    fwd = list(zip(pd[:-1], pd[1:]))
    order = fwd + [tuple(h.shape) for h in pair] \
        + [(b, a) for a, b in reversed(fwd)]
    offs, o = [], 0
    for a, b in fwd:
        offs.append(o)
        o += a * b
    want = ([w[o:o + a * b].view(a, b) for (a, b), o in zip(fwd, offs)]
            + list(pair)
            + [w[offs[l]:offs[l] + a * b].view(a, b).T
               for l, (a, b) in reversed(list(enumerate(fwd)))])
    # The reverse walk's matrices are pack_walk_t's, the forward transposed.
    for j, l in enumerate(range(len(fwd) - 1, -1, -1)):
        a, b = fwd[l]
        assert torch.equal(want[len(fwd) + len(pair) + j],
                           wt[offs[l]:offs[l] + a * b].view(b, a))
    for st, m, (a, b) in zip(_stages(buf, order), want, order):
        hi, lo, lg, inside = _unpack_f32(st, a, b)
        assert not lg[~inside].any()
        assert torch.equal(hi, fm.tf32_rna(m))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())
    assert 4 * buf.numel() == sum(math.ceil(a / 32) * math.ceil(b / 64)
                                  * 16384 for a, b in order)


def _stream_args(norm):
    rng = np.random.default_rng(3)
    K, T, rp, dm = 5, 300, 16, 40
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    kcols = sa.rec_pe_plan(True, (2, 2, 2), 1, 2.0, 1.0, 0)
    vcols = sa.rec_pe_plan(False, (2, 2), 1, 2.0, 1.0, 4)
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    kw = card(_walk(rng, kcols, (64, 80), norm))
    vw = card(_walk(rng, vcols, (48, 24), norm))
    rec = t(rng.normal(size=(K, T, rp)))
    key = (rec, t(rng.normal(size=(T, 3))), t(rng.normal(size=(T, 3))),
           t(rng.normal(size=(T, dm))), kw, t(rng.normal(size=(dm, 80))),
           t(rng.normal(size=dm)), t(rng.normal(size=(T, K))),
           t(rng.normal(size=(T, K))), t(rng.normal(size=(T, K + 1))))
    value = (rec, key[1], key[2], t(rng.random(size=(T, K + 1))), vw,
             t(rng.normal(size=(T, 24))))
    return key, value, (K, T)


@pytest.mark.parametrize("norm", [True, False])
def test_key_bwd_bf16_reaches_the_wgmma_entry_point(lib, norm):
    key, _, (K, T) = _stream_args(norm)
    n = sa.key_stream_bwd.launches
    sa.key_stream_bwd(*key, "relu", 5.0, 1e-6, torch.bfloat16)
    assert sa.key_stream_bwd.launches == n + 1
    names = [c[0] for c in lib.calls]
    assert names[0] == "papr_key_stream_bwd"
    a = lib.calls[0][1]
    kw = key[4]
    pd = [fm.round_up(d, 16) for d in
          [len(kw.cols)] + [int(w.shape[1]) for w in kw.ws]]
    dims = (list(zip(pd[:-1], pd[1:])) + [(pd[-1], 48), (48, pd[-1])]
            + [(b, a_) for a_, b in reversed(list(zip(pd[:-1], pd[1:])))])
    # ..., the pack, its bytes, the grid, three device buffers, the stream.
    assert a[-6] == sum(math.ceil(x / 64) * fm.wgmma_tile_n(y) * 128
                        for x, y in dims)
    nblk = math.ceil(T / 128)
    assert a[-5] == nblk == fm.wgmma_grid(T)
    # part: 8 rows a block; stash rows for T padded to the 128-ray tile.
    wgrads = [c[1] for c in lib.calls if c[0] == "papr_wgrad"]
    assert len(wgrads) == len(kw.ws) + 1
    assert all(c[2] == K * nblk * 128 for c in wgrads)
    colsum = [c[1] for c in lib.calls if c[0] == "papr_colsum"][0]
    assert colsum[1] == 8 * nblk


@pytest.mark.parametrize("norm", [True, False])
def test_value_bwd_bf16_reaches_the_wgmma_entry_point(lib, norm):
    _, value, (K, T) = _stream_args(norm)
    n = sa.value_stream_bwd.launches
    sa.value_stream_bwd(*value, True, 1e-6, torch.bfloat16)
    assert sa.value_stream_bwd.launches == n + 1
    (name, a), = [c for c in lib.calls if c[0].startswith("papr_value")]
    assert name == "papr_value_stream_bwd"
    vw = value[4]
    pd = [fm.round_up(d, 16) for d in
          [len(vw.cols)] + [int(w.shape[1]) for w in vw.ws]]
    fwd = list(zip(pd[:-1], pd[1:]))
    dims = fwd + [(b, a_) for a_, b in reversed(fwd)]
    assert a[-6] == sum(math.ceil(x / 64) * fm.wgmma_tile_n(y) * 128
                        for x, y in dims)
    assert a[-5] == math.ceil(T / 128)


@pytest.mark.parametrize("T,grid", [(25_600, 132), (300, 3), (1, 1),
                                    (16_896, 132), (16_768, 131)])
def test_bwd_wgmma_grid(T, grid):
    """One block an SM of an H100, never more blocks than 128-ray tiles (a
    block's share of the (tile, k) units is then at least K long, so a tile
    is split between at most two blocks)."""
    assert fm.wgmma_grid(T) == grid


def _f32_image_bytes(dims):
    return sum(math.ceil(a / 32) * math.ceil(b / 64) * 16384 for a, b in dims)


def _pd(walk):
    return [fm.round_up(d, 16) for d in
            [len(walk.cols)] + [int(w.shape[1]) for w in walk.ws]]


def test_fp32_backwards_keep_their_entry_points(lib):
    """The fp32 backwards keep their names and take the wgmma kernels'
    arguments: the fp32 image (``bwd_wgmma_pack_f32``: its byte size), the
    persistent grid and the three device buffers; their stashes are fp32
    (``papr_wgrad_f32`` over the rows of T padded to the 128-ray tile)."""
    key, value, (K, T) = _stream_args(True)
    sa.key_stream_bwd(*key, "relu", 5.0, 1e-6, torch.float32)
    sa.value_stream_bwd(*value, True, 1e-6, torch.float32)
    calls = [c for c in lib.calls if "stream" in c[0]]
    assert [c[0] for c in calls] == ["papr_key_stream_f32_bwd",
                                     "papr_value_stream_f32_bwd"]
    kpd, vpd = _pd(key[4]), _pd(value[4])
    kfwd, vfwd = list(zip(kpd[:-1], kpd[1:])), list(zip(vpd[:-1], vpd[1:]))
    kdims = (kfwd + [(kpd[-1], 48), (48, kpd[-1])]
             + [(b, a) for a, b in reversed(kfwd)])
    vdims = vfwd + [(b, a) for a, b in reversed(vfwd)]
    for (_, a), dims in zip(calls, (kdims, vdims)):
        assert a[-6] == _f32_image_bytes(dims)
        assert a[-5] == fm.wgmma_grid(T)
    wgrads = [c[1] for c in lib.calls if c[0].startswith("papr_wgrad")]
    assert {c[0] for c in lib.calls if c[0].startswith("papr_wgrad")} \
        == {"papr_wgrad_f32"}
    assert len(wgrads) == len(key[4].ws) + 1 + len(value[4].ws)
    assert all(c[2] == K * math.ceil(T / 128) * 128 for c in wgrads)


@pytest.mark.parametrize("norm", [True, False])
def test_key_bwd_f32_reaches_the_wgmma_entry_point(lib, norm):
    """The fp32 key backward: one launch counted, the image of the walk, the
    head pair and the transposed walk in fp32 stages, fp32 stash rows read
    by ``papr_wgrad_f32``, one partial row a warp (8 a block)."""
    key, _, (K, T) = _stream_args(norm)
    n = sa.key_stream_f32_bwd.launches, sa.key_stream_bwd.launches
    sa.key_stream_f32_bwd(*key)
    assert (sa.key_stream_f32_bwd.launches, sa.key_stream_bwd.launches) == (
        n[0] + 1, n[1])
    (name, a), = [c for c in lib.calls if c[0].startswith("papr_key")]
    assert name == "papr_key_stream_f32_bwd"
    pd = _pd(key[4])
    fwd = list(zip(pd[:-1], pd[1:]))
    assert a[-6] == _f32_image_bytes(
        fwd + [(pd[-1], 48), (48, pd[-1])] + [(b, x) for x, b in reversed(fwd)])
    nblk = math.ceil(T / 128)
    assert a[-5] == nblk
    wgrads = [c for c in lib.calls if c[0].startswith("papr_wgrad")]
    assert [c[0] for c in wgrads] == ["papr_wgrad_f32"] * (len(pd) - 1 + 1)
    # (h, dz) widths of each stashed layer, the head's last.
    assert [(c[1][3], c[1][4]) for c in wgrads] == fwd + [(pd[-1], 48)]
    colsum = [c[1] for c in lib.calls if c[0] == "papr_colsum"][0]
    assert colsum[1] == 8 * nblk


@pytest.mark.parametrize("norm", [True, False])
def test_value_bwd_f32_reaches_the_wgmma_entry_point(lib, norm):
    _, value, (K, T) = _stream_args(norm)
    n = sa.value_stream_f32_bwd.launches, sa.value_stream_bwd.launches
    sa.value_stream_f32_bwd(*value, True)
    assert (sa.value_stream_f32_bwd.launches,
            sa.value_stream_bwd.launches) == (n[0] + 1, n[1])
    (name, a), = [c for c in lib.calls if c[0].startswith("papr_value")]
    assert name == "papr_value_stream_f32_bwd"
    pd = _pd(value[4])
    fwd = list(zip(pd[:-1], pd[1:]))
    assert a[-6] == _f32_image_bytes(fwd + [(b, x) for x, b in reversed(fwd)])
    assert a[-5] == math.ceil(T / 128)
    wgrads = [c for c in lib.calls if c[0].startswith("papr_wgrad")]
    assert [c[0] for c in wgrads] == ["papr_wgrad_f32"] * (len(pd) - 1)
    assert all(c[1][2] == K * math.ceil(T / 128) * 128 for c in wgrads)


def test_bwd_buffers_of_the_wgmma_kernels():
    rng = np.random.default_rng(4)
    walk = _walk(rng, [(0, 0.0, 0)] * 20, (48, 16), True)
    pd = [32, 48, 16]
    buf = sa.bwd_wgmma_buffers(walk, pd, 3, 200, "cpu", head=(16, 32),
                               extra=32)
    assert buf.N == 3 * 256 and buf.nblk == 16
    assert buf.part.shape == (16, buf.extra_off + 32)
    assert buf.scratch.numel() == 2 * 2 * (64 * 32 + 128 * 128)
    bare = sa.bwd_wgmma_buffers(walk._replace(ln_out=None), pd, 3, 200, "cpu")
    assert bare.scratch.numel() == 2 * 2 * 64 * 32
    # A patch of 200 tiles: the persistent grid's 132 blocks hold the
    # partial rows and scratch; the stash keeps a row per (k, ray).
    big = sa.bwd_wgmma_buffers(walk, pd, 2, 25_600, "cpu")
    assert big.N == 2 * 25_600 and big.nblk == 8 * 132
    assert big.scratch.numel() == 2 * 132 * (64 * 32 + 128 * 128)
    # The fp32 backwards' buffers: the same rows, an fp32 stash.
    f32 = sa.bwd_wgmma_buffers(walk, pd, 3, 200, "cpu", head=(16, 32),
                               extra=32, cdt=torch.float32)
    assert f32.stash.dtype == torch.float32 and buf.stash.dtype == torch.bfloat16
    assert f32.stash.numel() == buf.stash.numel() and f32.offs == buf.offs
    assert f32.scratch.numel() == buf.scratch.numel()


def test_posenc_without_pairs_is_refused(lib):
    key, value, _ = _stream_args(True)
    kw = key[4]
    cols = list(kw.cols)
    cols[1], cols[2] = cols[2], cols[1]          # cos before its sin
    bad = kw._replace(cols=tuple(cols))
    with pytest.raises(NotImplementedError, match="partner"):
        sa.key_stream_bwd(*key[:4], bad, *key[5:], "relu", 5.0, 1e-6,
                          torch.bfloat16)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_posenc_without_pairs_is_refused_in_both_forms(lib, cdt):
    """The key and the value backward, bf16 and fp32: refused, no kernel
    launched."""
    key, value, _ = _stream_args(True)
    kw = key[4]
    cols = list(kw.cols)
    cols[1], cols[2] = cols[2], cols[1]          # cos before its sin
    bad = kw._replace(cols=tuple(cols))
    with pytest.raises(NotImplementedError, match="partner"):
        sa.key_stream_bwd(*key[:4], bad, *key[5:], "relu", 5.0, 1e-6, cdt)
    vw = value[4]
    bad = vw._replace(cols=tuple(vw.cols[:1] + vw.cols[2:3] + vw.cols[1:2]
                                 + vw.cols[3:]))
    with pytest.raises(NotImplementedError, match="partner"):
        sa.value_stream_bwd(*value[:4], bad, value[5], True, 1e-6, cdt)
    assert not [c for c in lib.calls if "stream" in c[0]]


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_value_rows_over_one_pass_are_refused(lib, cdt):
    """Value rows wider than 128 (one wgmma pass of the bf16 form) are
    refused in both forms, never run on another kernel."""
    rng = np.random.default_rng(9)
    _, value, (K, T) = _stream_args(True)
    vw = value[4]
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    wide = card(_walk(rng, vw.cols, (48, 144), True))
    dfused = _card(torch.as_tensor(rng.normal(size=(T, 144)),
                                   dtype=torch.float32))
    with pytest.raises(NotImplementedError, match="128"):
        sa.value_stream_bwd(*value[:4], wide, dfused, True, 1e-6, cdt)
    assert not [c for c in lib.calls if "stream" in c[0]]
