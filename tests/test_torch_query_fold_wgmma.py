"""The host side of the folded key stream on wgmma (forward, both dtypes:
``papr_key_stream_q_fwd`` / ``papr_key_stream_q_f32_fwd`` launch
``query_head_fwd_wgmma_kernel`` / ``query_head_fwd_wgmma_f32_kernel``, the
embedder walk with ``w_q`` as its head, then key_stream.cu's
``key_fwd_wgmma_kernel`` / ``key_fwd_wgmma_f32_kernel``; the fp32 backward
wrapper calls key_stream.cu's ``papr_key_stream_f32_bwd``,
``key_bwd_wgmma_f32_kernel``, then ``papr_key_stream_q_f32_bwd``,
``query_head_bwd_wgmma_f32_kernel``), on the CPU.

- The wrappers reach the entry points with their signature's argument
  count: forward (both dtypes), the key stream's arguments without w_k,
  rayd, the query walk without w_q, then the key's packed image and its
  byte size, the query's and its byte size, the grid (``fm.wgmma_grid``,
  read through the module); fp32 backward, the key stream's fp32 backward
  (its image, the grid, three zeroed aux buffers), then the query's half on
  the dqq that the key's half summed; one call counted as one launch of
  its dtype.
- The images unpack to the query walk's layers and then ``w_q``, the key
  walk's and then ``w_k`` (forward: bf16 ``pack_walk_wgmma`` chunks, or the
  fp32 hi / lo stages), and for the fp32 backward to the query walk,
  ``w_q^T``'s input-major layer (dqq's way into the reverse walk) and the
  transposed layers.
- The backward's buffers are the wgmma backwards' (``bwd_wgmma_buffers``):
  the key's stash over K x T rows, the query's over T rows, each with its
  head.
- A bad ``rayd``, ``w_q`` against a d_model over 256 and K over 64 are
  refused before any launch.
- The bf16 backward (row 7) keeps its WMMA entry point and argument list.

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card). The
plain folded path is held against JAX by ``tests/test_torch_query_fold.py``.
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
from test_torch_wgmma import _card, lib  # noqa: F401
from test_torch_wgmma import _unpack as _unpack_bf16
from test_torch_wgmma_f32 import _stages, _unpack

P, LL = build.P, ctypes.c_longlong
FWD, BWD = "papr_key_stream_q_f32_fwd", "papr_key_stream_q_f32_bwd"
F32, BF16 = torch.float32, torch.bfloat16


def _f32_bytes(dims):
    """The fp32 image's size (``wg_plan_f32``): per matrix ceil(pd_out / 64)
    passes of ceil(pd_in / 32) 16 KB stages."""
    return sum(math.ceil(a / 32) * math.ceil(b / 64) * 16384 for a, b in dims)


def _img_bytes(dims, cdt):
    """The image's size in the dtype's form: fp32 as above; bf16
    (``wg_plan``) ceil(pd_in / 64) chunks of wgmma_tile_n(pd_out) rows of 128
    bytes per matrix."""
    if cdt == F32:
        return _f32_bytes(dims)
    return sum(math.ceil(a / 64) * fm.wgmma_tile_n(b) * 128 for a, b in dims)


def _pd(walk):
    return [fm.round_up(d, 16)
            for d in [len(walk.cols)] + [int(w.shape[1]) for w in walk.ws]]


def _fold_args(K=6, T=300, dm=40, key_dims=(64, 80), q_dims=(48, 56),
               L=2, qL=3):
    """Records k-major (K, T, 16) with some dead points, rayo / rays / rayd
    (T, 3), the key walk (rec_pe_plan's columns), w_k / b_k, the query walk
    (posenc_plan's columns on the raw ray direction), w_q / b_q, all on
    tensors that read as CUDA tensors."""
    rng = np.random.default_rng(23 + K + T + dm)
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    rec = rng.normal(size=(K, T, 16))
    rec[..., 4] = rng.random((K, T)) > 0.2
    rays = rng.normal(size=(T, 3))
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    card = lambda w: fm.walk_with(w, [_card(x) for x in fm.walk_tensors(w)])
    kw = card(_walk(rng, sa.rec_pe_plan(True, (L, L, L), 1, 2.0, 1.0, 0),
                    key_dims, True))
    qw = card(_walk(rng, fm.posenc_plan((3,), (qL,), 1, 2.0, 1.0, 0)[1],
                    q_dims, True))
    return (t(rec), t(rng.normal(size=(T, 3))), t(rays),
            t(rays * rng.uniform(0.5, 2.0, size=(T, 1))), kw,
            t(rng.normal(size=(dm, key_dims[-1]))), t(rng.normal(size=dm)),
            qw, t(rng.normal(size=(dm, q_dims[-1]))), t(rng.normal(size=dm)))


def _grid(monkeypatch, grid):
    if grid is not None:
        monkeypatch.setattr(fm, "wgmma_grid", lambda T: grid)
    return grid


def _fwd_dims(walk, dm):
    pd = _pd(walk)
    return list(zip(pd[:-1], pd[1:])) + [(pd[-1], fm.round_up(dm, 16))]


def _bwd_dims(walk, head):
    pd = _pd(walk)
    return (list(zip(pd[:-1], pd[1:])) + [tuple(h) for h in head]
            + [(b, a) for a, b in reversed(list(zip(pd[:-1], pd[1:])))])


@pytest.mark.parametrize("dm,grid,cdt", [
    pytest.param(40, None, F32, id="40-None"),
    pytest.param(256, None, F32, id="256-None"),
    pytest.param(40, 2, F32, id="40-2"),
    pytest.param(40, None, BF16, id="40-None-bf16"),
    pytest.param(256, None, BF16, id="256-None-bf16"),
    pytest.param(40, 2, BF16, id="40-2-bf16")])
def test_fwd_f32_reaches_the_wgmma_entry_point(lib, monkeypatch, dm, grid,
                                               cdt):
    """One launch counted in the compute dtype (the other counter unmoved);
    the key stream's arguments without w_k and the query's without w_q (rec,
    rec_w, T, K, ..., attn, raw, ss, qq), then the key's image and its bytes,
    the query's and its bytes (in the dtype's form), the grid, the
    stream."""
    args = _fold_args(dm=dm)
    (K, T, _), kw, qw = args[0].shape, args[4], args[7]
    grid = _grid(monkeypatch, grid)
    n = sa.key_stream_q_f32_fwd.launches, sa.key_stream_q_fwd.launches
    attn, raw, ss, qq = sa.key_stream_q_fwd(*args, "relu", 5.0, 1e-6, cdt)
    f32 = cdt == F32
    assert (sa.key_stream_q_f32_fwd.launches,
            sa.key_stream_q_fwd.launches) == (n[0] + f32, n[1] + (not f32))
    (name, a), = lib.calls
    assert name == (FWD if f32 else "papr_key_stream_q_fwd")
    assert len(a) == len(build.SIGNATURES[FWD]) == 35
    assert tuple(a[1:4]) == (16, T, K) and a[7] == dm
    assert a[21] == fm.round_up(dm, 16)                          # dm_pad
    assert tuple(a[25:29]) == (attn.data_ptr(), raw.data_ptr(),
                               ss.data_ptr(), qq.data_ptr())
    assert a[-5] == _img_bytes(_fwd_dims(kw, dm), cdt)
    assert a[-3] == _img_bytes(_fwd_dims(qw, dm), cdt)
    assert a[-2] == (grid or math.ceil(T / 128)) == fm.wgmma_grid(T)
    assert (attn.shape, raw.shape, ss.shape, qq.shape) == (
        (T, K + 1), (T, K), (T, K), (T, dm))


@pytest.mark.parametrize("dm,grid", [(40, None), (256, 1)])
def test_bwd_f32_reaches_the_wgmma_entry_point(lib, monkeypatch, dm, grid):
    """One launch counted as fp32 (the key stream's counters unmoved): the
    key stream's fp32 backward with its image and bytes, the grid and three
    zeroed aux buffers ((T, dm), (T, 3), (T, 3)), its dW (``wgrad_f32``)
    and colsum; then the query's half (rayd, T, dm, its walk, dm_pad, its
    stash, segments, the key's dqq, d_rayd, partial rows, its image and
    bytes, the grid, the stream) and its dW and colsum; the stashes fp32
    over K x Tp (key) and Tp (query) rows with their heads, one partial row
    a warp."""
    args = _fold_args(dm=dm)
    (K, T, _), kw, qw = args[0].shape, args[4], args[7]
    grid = _grid(monkeypatch, grid)
    qq = _card(torch.ones(T, dm))
    raw, ss = _card(torch.ones(T, K)), _card(torch.ones(T, K))
    dattn = _card(torch.ones(T, K + 1))
    n = (sa.key_stream_q_f32_bwd.launches, sa.key_stream_q_bwd.launches,
         sa.key_stream_f32_bwd.launches, sa.key_stream_bwd.launches)
    seen = []
    real = sa.bwd_wgmma_buffers

    def recording(*a, **k):
        seen.append((a, k, real(*a, **k)))
        return seen[-1][2]
    monkeypatch.setattr(sa, "bwd_wgmma_buffers", recording)
    out = sa.key_stream_q_f32_bwd(*args, qq, raw, ss, dattn, "relu", 5.0)
    assert (sa.key_stream_q_f32_bwd.launches, sa.key_stream_q_bwd.launches,
            sa.key_stream_f32_bwd.launches,
            sa.key_stream_bwd.launches) == (n[0] + 1, n[1], n[2], n[3])
    names = [c[0] for c in lib.calls]
    nk, nq = len(kw.ws), len(qw.ws)
    assert names == (["papr_key_stream_f32_bwd"]
                     + ["papr_wgrad_f32"] * (nk + 1) + ["papr_colsum"]
                     + [BWD] + ["papr_wgrad_f32"] * (nq + 1)
                     + ["papr_colsum"])
    ka, a = lib.calls[0][1], lib.calls[names.index(BWD)][1]
    assert len(a) == len(build.SIGNATURES[BWD]) == 21
    assert (a[1], a[2]) == (T, dm)
    dm_pad = fm.round_up(dm, 16)
    kpd, qpd = _pd(kw), _pd(qw)
    assert ka[-6] == _f32_bytes(_bwd_dims(kw, [(kpd[-1], dm_pad),
                                               (dm_pad, kpd[-1])]))
    assert a[8] == dm_pad
    assert a[-3] == _f32_bytes(_bwd_dims(qw, [(dm_pad, qpd[-1])]))
    assert a[-2] == ka[-5] == (grid or math.ceil(T / 128))
    # The query's buffers are made before the key's half is launched.
    (_, qk, qbuf), (_, kk, kbuf) = seen
    Tp = math.ceil(T / 128) * 128
    assert (kbuf.N, qbuf.N) == (K * Tp, Tp)
    assert kbuf.stash.dtype == qbuf.stash.dtype == torch.float32
    assert (kk["head"], qk["head"]) == ((kpd[-1], dm_pad), (qpd[-1], dm_pad))
    assert kbuf.part.shape[0] == qbuf.part.shape[0] == 8 * fm.wgmma_grid(T)
    assert ka[22] == kbuf.stash.data_ptr() and a[9] == qbuf.stash.data_ptr()
    assert (a[14], a[15]) == (qbuf.part.data_ptr(), qbuf.part_w)
    dqq, drayd = a[12], a[13]
    # The query's half reads the dqq that the key's half summed over k.
    assert dqq == ka[29] and dqq not in ka[-4:-1]
    assert drayd == out[3].data_ptr()
    # The stand-in writes nothing: dqq and the aux buffers are as allocated.
    assert (len(out), out[3].shape, out[6].shape, out[7].shape) == (
        8 + len(fm.walk_tensors(kw)) + len(fm.walk_tensors(qw)), (T, 3),
        (dm, int(qw.ws[-1].shape[1])), (dm,))


@pytest.mark.parametrize("which", ["fwd", "bwd", "fwd-bf16"])
def test_images_unpack_to_the_walks_and_heads(lib, monkeypatch, which):
    """Each image the wrapper passes (its pointer) holds, per matrix in
    stream order, hi = tf32(w) and hi + lo = w to fp32 rounding (bf16: the
    bf16 matrix exactly, ``pack_walk_wgmma``'s chunks): forward, the key
    walk's layers then w_k as (d_out, d_model), the query walk's then w_q as
    (d_q, d_model); backward, the key's (its walk, w_k, w_k^T, W_l^T) and
    the query's (its walk, w_q^T's input-major (d_model, d_q), W_l^T for
    l = n-1 .. 0); zero beyond each matrix."""
    args = _fold_args(dm=40, key_dims=(64, 80), q_dims=(256, 256), qL=4)
    (K, T, _), kw, wk, qw, wq = (args[0].shape, args[4], args[5], args[7],
                                 args[8])
    packs = []
    name = {"fwd": "fwd_wgmma_pack_f32", "bwd": "bwd_wgmma_pack_f32",
            "fwd-bf16": "fwd_wgmma_pack"}[which]
    real = getattr(sa, name)

    def recording(*a, **k):
        packs.append(real(*a, **k))
        return packs[-1]
    monkeypatch.setattr(sa, name, recording)
    if which != "bwd":
        sa.key_stream_q_fwd(*args, "relu", 5.0, 1e-6,
                            BF16 if which == "fwd-bf16" else F32)
        kptr, qptr = -6, -4
    else:
        sa.key_stream_q_f32_bwd(*args, _card(torch.ones(T, 40)),
                                _card(torch.ones(T, K)),
                                _card(torch.ones(T, K)),
                                _card(torch.ones(T, K + 1)), "relu", 5.0)
        kptr, qptr = -7, -4
        packs.reverse()             # the query's image is packed first
    (kbuf, qbuf), a = packs, lib.calls[0][1]
    # Backward: the key's image goes to the key stream's entry point, the
    # query's to the fold's.
    qa = next(c[1] for c in lib.calls if c[0] == {
        "fwd": FWD, "bwd": BWD, "fwd-bf16": "papr_key_stream_q_fwd"}[which])
    assert (a[kptr], qa[qptr]) == (kbuf.data_ptr(), qbuf.data_ptr())
    dm_pad = fm.round_up(40, 16)

    def mats(walk, head, transposed):
        pd = _pd(walk)
        out = []
        for w, (p_in, p_out) in zip(walk.ws, zip(pd[:-1], pd[1:])):
            m = torch.zeros(p_in, p_out)
            m[:w.shape[0], :w.shape[1]] = w
            out.append(m)
        fwd = list(out)
        for h in head:
            m = torch.zeros(*h[0])
            m[:h[1].shape[0], :h[1].shape[1]] = h[1]
            out.append(m)
        if transposed:
            out += [m.T.contiguous() for m in reversed(fwd)]
        return out

    kpd, qpd = _pd(kw), _pd(qw)
    if which != "bwd":
        want_k = mats(kw, [((kpd[-1], dm_pad), wk.T)], False)
        want_q = mats(qw, [((qpd[-1], dm_pad), wq.T)], False)
    else:
        want_k = mats(kw, [((kpd[-1], dm_pad), wk.T), ((dm_pad, kpd[-1]), wk)],
                      True)
        want_q = mats(qw, [((dm_pad, qpd[-1]), wq)], True)
    for buf, want, nbytes in ((kbuf, want_k, a[kptr + 1]),
                              (qbuf, want_q, qa[qptr + 1])):
        order = [tuple(m.shape) for m in want]
        if which == "fwd-bf16":
            assert buf.dtype == BF16
            assert 2 * buf.numel() == nbytes == _img_bytes(order, BF16)
            for got, m in zip(_unpack_bf16(buf, order), want):
                assert torch.equal(got, m.to(BF16))
            continue
        assert buf.dtype == torch.float32
        assert 4 * buf.numel() == nbytes == _f32_bytes(order)
        for st, m, (p_in, p_out) in zip(_stages(buf, order), want, order):
            hi, lo, lg, inside = _unpack(st, p_in, p_out)
            assert not lg[~inside].any()
            assert torch.equal(hi, fm.tf32_rna(m))
            err = ((hi.double() + lo.double()) - m.double()).abs()
            assert bool((err <= 2.0 ** -21 * m.double().abs()).all())


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["rayd", "w_q", "d_model", "K"])
def test_bad_inputs_are_refused_before_any_launch(lib, cdt, case):
    """A rayd not (T, 3), a w_q whose shape does not match d_model and the
    query walk, a d_model over 256 and K over 64 are refused in both
    forms, forward and backward, before anything is launched."""
    if case == "d_model":
        args = list(_fold_args(dm=272))
    else:
        args = list(_fold_args(K=65 if case == "K" else 6, T=40))
    K, T, _ = args[0].shape
    if case == "rayd":
        args[3] = _card(torch.ones(T, 4))
    if case == "w_q":
        args[8] = _card(torch.ones(int(args[5].shape[0]) + 1, 56))
    err = NotImplementedError if case == "K" else ValueError
    with pytest.raises(err):
        sa.key_stream_q_fwd(*args, "relu", 5.0, 1e-6, cdt)
    dm = int(args[5].shape[0])
    with pytest.raises(err):
        sa.key_stream_q_bwd(*args, _card(torch.ones(T, dm)),
                            _card(torch.ones(T, K)), _card(torch.ones(T, K)),
                            _card(torch.ones(T, K + 1)), "relu", 5.0, 1e-6,
                            cdt)
    assert not lib.calls


def test_bf16_folded_key_stream_keeps_its_entry_points(lib):
    """Row 7 in bf16: the forward reaches ``papr_key_stream_q_fwd``, the
    fp32 forward's argument list (the key's image, its bytes, the query's,
    its bytes and the grid after qq), one call counted as one bf16 launch;
    the backward stays on its WMMA kernel: its entry point and its argument
    list (the unpacked walks, w_k / w_q in both layouts, the stashes), then
    its dW reductions."""
    args = _fold_args()
    K, T, _ = args[0].shape
    n = (sa.key_stream_q_fwd.launches, sa.key_stream_q_bwd.launches,
         sa.key_stream_q_f32_fwd.launches, sa.key_stream_q_f32_bwd.launches)
    attn, raw, ss, qq = sa.key_stream_q_fwd(*args, "relu", 5.0, 1e-6, BF16)
    sa.key_stream_q_bwd(*args, qq, raw, ss, _card(torch.ones(T, K + 1)),
                        "relu", 5.0, 1e-6, BF16)
    names = [c[0] for c in lib.calls]
    assert names[0] == "papr_key_stream_q_fwd"
    assert names[1] == "papr_key_stream_q_bwd"
    assert set(names[2:]) == {"papr_wgrad", "papr_colsum"}
    (_, fa), (_, ba) = lib.calls[:2]
    assert (len(fa), len(ba)) == (35, 52)
    assert fa[28] == qq.data_ptr() and fa[25] == attn.data_ptr()
    assert fa[-2] == fm.wgmma_grid(T) and ba[7] == qq.data_ptr()
    assert (sa.key_stream_q_fwd.launches, sa.key_stream_q_bwd.launches,
            sa.key_stream_q_f32_fwd.launches,
            sa.key_stream_q_f32_bwd.launches) == (n[0] + 1, n[1] + 1, n[2],
                                                  n[3])
    sig = build.SIGNATURES
    assert sig["papr_key_stream_q_fwd"] == sig[FWD]
    assert sig["papr_key_stream_q_bwd"] == (
        [P, build.I, build.I, build.I, P, P, P, P, build.I, build.F, P, P, P]
        + [P] * 16 + [build.I, build.I, build.F, build.F] + [P] * 4
        + [P, build.I, P] + [P] * 5 + [P, build.I, P, P, build.I, P, P])
    assert sig[BWD] == [P, build.I, build.I] + [P] * 5 + [build.I] + [P] * 6 + [
        build.I, P, P, LL, build.I, P]
