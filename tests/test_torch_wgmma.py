"""The host side of the wgmma kernels (``csrc/walk_wgmma.cuh`` for the bf16
one-shot eval attention, ``csrc/wgrad.cu``), on the CPU.

- ``pack_walk_wgmma``'s image unpacks exactly to the input-major weights
  ``pack_walk`` packs (an unpacking written independently of the packer),
  follows the weights when they change (nothing stale is cached), and has
  the size the kernel's layer table (``wg_plan``) computes.
- The eval attention wrapper reaches ``papr_attend_eval`` (bf16) and
  ``papr_attend_eval_f32`` with their signatures' argument count, the packed
  weights (``pack_walk_wgmma``, ``pack_walk_wgmma_f32``) and their size.
- ``wgrad`` / ``BwdBuffers.reduce`` reach ``papr_wgrad`` / ``papr_wgrad_f32``
  once per stashed layer, at ``BwdBuffers``' offsets, with the split count
  ``wgrad_splits`` gives and a partial buffer of that many (da, db) tiles.

Wrappers run on CPU tensors that read as CUDA tensors, against a stand-in
library that records each call (nothing runs on a card).
"""

import math
import types

import numpy as np
import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops.fused_mlp import Walk


def _unpack(buf: torch.Tensor, dims) -> list:
    """The K-major swizzled chunks back to (pd_in, pd_out) matrices: element
    (k, n) sits in chunk k // 64, row n, 16-byte group (k % 64 // 8) XOR
    (n % 8), position k % 8."""
    out, o = [], 0
    for a, b in dims:
        ni = fm.wgmma_tile_n(b)
        nch = -(-a // 64)
        img = buf[o:o + nch * ni * 64].reshape(nch, ni, 64)
        o += nch * ni * 64
        k = np.arange(a)[:, None]
        n = np.arange(b)[None, :]
        col = ((k % 64) // 8 ^ (n % 8)) * 8 + k % 8
        out.append(img[k // 64, n, col])
        # Everything the matrix does not cover is zero.
        mask = torch.ones(nch, ni, 64, dtype=torch.bool)
        mask[k // 64, n, col] = False
        assert not img[mask].any()
    assert o == buf.numel()
    return out


def _walk(rng, dims, norm):
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])))
               for i in range(len(dims) - 1))
    bs = tuple(t(rng.normal(size=dims[i + 1]) * 0.1)
               for i in range(len(dims) - 1))
    ln = lambda d: (t(1 + 0.2 * rng.normal(size=d)), t(0.1 * rng.normal(size=d)))
    return Walk(ws, bs, ln(dims[0]) if norm else None,
                ln(dims[-1]) if norm else None, "relu", "none",
                tuple((0, 0.0, 0) for _ in range(dims[0])))


def _layer_mats(w_flat, pd):
    out, o = [], 0
    for a, b in zip(pd[:-1], pd[1:]):
        out.append(w_flat[o:o + a * b].view(a, b))
        o += a * b
    return out


@pytest.mark.parametrize("dims", [
    (117, 256, 256, 256),        # the key walk's widths (posenc 117 -> 128)
    (142, 256, 256, 32),         # the value walk's (142 -> 144, out 32)
    (20, 48, 16),
    (64, 200, 130),
])
def test_pack_walk_wgmma_unpacks_to_pack_walk(dims):
    rng = np.random.default_rng(len(dims) * 7 + dims[0])
    walk = _walk(rng, dims, True)
    _, w, _, _, _, pd = fm.pack_walk(walk, dims[0], "cpu")
    mats = _layer_mats(w, pd)
    buf = fm.pack_walk_wgmma(mats, "cpu")
    assert buf.dtype == torch.bfloat16
    got = _unpack(buf, list(zip(pd[:-1], pd[1:])))
    for g, m in zip(got, mats):
        assert torch.equal(g, m)
    # The size the kernel's layer table computes (wg_plan): ceil(pd_in / 64)
    # chunks of wg_tile_n(pd_out) rows of 128 bytes per layer.
    assert 2 * buf.numel() == sum(
        math.ceil(a / 64) * fm.wgmma_tile_n(b) * 128
        for a, b in zip(pd[:-1], pd[1:]))


def test_pack_walk_wgmma_follows_the_weights():
    """Only the index map is cached: a weight written in place (as the
    optimizer does) shows up in the next pack."""
    rng = np.random.default_rng(5)
    walk = _walk(rng, (40, 64, 32), False)
    pd = fm.pack_walk(walk, 40, "cpu")[5]
    first = fm.pack_walk_wgmma(_layer_mats(fm.pack_walk(walk, 40, "cpu")[1],
                                           pd), "cpu")
    with torch.no_grad():
        walk.ws[1].data[3, 7] += 1.0
    w = fm.pack_walk(walk, 40, "cpu")[1]
    second = fm.pack_walk_wgmma(_layer_mats(w, pd), "cpu")
    assert int((first != second).sum()) == 1
    assert torch.equal(_unpack(second, list(zip(pd[:-1], pd[1:])))[1],
                       _layer_mats(w, pd)[1])


def test_wgmma_tile_n():
    assert [fm.wgmma_tile_n(d) for d in (16, 32, 48, 64, 80, 128, 144, 256)] \
        == [32, 32, 64, 64, 128, 128, 256, 256]


# ---------------------------------------------------- the launch path ----

class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA tensor: a wrapper takes its kernel
    branch with it (nothing runs on a card)."""

    @property
    def is_cuda(self):
        return True


def _card(x):
    return x.as_subclass(_OnCard) if isinstance(x, torch.Tensor) else x


class _Lib:
    """Stands in for the kernel library: each call is recorded with its
    arguments, their count checked against ``build.SIGNATURES``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        sig = build.SIGNATURES[name]

        def launch(*args):
            assert len(args) == len(sig), (name, len(args), len(sig))
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return lib


def _eval_args(cdt):
    rng = np.random.default_rng(11)
    P, T, K, dm = 40, 70, 5, 48
    record = np.zeros((P, 16), np.float32)
    record[:, :5] = rng.normal(size=(P, 5))
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    kcols = sa.rec_pe_plan(True, (2, 2, 2), 1, 2.0, 1.0, 0)
    vcols = sa.rec_pe_plan(False, (2, 2), 1, 2.0, 1.0, 4)
    kw = _walk(rng, (len(kcols), 64, 80), True)._replace(cols=tuple(kcols))
    vw = _walk(rng, (len(vcols), 48, 24), False)._replace(cols=tuple(vcols))
    card_walk = lambda w: fm.walk_with(w, [_card(x) for x in
                                           fm.walk_tensors(w)])
    idx = _card(torch.as_tensor(rng.integers(0, P, size=(T, K)),
                                dtype=torch.int32))
    return (t(record), idx, t(rng.normal(size=(T, 3))),
            t(rng.normal(size=(T, 3))), t(rng.normal(size=(T, dm))),
            card_walk(kw), t(rng.normal(size=(dm, 80))),
            t(rng.normal(size=dm)), card_walk(vw), "relu", 5.0, True, 1e-6,
            cdt), (kw, vw, dm)


def test_attend_eval_bf16_launches_the_wgmma_entry_point(lib):
    args, (kw, vw, dm) = _eval_args(torch.bfloat16)
    n = sa.attend_eval_idx.launches
    sa.attend_eval_idx(*args)
    assert sa.attend_eval_idx.launches == n + 1
    (name, a), = lib.calls
    assert name == "papr_attend_eval"
    # The packed weights and their size close the argument list, in the
    # order the kernel streams them: key layers, w_k, value layers.
    kpd = [fm.round_up(d, 16) for d in
           [len(kw.cols)] + [int(w.shape[1]) for w in kw.ws]]
    vpd = [fm.round_up(d, 16) for d in
           [len(vw.cols)] + [int(w.shape[1]) for w in vw.ws]]
    dims = (list(zip(kpd[:-1], kpd[1:])) + [(kpd[-1], fm.round_up(dm, 16))]
            + list(zip(vpd[:-1], vpd[1:])))
    assert a[-2] == sum(math.ceil(x / 64) * fm.wgmma_tile_n(y) * 128
                        for x, y in dims)


def test_attend_eval_f32_launches_the_wgmma_entry_point(lib):
    args, (kw, vw, dm) = _eval_args(torch.float32)
    n = sa.attend_eval_f32.launches
    sa.attend_eval_idx(*args)
    assert sa.attend_eval_f32.launches == n + 1
    (name, a), = lib.calls
    assert name == "papr_attend_eval_f32"
    # The fp32 image (pack_walk_wgmma_f32) and its size close the argument
    # list: per layer ceil(pd_out / 64) passes of ceil(pd_in / 32) 16 KB
    # stages, in the order the kernel streams them.
    kpd = [fm.round_up(d, 16) for d in
           [len(kw.cols)] + [int(w.shape[1]) for w in kw.ws]]
    vpd = [fm.round_up(d, 16) for d in
           [len(vw.cols)] + [int(w.shape[1]) for w in vw.ws]]
    dims = (list(zip(kpd[:-1], kpd[1:])) + [(kpd[-1], fm.round_up(dm, 16))]
            + list(zip(vpd[:-1], vpd[1:])))
    assert a[-2] == sum(math.ceil(x / 32) * math.ceil(y / 64) * 16384
                        for x, y in dims)


@pytest.mark.parametrize("N,da,db,f32,want", [
    (512_000, 256, 256, False, 66),    # two 128 x 256 tiles per range
    (648_000, 256, 256, True, 33),     # four 128 x 128 tiles per range
    (777, 48, 32, False, 2),           # ranges of at least 8 x 64 tokens
    (777, 48, 32, True, 4),
    (100_000, 256, 32, False, 66),
])
def test_wgrad_splits(N, da, db, f32, want):
    assert fm.wgrad_splits(N, da, db, f32) == want


@pytest.mark.parametrize("cdt,entry", [(torch.bfloat16, "papr_wgrad"),
                                       (torch.float32, "papr_wgrad_f32")])
def test_bwd_buffers_reduce_launches_wgrad_per_layer(lib, cdt, entry):
    pd, N = [128, 256, 32], 3000
    buf = fm.BwdBuffers(pd, N, 4, "cpu", head=(32, 48), cdt=cdt)
    counter = fm.wgrad_f32 if cdt == torch.float32 else fm.wgrad
    n = counter.launches
    dws, psum = buf.reduce(lib, 0)
    calls = [a for name, a in lib.calls if name == entry]
    assert counter.launches == n + 3 and len(calls) == 3
    assert [c[0] for c in lib.calls].count("papr_colsum") == 1
    base, esz = buf.stash.data_ptr(), buf.stash.element_size()
    for i, (h, dz, n_tok, da, db, splits, *_) in enumerate(calls):
        assert (da, db) == (buf.hs_w[i], buf.dz_w[i])
        assert h == base + esz * buf.offs[i]
        assert dz == base + esz * buf.offs[3 + i]
        assert n_tok == N
        assert splits == fm.wgrad_splits(N, da, db, cdt == torch.float32)
        assert tuple(dws[i].shape) == (da, db)
