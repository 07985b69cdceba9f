"""The host side of the int8 form of the wgmma walk (``csrc/walk_wgmma.cuh``,
the int8 one-shot eval attention ``attend_eval_i8`` / ``attend_eval_i8_f32``),
on the CPU.

- ``pack_walk_wgmma_q``'s image, read back by an unpacking written apart
  from the packer (128-deep chunks of ``wgmma_tile_n(pd_out)`` rows of 128
  int8, 16-byte groups XOR-swizzled by row % 8, each 32-deep K group
  permuted), gives ``pack_walk_q``'s int8 weights, zeros beyond each
  matrix, and the size the kernel's layer table (``wg_plan_mixed``)
  computes, for the flagship's key and value walks, Caterpillar's and a
  narrow one.
- A layer's product emulated the way the kernel issues it (a thread's s8 A
  fragment of each k32 block holding its K positions 4 q .. 4 q + 3 and
  16 + 4 q .. of the permuted group; the B rows as packed) equals
  ``int_matmul`` exactly, on quantized inputs that clip at +-127 and hold
  dead columns (inv 0).
- The column map is a bijection on each 32-deep group and agrees with the
  accumulator layout in ``walk_wgmma.cuh``'s header: the bytes ``q8_to_a``
  writes from accumulator columns 8 j + 2 q + e are the K positions the
  next product reads them at.
- The eval attention wrapper with ``int8=True`` reaches
  ``papr_attend_eval_i8`` (bf16 epilogue) and ``papr_attend_eval_i8_f32``
  with their signatures' argument count, the quantization rows, and the
  image (key int8 layers, w_k in the epilogue's form, value int8 layers)
  and its size; a frame's quantization keeps its packs for the frame's
  other tiles.

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
from papr_tpu_torch.ops.fused_mlp import FrameQuant, Walk, WalkQuant


def _pos(x):
    """The input row (of its 32-deep group) at K position x: an s8 A
    fragment's bytes i of positions 4 q + i and 16 + 4 q + i hold the
    accumulator's columns 2 q, 2 q + 1, 2 q + 8, 2 q + 9 (+ 16)."""
    half, q, i = x // 16, x % 16 // 4, x % 4
    return 16 * half + 2 * q + (i % 2) + 8 * (i // 2)


def _quant(rng, dims):
    """A WalkQuant of random int8 weights (+-127 included), inverse scales
    with dead (0) columns, and positive dequantization scales."""
    wq, inv, dq = [], [], []
    for a, b in zip(dims[:-1], dims[1:]):
        w = rng.integers(-127, 128, size=(a, b))
        w[0, 0], w[-1, -1] = 127, -127
        wq.append(torch.as_tensor(w, dtype=torch.int8))
        iv = rng.uniform(0.5, 3.0, size=a).astype(np.float32)
        iv[::7] = 0.0
        inv.append(torch.as_tensor(iv))
        dq.append(torch.as_tensor(rng.uniform(1e-3, 1e-2, size=b)
                                  .astype(np.float32)))
    return WalkQuant(tuple(wq), tuple(inv), tuple(dq))


def _unpack(img, pd):
    """The image back to (pd_in, pd_out) int8 matrices: element (k, n) of
    layer i sits in chunk k // 128, row n, at the byte whose K position x
    (k's place in its 32-deep group, by _pos) XOR-swizzles to 16-byte group
    (x // 16) ^ (n % 8), byte x % 16. Everything else must be zero."""
    out, o = [], 0
    inv_pos = {_pos(x): x for x in range(32)}
    for a, b in zip(pd[:-1], pd[1:]):
        ni, nch = fm.wgmma_tile_n(b), -(-a // 128)
        n_bytes = nch * ni * 128
        chunk = img[o:o + n_bytes].reshape(nch, ni, 128)
        o += n_bytes
        k = np.arange(a)[:, None]
        n = np.arange(b)[None, :]
        x = (k % 128) // 32 * 32 + np.vectorize(inv_pos.get)(k % 32)
        byte = ((x // 16) ^ (n % 8)) * 16 + x % 16
        out.append(chunk[k // 128, n, byte])
        mask = torch.ones(nch, ni, 128, dtype=torch.bool)
        mask[k // 128, n, byte] = False
        assert not chunk[mask].any()
    assert o == img.numel()
    return out


WALKS = {
    "flagship key": [117, 256, 256, 256, 256, 256],
    "flagship value": [142] + [256] * 7 + [32],
    "Caterpillar key": [81, 256, 256, 256, 256, 256],
    "narrow": [20, 48, 16],
}


@pytest.mark.parametrize("dims", list(WALKS.values()), ids=list(WALKS))
def test_pack_walk_wgmma_q_unpacks_to_pack_walk_q(dims):
    rng = np.random.default_rng(sum(dims))
    quant = _quant(rng, dims)
    pd = [fm.round_up(d, 16) for d in dims]
    img = fm.pack_walk_wgmma_q(quant, pd, "cpu")
    assert img.dtype == torch.int8
    # The size the kernel's layer table computes for int8 layers.
    assert img.numel() == sum(math.ceil(a / 128) * fm.wgmma_tile_n(b) * 128
                              for a, b in zip(pd[:-1], pd[1:]))
    wq, inv, dq = fm.pack_walk_q(quant, pd, "cpu")
    o = 0
    for m, a, b in zip(_unpack(img, pd), pd[:-1], pd[1:]):
        assert torch.equal(m, wq[o:o + a * b].view(b, a).T)
        o += a * b
    # The rows the int8 kernels read beside the image are pack_walk_q's.
    rows = fm.quant_rows(quant, pd, "cpu")
    assert torch.equal(rows[0], inv) and torch.equal(rows[1], dq)


def test_pack_walk_wgmma_q_follows_the_weights():
    """Only the index map is cached: a new quantization packs anew."""
    rng = np.random.default_rng(3)
    dims = WALKS["narrow"]
    pd = [fm.round_up(d, 16) for d in dims]
    a, b = _quant(rng, dims), _quant(rng, dims)
    ia, ib = (fm.pack_walk_wgmma_q(q, pd, "cpu") for q in (a, b))
    assert not torch.equal(ia, ib)
    assert torch.equal(_unpack(ib, pd)[0][:20, :48], b.wq[0])


def test_column_map_is_a_bijection_and_matches_the_accumulator_layout():
    """K positions of a 32-deep group <-> input columns: one to one, and
    the same map as the packer's. The epilogue writes accumulator column
    c = 8 j + 2 q + e (acc[4 j + 2 h + e] of thread quad index q, row
    g + 8 h) of k32 block kb = j // 4 into fragment register 4 kb + 2 m + h
    (m = j % 4 // 2), byte 2 x + e (x = j % 2): the K position that byte
    holds, 16 m + 4 q + 2 x + e, reads column c of the block."""
    assert sorted(_pos(x) for x in range(32)) == list(range(32))
    assert [fm.q8_perm(x) for x in range(32)] == [_pos(x) for x in range(32)]
    for q in range(4):
        for j in range(8):               # a 32-deep group: j = 0 .. 3 a block
            for e in range(2):
                c = 8 * j + 2 * q + e
                m, x = j % 4 // 2, j % 2
                pos = 16 * m + 4 * q + 2 * x + e
                assert 32 * (j // 4) + _pos(pos) == c


@pytest.mark.parametrize("dims", [(117, 256), (142, 256), (256, 32),
                                  (48, 16)])
def test_product_from_the_permuted_image_equals_int_matmul(dims):
    """What the kernel computes for 16 rows: per chunk and k32 step, the
    thread's fragment bytes hold the quantized input at the columns of
    their K positions; against the chunk's logical B rows (the image read
    back by K position); summed over the chunks, exactly int_matmul."""
    a, b = dims
    rng = np.random.default_rng(a * b)
    quant = _quant(rng, [a, b])
    pd = [fm.round_up(a, 16), fm.round_up(b, 16)]
    h = torch.as_tensor(rng.normal(size=(16, a)).astype(np.float32)) * 2
    h[0, :] = 1e3                         # clips at +-127
    h[1, :] = -1e3
    qx = fm.quantize_rows(h, quant.inv[0])
    assert qx.abs().max() == 127 and not qx[:, ::7].any()   # dead columns
    img = fm.pack_walk_wgmma_q(quant, pd, "cpu")
    ni, nch = fm.wgmma_tile_n(pd[1]), -(-pd[0] // 128)
    chunk = img.view(nch, ni, 128).long()
    x = torch.arange(128)
    n = torch.arange(ni)[:, None]
    logical = torch.gather(chunk, 2, (((x // 16) ^ (n % 8)) * 16 + x % 16)
                           .expand(nch, ni, 128))         # [c, n, position]
    xpad = torch.zeros(16, nch * 128, dtype=torch.long)
    xpad[:, :a] = qx.long()
    got = torch.zeros(16, ni, dtype=torch.long)
    for c in range(nch):
        for s in range(4):                                # k32 steps
            cols = [128 * c + 32 * s + _pos(p) for p in range(32)]
            frag = xpad[:, cols]                          # A by K position
            got += frag @ logical[c, :, 32 * s:32 * s + 32].T
    want = fm.int_matmul(qx, quant.wq[0].float())
    assert torch.equal(got[:, :b].double(), want.double())
    assert int(got.abs().max()) < 2 ** 24                 # exact as fp32


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


def _walk(rng, dims, norm, cols):
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])))
               for i in range(len(dims) - 1))
    bs = tuple(t(rng.normal(size=dims[i + 1]) * 0.1)
               for i in range(len(dims) - 1))
    ln = lambda d: (t(1 + 0.2 * rng.normal(size=d)), t(0.1 * rng.normal(size=d)))
    return Walk(ws, bs, ln(dims[0]) if norm else None,
                ln(dims[-1]) if norm else None, "relu", "none", tuple(cols))


def _eval_args(cdt):
    rng = np.random.default_rng(12)
    P, T, K, dm = 40, 70, 5, 48
    record = np.zeros((P, 16), np.float32)
    record[:, :5] = rng.normal(size=(P, 5))
    record[:, 4] = 1.0
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    kcols = sa.rec_pe_plan(True, (2, 2, 2), 1, 2.0, 1.0, 0)
    vcols = sa.rec_pe_plan(False, (2, 2), 1, 2.0, 1.0, 4)
    kw = _walk(rng, (len(kcols), 64, 160), True, kcols)
    vw = _walk(rng, (len(vcols), 144, 24), False, vcols)
    card_walk = lambda w: fm.walk_with(w, [_card(x) for x in
                                           fm.walk_tensors(w)])
    idx = _card(torch.as_tensor(rng.integers(0, P, size=(T, K)),
                                dtype=torch.int32))
    return (t(record), idx, t(rng.normal(size=(T, 3))),
            t(rng.normal(size=(T, 3))), t(rng.normal(size=(T, dm))),
            card_walk(kw), t(rng.normal(size=(dm, 160))),
            t(rng.normal(size=dm)), card_walk(vw), "relu", 5.0, True, 1e-6,
            cdt), (kw, vw, dm)


@pytest.mark.parametrize("cdt,entry,counter", [
    (torch.bfloat16, "papr_attend_eval_i8", "attend_eval_i8"),
    (torch.float32, "papr_attend_eval_i8_f32", "attend_eval_i8_f32")])
def test_attend_eval_int8_launches_the_wgmma_entry_point(lib, cdt, entry,
                                                         counter):
    """The image closes the argument list with its size, after the key's
    and the value's quantization rows: the key's int8 layers (128-deep
    chunks), w_k in the epilogue's form (bf16: 64-deep chunks; fp32: 16 KB
    hi / lo stages), the value's int8 layers, each as its own packer makes
    it. A frame's quantization (FrameQuant) keeps the assembled image and
    the rows by compute type: its next tile launches with the same ones."""
    args, (kw, vw, dm) = _eval_args(cdt)
    kpd = [fm.round_up(d, 16) for d in
           [len(kw.cols)] + [int(w.shape[1]) for w in kw.ws]]
    vpd = [fm.round_up(d, 16) for d in
           [len(vw.cols)] + [int(w.shape[1]) for w in vw.ws]]
    rng = np.random.default_rng(5)
    kq = _quant(rng, [len(kw.cols)] + [int(w.shape[1]) for w in kw.ws])
    vq = _quant(rng, [len(vw.cols)] + [int(w.shape[1]) for w in vw.ws])
    fq = FrameQuant((kq, vq))
    counts = (sa.attend_eval_i8.launches, sa.attend_eval_i8_f32.launches,
              sa.attend_eval_idx.launches, sa.attend_eval_f32.launches)
    sa.attend_eval_idx(*args, True, fq)
    sa.attend_eval_idx(*args, True, fq)
    f32 = cdt == torch.float32
    assert (sa.attend_eval_i8.launches, sa.attend_eval_i8_f32.launches,
            sa.attend_eval_idx.launches, sa.attend_eval_f32.launches) == (
        counts[0] + (not f32) * 2, counts[1] + f32 * 2, counts[2], counts[3])
    assert [c[0] for c in lib.calls] == [entry, entry]
    a = lib.calls[0][1]
    kimg = fm.pack_walk_wgmma_q(kq, kpd, "cpu")
    vimg = fm.pack_walk_wgmma_q(vq, vpd, "cpu")
    dm_pad = fm.round_up(dm, 16)
    head_bytes = (math.ceil(kpd[-1] / 32) * math.ceil(dm_pad / 64) * 16384
                  if f32 else
                  math.ceil(kpd[-1] / 64) * fm.wgmma_tile_n(dm_pad) * 128)
    assert a[-2] == kimg.numel() + head_bytes + vimg.numel()
    # The packs the frame keeps: the image and rows the launches read.
    assert list(fq.packs) == [f32]
    img, *rows = fq.packs[f32]
    nk = kimg.numel()
    assert img.dtype == torch.uint8 and img.numel() == a[-2]
    assert torch.equal(img[:nk], kimg.view(torch.uint8))
    assert torch.equal(img[nk + head_bytes:], vimg.view(torch.uint8))
    for got, want in zip(rows, fm.quant_rows(kq, kpd, "cpu")
                         + fm.quant_rows(vq, vpd, "cpu")):
        assert torch.equal(got, want)
    assert list(a[-7:-2]) == [t.data_ptr() for t in (*rows, img)]
    assert list(lib.calls[1][1][-7:-2]) == list(a[-7:-2])
