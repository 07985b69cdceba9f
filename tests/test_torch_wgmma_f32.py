"""The host side of the fp32 form of the wgmma walk (``csrc/walk_wgmma.cuh``,
the fp32 one-shot eval attention), on the CPU.

- ``pack_walk_wgmma_f32``'s image, unpacked by an independent reading of the
  layout the kernel reads (stages of 64 output rows x 32 tf32 along K, hi
  then lo, 16-byte groups XOR-swizzled by row % 8, each 8-deep K group
  permuted), gives hi + lo equal to the fp32 weights to fp32 rounding, hi and
  lo on the TF32 grid, zeros beyond each matrix, and the size the kernel's
  layer table (``wg_plan_f32``) computes.
- ``fwd_wgmma_pack_f32`` (the fp32 stream forwards' image) unpacks to the
  walk's layers as ``pack_walk`` packs them and then ``w_k``, in stream
  order, for the flagship's, Caterpillar's and narrow walks.
- A product emulated the way the kernel issues it (a thread's A fragment
  read as one float2 a row: logical k = q from input column 2 q, q + 4 from
  2 q + 1; the B stage as packed) equals the unpermuted product of the same
  hi / lo terms.
"""

import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa


def _perm(l):
    """The input row logical k = l of an 8-deep group reads (the A fragment
    columns q, q + 4 are the accumulator's 2 q, 2 q + 1)."""
    return 2 * l if l < 4 else 2 * (l - 4) + 1


def _stages(buf, dims):
    """The image as per-matrix (passes, chunks, 2, 64, 32) stages: [.., 0]
    hi, [.., 1] lo; row n, 4-byte slot s as stored."""
    out, o = [], 0
    for a, b in dims:
        npass, nch = -(-b // 64), -(-a // 32)
        n = npass * nch * 2 * 64 * 32
        out.append(buf[o:o + n].view(npass, nch, 2, 64, 32))
        o += n
    assert o == buf.numel()
    return out


def _logical(stage):
    """A stage (.., 64, 32) in the order the kernel reads it: row n, logical
    k (the slot's 16-byte group XOR-ed back with n % 8)."""
    n = torch.arange(64).view(64, 1)
    k = torch.arange(32).view(1, 32)
    slot = ((k // 4) ^ (n % 8)) * 4 + k % 4
    return torch.gather(stage, -1, slot.expand(stage.shape))


def _unpack(st, a, b):
    """Stages back to (a, b) matrices of hi and of lo, and the mask of the
    image slots they came from."""
    npass, nch = st.shape[:2]
    lg = _logical(st)                               # (P, C, 2, 64, 32)
    k = torch.arange(32)
    phys = k - k % 8 + torch.tensor([_perm(int(x)) for x in k % 8])
    hi = torch.zeros(a, b)
    lo = torch.zeros(a, b)
    inside = torch.zeros(lg.shape, dtype=torch.bool)
    for p in range(npass):
        for c in range(nch):
            rows = 32 * c + phys                     # input row of logical k
            cols = 64 * p + torch.arange(64)
            ok_k, ok_n = rows < a, cols < b
            sub = lg[p, c][:, ok_n][:, :, ok_k]     # (2, n, k)
            hi[rows[ok_k][None, :], cols[ok_n][:, None]] = sub[0]
            lo[rows[ok_k][None, :], cols[ok_n][:, None]] = sub[1]
            m = inside[p, c]
            m[:, ok_n.nonzero()[:, 0][:, None], ok_k.nonzero()[:, 0][None, :]] \
                = True
    return hi, lo, lg, inside


DIMS = [
    [(128, 256), (256, 256), (256, 256)],    # the key walk's widths, then w_k
    [(144, 256), (256, 32)],                 # the value walk's first / last
    [(48, 80), (80, 16)],
]


@pytest.mark.parametrize("dims", DIMS)
def test_pack_walk_wgmma_f32_hi_lo_reproduce_the_weights(dims):
    rng = np.random.default_rng(len(dims) + dims[0][0])
    mats = [torch.as_tensor(rng.normal(size=d).astype(np.float32)) * 3
            for d in dims]
    buf = fm.pack_walk_wgmma_f32(mats, "cpu")
    assert buf.dtype == torch.float32
    # The size the kernel's layer table computes (wg_plan_f32): per matrix
    # ceil(pd_out / 64) passes of ceil(pd_in / 32) 16 KB stages.
    assert 4 * buf.numel() == sum(math.ceil(a / 32) * math.ceil(b / 64)
                                  * 16384 for a, b in dims)
    bits = buf.view(torch.int32)
    assert not (bits & 0x1FFF).any()                # both images on TF32
    for st, m, (a, b) in zip(_stages(buf, dims), mats, dims):
        hi, lo, lg, inside = _unpack(st, a, b)
        assert not lg[~inside].any()                # zero beyond the matrix
        assert torch.equal(hi, fm.tf32_rna(m))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12,
                      1.0 + 3 * 2 ** -11, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, -(1.0 + 2 ** -10), 1.0,
                         1.0 + 2 ** -9, 0.0], dtype=torch.float32)
    assert torch.equal(fm.tf32_rna(x), want)


@pytest.mark.parametrize("a,b", [(128, 256), (144, 32), (40, 72)])
def test_product_from_the_permuted_image_equals_the_plain_product(a, b):
    """What the kernel computes for 16 rows: per stage and k8 step, A_log[r,
    l] = x[r, 8 s + perm(l)] (the thread's float2 reads) against the
    stage's logical B rows, lo.hi + hi.lo + hi.hi; against the same terms
    summed over the input rows in their own order."""
    rng = np.random.default_rng(a + b)
    w = torch.as_tensor(rng.normal(size=(a, b)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(16, -(-a // 32) * 32))
                        .astype(np.float32))
    x[:, a:] = 0.0
    st = _stages(fm.pack_walk_wgmma_f32([w], "cpu"), [(a, b)])[0]
    lg = _logical(st).double()                      # (P, C, 2, 64, 32)
    xh = fm.tf32_rna(x)
    xl = fm.tf32_rna(x - xh)
    got = torch.zeros(16, st.shape[0] * 64, dtype=torch.float64)
    for p in range(st.shape[0]):
        for c in range(st.shape[1]):
            for s in range(4):
                cols = [32 * c + 8 * s + _perm(l) for l in range(8)]
                ah, al = xh[:, cols].double(), xl[:, cols].double()
                bh = lg[p, c, 0][:, 8 * s:8 * s + 8].T      # (8, 64)
                bl = lg[p, c, 1][:, 8 * s:8 * s + 8].T
                got[:, 64 * p:64 * p + 64] += al @ bh + ah @ bl + ah @ bh
    wh = fm.tf32_rna(w)
    wl = fm.tf32_rna(w - wh)
    xa_h, xa_l = xh[:, :a].double(), xl[:, :a].double()
    want = xa_l @ wh.double() + xa_h @ wl.double() + xa_h @ wh.double()
    assert torch.allclose(got[:, :b], want, rtol=0, atol=1e-9)
    assert not got[:, b:].any()
    # 3xTF32 is fp32-accurate: against the fp64 product of the fp32 values.
    exact = x[:, :a].double() @ w.double()
    assert float((want - exact).norm() / exact.norm()) < 1e-6


@pytest.mark.parametrize("dims,head", [
    ((117, 256, 256, 256, 256, 256), 256),   # the flagship's key walk, w_k
    ((142, 256, 256, 256, 256, 256, 256, 256, 32), 0),   # its value walk
    ((81, 256, 256, 256, 256, 256), 256),    # Caterpillar's key walk, w_k
    ((20, 48, 16), 40),
])
def test_fwd_pack_f32_unpacks_to_the_walk_then_w_k(dims, head):
    """Per matrix in stream order (the walk's layers, then w_k): hi on the
    TF32 grid and equal to the rounded weight, hi + lo the fp32 weight to
    fp32 rounding, zero beyond it, and the size ``wg_plan_f32`` computes;
    each layer is ``pack_walk``'s, the walk's weight in its corner."""
    rng = np.random.default_rng(sum(dims) + head)
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])))
               for i in range(len(dims) - 1))
    bs = tuple(t(rng.normal(size=d)) for d in dims[1:])
    walk = fm.Walk(ws, bs, None, None, "relu", "none",
                   ((0, 0.0, 0),) * dims[0])
    f32 = torch.float32
    _, w, _, _, _, pd = fm.pack_walk(walk, dims[0], "cpu", f32)
    wk = ()
    if head:
        wk = (t(rng.normal(size=(pd[-1], head))),)
    buf = sa.fwd_wgmma_pack_f32(w, pd, "cpu", wk)
    assert buf.dtype == f32
    order = list(zip(pd[:-1], pd[1:])) + [tuple(h.shape) for h in wk]
    want, o = [], 0
    for i, (a, b) in enumerate(zip(pd[:-1], pd[1:])):
        m = w[o:o + a * b].view(a, b)
        n_in, n_out = ws[i].shape
        assert torch.equal(m[:n_in, :n_out], ws[i])
        assert not m[n_in:].any() and not m[:, n_out:].any()
        want.append(m)
        o += a * b
    want += list(wk)
    for st, m, (a, b) in zip(_stages(buf, order), want, order):
        hi, lo, lg, inside = _unpack(st, a, b)
        assert not lg[~inside].any()
        assert torch.equal(hi, fm.tf32_rna(m))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())
    assert 4 * buf.numel() == sum(math.ceil(a / 32) * math.ceil(b / 64)
                                  * 16384 for a, b in order)
