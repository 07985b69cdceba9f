"""The host side of the fp32 fused embedder on wgmma (``csrc/fused_mlp.cu``
``papr_fused_mlp_f32_fwd`` and ``csrc/fused_mlp_bwd.cu``
``papr_fused_mlp_f32_bwd``, ``walk_wgmma.cuh`` / ``walk_wgmma_bwd.cuh`` in
their fp32 operand form), on the CPU.

- ``pack_embed_wgmma(..., cdt=float32)``'s image, unpacked by
  ``tests/test_torch_wgmma_f32.py``'s reading of the fp32 stages (64 output
  rows x 32 tf32 along K, hi then lo, swizzled and permuted), gives the
  walk's weights, then (backward) W_l^T for l = n-1 .. 0: hi on the TF32
  grid and equal to the rounded weight, hi + lo the fp32 weight to fp32
  rounding, zero beyond each matrix, and the size the kernel's layer table
  (``wg_plan_f32``) computes; everything else is ``pack_walk``'s; it follows
  the weights when they change.
- The fp32 wrappers reach the wgmma entry points with their signature's
  argument count, the image's bytes and the persistent grid last; the
  backward's fp32 stash rows for R padded to the 128-row tile, one partial
  row a warp (see ``test_torch_fused_mlp_wgmma.py``
  ``test_fp32_embedder_keeps_its_entry_points``).
- A walk the fp32 backward does not take (a posenc column without its sin /
  cos partner beside it, more than 96 raw columns) is refused with
  ``NotImplementedError`` before any launch.
"""

import math

import pytest
import torch

from papr_tpu_torch.ops import fused_mlp as fm
from test_torch_fused_mlp_wgmma import STACKS, _card_walk, _dims, _stack
from test_torch_wgmma import _card, lib  # noqa: F401
from test_torch_wgmma_f32 import _stages, _unpack


def _f32_image_bytes(walk, backward):
    pd = lambda d: fm.round_up(d, 16)
    return sum(math.ceil(pd(a) / 32) * math.ceil(pd(b) / 64) * 16384
               for a, b in _dims(walk, backward))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name", list(STACKS))
def test_embed_pack_f32_unpacks_to_the_walk(name, backward):
    walk, _ = _stack(name)
    f32 = torch.float32
    meta, b_all, ln, plan, img, pd = fm.pack_embed_wgmma(walk, "cpu",
                                                         backward, f32)
    assert img.dtype == f32
    assert 4 * img.numel() == _f32_image_bytes(walk, backward)
    assert not (img.view(torch.int32) & 0x1FFF).any()     # on the TF32 grid
    dims = _dims(walk, backward)
    n = len(walk.ws)
    want = list(walk.ws) + ([w.T for w in reversed(walk.ws)] if backward
                            else [])
    for st, m, (a, b) in zip(_stages(img, dims), want, dims):
        hi, lo, lg, inside = _unpack(st, a, b)
        assert not lg[~inside].any()
        assert torch.equal(hi, fm.tf32_rna(m.contiguous()))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())
    assert len(want) == (2 * n if backward else n)
    meta_w, _, b_w, ln_w, plan_w, pd_w = fm.pack_walk(walk, len(walk.cols),
                                                      "cpu", f32)
    assert meta == meta_w and pd == pd_w
    assert torch.equal(b_all, b_w) and torch.equal(ln, ln_w)
    assert torch.equal(plan, plan_w)


def test_embed_pack_f32_follows_the_weights():
    walk, _ = _stack("narrow", 2)
    f32 = torch.float32
    first = fm.pack_embed_wgmma(walk, "cpu", True, f32)[4].clone()
    walk.ws[1].mul_(-3.0)                 # in place, as an optimizer step
    second = fm.pack_embed_wgmma(walk, "cpu", True, f32)[4]
    assert not torch.equal(first, second)
    dims = _dims(walk, True)
    st = _stages(second, dims)
    hi1 = _unpack(st[1], *dims[1])[0]
    hi_t = _unpack(st[-2], *dims[-2])[0]
    assert torch.equal(hi1, fm.tf32_rna(walk.ws[1].contiguous()))
    assert torch.equal(hi_t, fm.tf32_rna(walk.ws[1].T.contiguous()))


def test_fp32_bwd_refuses_what_the_kernel_does_not_take(lib):
    walk, d_raw = _stack("narrow")
    cols = list(walk.cols)
    i = next(c for c, col in enumerate(cols) if col[2] == 1)
    cols[i], cols[i + 1] = cols[i + 1], cols[i]       # cos before its sin
    x = _card(torch.zeros(10, d_raw))
    dy = _card(torch.zeros(10, 16))
    with pytest.raises(NotImplementedError, match="partner"):
        fm.fused_mlp_bwd(x, dy, _card_walk(walk._replace(cols=tuple(cols))),
                         torch.float32)
    wide = tuple((c, 0.0, 0) for c in range(100))
    walk = walk._replace(ws=(torch.zeros(100, 16),) + walk.ws[1:],
                         ln_in=None, cols=wide)
    with pytest.raises(NotImplementedError, match="96 sources"):
        fm.fused_mlp_bwd(_card(torch.zeros(10, 100)), dy, _card_walk(walk),
                         torch.float32)
    assert lib.calls == []
