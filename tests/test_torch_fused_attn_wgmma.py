"""The host side of the fp32 fused scores' forward on wgmma
(``papr_fused_scores_f32_fwd`` launches ``fused_scores_query_wgmma_f32_kernel``,
``fused_scores_fwd_wgmma_f32_kernel`` and ``key_fwd_softmax_kernel``;
``csrc/fused_attn.cu``), on the CPU.

- ``ops/fused_attn.py fused_scores_fwd`` in fp32 reaches the wgmma entry
  point with its signature's argument count (the bf16 form's arguments
  before the stream, then qq's rows, the masked scores, the packed image,
  its size in bytes and the grid), one launch counted as fp32; the bf16
  forward keeps its WMMA entry point and list.
- qq's rows are (T, pdm) fp32 and the masked scores (T, K) fp32, each of its
  own; raw is (T, K) with ``with_raw`` and null without.
- The image unpacks to w_q^T, then w_k^T (input-major, fp32 hi / lo stages,
  zero beyond each matrix), and its byte size is ``wg_plan_f32``'s over
  (pdq -> pdm), (pdk -> pdm).
- The grid is in 1 .. the number of 128-ray tiles.
- K over 64 and widths over 256 are refused before any launch.

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card). The
plain version is held against JAX by ``tests/test_torch_fused_attn.py``.
"""

import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import fused_attn as fa
from papr_tpu_torch.ops import fused_mlp as fm
from test_torch_wgmma import _card, lib  # noqa: F401
from test_torch_wgmma_f32 import _stages, _unpack

ENTRY = "papr_fused_scores_f32_fwd"


def _args(T=300, K=6, Dk=48, Dq=40, dm=32, seed=3):
    """embedk (K, T, Dk), embedq (T, Dq), w_k / b_k, w_q / b_q, influence
    and alive (T, K; a few dead slots) on tensors that read as CUDA
    tensors."""
    rng = np.random.default_rng(seed)
    t = lambda a: _card(torch.as_tensor(np.ascontiguousarray(a, np.float32)))
    return (t(rng.normal(size=(K, T, Dk))), t(rng.normal(size=(T, Dq))),
            t(rng.normal(size=(dm, Dk))), t(rng.normal(size=dm)),
            t(rng.normal(size=(dm, Dq))), t(rng.normal(size=dm)),
            t(rng.normal(size=(T, K))), t(rng.random((T, K)) > 0.05))


def _f32_bytes(dims):
    return sum(math.ceil(a / 32) * math.ceil(b / 64) * 16384 for a, b in dims)


def _recording(monkeypatch, name):
    got, real = [], getattr(fa, name)

    def rec(*args, **kwargs):
        got.append(real(*args, **kwargs))
        return got[-1]
    monkeypatch.setattr(fa, name, rec)
    return got


@pytest.mark.parametrize("with_raw,grid", [(True, None), (False, None),
                                           (True, 1)])
def test_f32_forward_reaches_the_wgmma_entry_point(lib, monkeypatch,
                                                   with_raw, grid):
    """One launch counted as fp32; the arguments, the row buffers it hands
    the kernel (qq (T, pdm), ss (T, K), raw (T, K) or null) and the grid."""
    T, K, Dk, Dq, dm = 300, 6, 48, 40, 32
    if grid is not None:
        monkeypatch.setattr(fm, "wgmma_grid", lambda T: grid)
    rows = _recording(monkeypatch, "_fwd_wgmma_rows")
    n = fa.fused_scores_f32_fwd.launches, fa.fused_scores_fwd.launches
    out = fa.fused_scores_fwd(*_args(T, K, Dk, Dq, dm), "relu", 5.0,
                              torch.float32, with_raw=with_raw)
    attn, raw = out if with_raw else (out, None)
    assert (fa.fused_scores_f32_fwd.launches,
            fa.fused_scores_fwd.launches) == (n[0] + 1, n[1])
    (name, a), = lib.calls
    assert name == ENTRY
    assert len(a) == len(build.SIGNATURES[ENTRY]) == 27
    assert tuple(a[8:16]) == (T, K, Dk, Dq, dm, 48, 48, 32)
    assert a[4] is None and a[5] is None                   # wkT, wqT unread
    (qq, ss), = rows
    assert (qq.shape, ss.shape) == ((T, 32), (T, K))
    assert qq.dtype == ss.dtype == torch.float32
    assert (a[19], a[21], a[22]) == (attn.data_ptr(), qq.data_ptr(),
                                     ss.data_ptr())
    assert a[20] == (raw.data_ptr() if with_raw else None)
    assert attn.shape == (T, K + 1)
    if with_raw:
        assert raw.shape == (T, K) and raw.dtype == torch.float32
    assert len({a[19], a[20], a[21], a[22]}) == 4
    assert a[-3] == _f32_bytes([(48, 32), (48, 32)])
    assert a[-2] == (grid or math.ceil(T / 128))


def test_bf16_forward_keeps_its_wmma_entry_point(lib):
    """The bf16 row 10 forward stays on WMMA: its own entry point, no qq
    buffer, image or grid, counted as bf16."""
    n = fa.fused_scores_f32_fwd.launches, fa.fused_scores_fwd.launches
    fa.fused_scores_fwd(*_args(), "relu", 5.0, torch.bfloat16)
    (name, a), = lib.calls
    assert name == "papr_fused_scores_fwd" and len(a) == 22
    assert a[4] is not None and a[5] is not None           # wkT, wqT
    assert (fa.fused_scores_f32_fwd.launches,
            fa.fused_scores_fwd.launches) == (n[0], n[1] + 1)


@pytest.mark.parametrize("Dk,Dq,dm", [(48, 40, 32), (256, 256, 256),
                                      (200, 136, 96)])
def test_image_unpacks_to_w_q_then_w_k(lib, monkeypatch, Dk, Dq, dm):
    """The image the wrapper passes (its pointer) holds w_q^T (Dq, d_model),
    then w_k^T (Dk, d_model), each as hi = tf32(w) and hi + lo = w to fp32
    rounding, zero beyond the matrix, in the kernel's stage order."""
    packs = _recording(monkeypatch, "fwd_wgmma_image")
    args = _args(T=20, K=2, Dk=Dk, Dq=Dq, dm=dm)
    fa.fused_scores_fwd(*args, "relu", 5.0, torch.float32)
    (buf,), ((_, a),) = packs, lib.calls
    assert a[-4] == buf.data_ptr() and buf.dtype == torch.float32
    wk, wq = args[2], args[4]
    want = [wq.T.clone().as_subclass(torch.Tensor),
            wk.T.clone().as_subclass(torch.Tensor)]
    pd = lambda d: fm.round_up(d, 16)
    assert 4 * buf.numel() == a[-3] == _f32_bytes(
        [(pd(Dq), pd(dm)), (pd(Dk), pd(dm))])
    order = [tuple(m.shape) for m in want]
    for st, m, (p_in, p_out) in zip(_stages(buf, order), want, order):
        hi, lo, lg, inside = _unpack(st, p_in, p_out)
        assert not lg[~inside].any()
        assert torch.equal(hi, fm.tf32_rna(m))
        err = ((hi.double() + lo.double()) - m.double()).abs()
        assert bool((err <= 2.0 ** -21 * m.double().abs()).all())


@pytest.mark.parametrize("T", [1, 127, 128, 129, 32400, 640000])
def test_grid_is_within_the_tiles(lib, T):
    """The persistent grid: one block an SM (132 on an H100) and at most
    one a 128-ray tile (the kernel refuses anything else, -209)."""
    tiles = math.ceil(T / 128)
    grid = fm.wgmma_grid(T)
    assert 1 <= grid <= tiles and grid == min(132, tiles)
    if T <= 129:
        fa.fused_scores_fwd(*_args(T=T, K=3), "relu", 5.0, torch.float32)
        (_, a), = lib.calls
        assert a[-2] == grid


@pytest.mark.parametrize("K,Dk,Dq,dm", [(65, 48, 40, 32), (6, 264, 40, 32),
                                        (6, 48, 264, 32), (6, 48, 40, 264)])
def test_wide_heads_and_many_slots_are_refused(lib, K, Dk, Dq, dm):
    """K over 64 and any width over 256 (the heads' products and qq's rows):
    NotImplementedError before any launch."""
    with pytest.raises(NotImplementedError, match="K <= 64 and widths <= 256"):
        fa.fused_scores_fwd(*_args(T=20, K=K, Dk=Dk, Dq=Dq, dm=dm), "relu",
                            5.0, torch.float32)
    assert not lib.calls
