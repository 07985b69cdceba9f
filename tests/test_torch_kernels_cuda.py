"""The CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). This file imports no
jax, so it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: the cull selection is bit-equal (the kernel rounds like the
plain version, without FMA contraction); bf16 walks: relative Frobenius
error <= 1e-2, attn within 5e-3 absolute (summation order in the MMAs).
"""

import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.config import load_config
from papr_tpu_torch.model.papr import create_model
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops import tile_cull as tc
from papr_tpu_torch.ops.fused_mlp import Walk, posenc_plan
from papr_tpu_torch.ops.geometry import get_rays_np
from papr_tpu_torch.train.step import render_frame

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _walk(rng, cols, n, d_ff, d_out, norm, dev):
    dims = [len(cols)] + [d_ff] * (n - 1) + [d_out]
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])) / math.sqrt(dims[i]))
               for i in range(n))
    bs = tuple(t(rng.normal(size=dims[i + 1]) * 0.1) for i in range(n))
    lns = ((t(1 + 0.2 * rng.normal(size=dims[0])), t(0.1 * rng.normal(size=dims[0]))),
           (t(1 + 0.2 * rng.normal(size=d_out)), t(0.1 * rng.normal(size=d_out))))
    return Walk(ws, bs, lns[0] if norm else None, lns[1] if norm else None,
                "relu", "none", tuple(cols))


@pytest.mark.parametrize("M,k", [(2048, 20), (700, 8)])
def test_cull_kernel_bit_equal_to_plain(dev, M, k):
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.normal(size=(3000, 3)).astype(np.float32) * 0.5,
                          device=dev)
    alive = torch.ones(3000, dtype=torch.bool, device=dev)
    alive[100:300] = False
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0, 0, 2.5]
    rayo, rayd = get_rays_np(40, 56, 40.0, 40.0, c2w[None])
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        pts, alive, torch.as_tensor(rayo[0], device=dev),
        torch.as_tensor(rayd[0], device=dev), M=M, prefilter="packsort")
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    assert torch.equal(got, want)
    assert torch.equal(tc.cull_select(tiles, f, recs, k, chunk, False), want)


def test_fused_mlp_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    _, cols = posenc_plan((3,), (6,), 1, 2.0, 1.0, 0)
    walk = _walk(rng, cols, 5, 256, 256, True, dev)
    x = torch.as_tensor(rng.normal(size=(1000, 3)).astype(np.float32), device=dev)
    got = fm.fused_mlp(x, walk, torch.bfloat16)
    want = fm.fused_mlp_plain(x, walk, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1000, 256)
    assert _rel(got, want) <= 1e-2
    with pytest.raises(NotImplementedError, match="bf16"):
        fm.fused_mlp(x, walk, torch.float32)


@pytest.mark.parametrize("normalize", [True, False])
def test_attend_eval_kernel_matches_plain(dev, normalize):
    rng = np.random.default_rng(2)
    P, T, K, dm = 500, 300, 20, 256
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    idx = rng.integers(0, P, size=(T, K)).astype(np.int32)
    dead = np.where(record[:, 4] == 0)[0]
    idx[5] = dead[:K] if len(dead) >= K else idx[5]     # an all-dead ray
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    rayo = t(np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3)))
    rays = rng.normal(size=(T, 3))
    rays = t(rays / np.linalg.norm(rays, axis=-1, keepdims=True))
    qq = t(rng.normal(size=(T, dm)))
    kw = _walk(rng, sa.rec_pe_plan(True, (6, 6, 6), 1, 2.0, 1.0, 0), 5, 256,
               256, True, dev)
    vw = _walk(rng, sa.rec_pe_plan(False, (6, 6), 1, 2.0, 1.0, 64), 8, 256,
               32, False, dev)
    wk = t(rng.normal(size=(dm, 256)) / 16)
    bk = t(rng.normal(size=dm) * 0.1)
    args = (t(record), torch.as_tensor(idx, device=dev), rayo, rays, qq, kw,
            wk, bk, vw, "relu", 5.0, normalize, 1e-6, torch.bfloat16)
    fg, ag = sa.attend_eval_idx(*args)
    fw, aw = sa.attend_eval_plain(*args)
    assert _rel(fg, fw) <= 1e-2
    assert float((ag - aw).abs().max()) <= 5e-3
    assert torch.isfinite(fg).all() and torch.isfinite(ag).all()


def test_wrappers_check_inputs(dev):
    x = torch.zeros(10, 3, dtype=torch.float64, device=dev)
    _, cols = posenc_plan((3,), (2,), 1, 2.0, 1.0, 0)
    walk = _walk(np.random.default_rng(3), cols, 2, 16, 16, True, dev)
    with pytest.raises(ValueError):
        fm.fused_mlp(x, walk, torch.bfloat16)
    with pytest.raises(ValueError):
        tc.cull_select(torch.zeros(2, 256, 3, device=dev),
                       torch.zeros(2, 255, device=dev),
                       torch.zeros(2, 8, 512, device=dev), 4, 512, False)


def test_render_frame_on_card_uses_the_kernels(dev):
    cfg = load_config(overrides={
        "use_amp": True, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}}})
    params, state = create_model(cfg, seed=0, device=dev)
    for fn in (tc.cull_select, fm.fused_mlp, sa.attend_eval_idx):
        fn.launches = 0
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    frame = render_frame(params, state, cfg, c2w, 70.0, 70.0, 80, 72, 32, 32)
    assert frame.shape == (80, 72, 3) and frame.dtype == np.uint8
    assert tc.cull_select.launches > 0 and fm.fused_mlp.launches > 0
    assert sa.attend_eval_idx.launches > 0
