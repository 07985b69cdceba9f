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


def _frame_cull_case(dev, shape, k, seed=4, block=16, prefilter=None):
    """Stage 3's inputs at a frame's shape: 30,000 points in a cube seen by a
    camera at 4 units (800x800 rays, focal 700); ``serving``: the whole
    frame, the sorted prefilter and the early exit (2500 tiles, chunk 512);
    ``training``: a 160x160 crop, the exact top-k prefilter (100 tiles, one
    2048 chunk); ``block``, ``prefilter``: another ray tile edge or
    prefilter. Then every 64th candidate duplicated into the next slot
    (index and all) and every 64th + 32 copied with its own index (a tied
    distance), the lower bounds kept ascending and below the distances."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-1, 1, size=(30_000, 3))
                          .astype(np.float32), device=dev)
    alive = torch.as_tensor(rng.random(30_000) > 0.1, device=dev)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.2, 4.0]
    rayo, rayd = get_rays_np(800, 800, 700.0, 700.0, c2w[None])
    rayd = torch.as_tensor(rayd[0], device=dev)
    if shape == "training":
        rayd = rayd[300:460, 330:490].contiguous()
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        pts, alive, torch.as_tensor(rayo[0].reshape(-1)[:3], device=dev),
        rayd, M=2048, block=block, prefilter=prefilter or (
            "packsort" if shape == "serving" else "approx"))
    M = recs.shape[-1]
    j = torch.arange(0, M - 1, 64, device=dev)
    recs[:, :4, j + 1] = recs[:, :4, j]
    recs[:, 4, j + 1] = recs[:, 4, j]                  # duplicates
    recs[:, 5, j + 1] = recs[:, 5, j]
    t = j[j + 33 < M] + 32
    recs[:, :4, t + 1] = recs[:, :4, t]                # tied distances
    recs[:, 5, t + 1] = recs[:, 5, t]
    return tiles, f, recs, chunk, ee


@pytest.mark.parametrize("k", [8, 16, 20, 30, 32, 64])
@pytest.mark.parametrize("shape", ["serving", "training"])
def test_cull_kernel_bit_equal_at_frame_shapes(dev, shape, k):
    """K1 at the serving and training shapes, bit-equal to its plain version
    (with duplicate candidates and tied distances), one launch counted."""
    tiles, f, recs, chunk, ee = _frame_cull_case(dev, shape, k)
    assert (chunk, ee) == ((512, True) if shape == "serving" else (2048,
                                                                    False))
    n = tc.cull_select.launches
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    assert tc.cull_select.launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("block", [4, 6, 8, 32])
def test_cull_kernel_bit_equal_at_other_ray_tiles(dev, block, early_exit):
    """K1 at ray tiles of block x block rays (``tpu.cull_block``): 16, 36
    and 64 rays, fewer threads than a stage's candidates at one or two
    threads a ray, and 1024, a tile over four blocks, on the training crop
    with and without the early exit, bit-equal to its plain version at
    k = 8, 20, 32 and 64."""
    tiles, f, recs, chunk, ee = _frame_cull_case(
        dev, "training", 0, block=block,
        prefilter="packsort" if early_exit else "approx")
    assert tiles.shape[1] == block * block and ee == early_exit
    for k in (8, 20, 32, 64):
        got = tc.cull_select(tiles, f, recs, k, chunk, ee)
        want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
        assert torch.equal(got, want), (block, early_exit, k)


def test_fused_mlp_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    _, cols = posenc_plan((3,), (6,), 1, 2.0, 1.0, 0)
    walk = _walk(rng, cols, 5, 256, 256, True, dev)
    x = torch.as_tensor(rng.normal(size=(1000, 3)).astype(np.float32), device=dev)
    got = fm.fused_mlp(x, walk, torch.bfloat16)
    want = fm.fused_mlp_plain(x, walk, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (1000, 256)
    assert _rel(got, want) <= 1e-2
    # fp32 compute has its own kernel now (held below); other dtypes raise.
    got = fm.fused_mlp(x, walk, torch.float32)
    assert got.dtype == torch.float32
    assert _rel(got, fm.fused_mlp_plain(x, walk, torch.float32)) <= F32_REL
    with pytest.raises(NotImplementedError, match="bf16 or fp32"):
        fm.fused_mlp(x, walk, torch.float16)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K", [(300, 20), (131, 1), (200, 7), (257, 33)])
def test_attend_eval_kernel_matches_plain(dev, normalize, T, K):
    """The bf16 one-shot eval attention (wgmma, 128 rays a block) at ragged
    ray counts, with an all-dead ray (row 5)."""
    rng = np.random.default_rng(2)
    P, dm = 500, 256
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    idx = rng.integers(0, P, size=(T, K)).astype(np.int32)
    dead = np.where(record[:, 4] == 0)[0]
    idx[5] = np.resize(dead, K)                         # an all-dead ray
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
    before = sa.attend_eval_idx.launches
    fg, ag = sa.attend_eval_idx(*args)
    fw, aw = sa.attend_eval_plain(*args)
    med = _median_row_rels([fg], [fw])[0]
    print(f"attend_eval T={T} K={K} normalize={normalize}: fused rel "
          f"{_rel(fg, fw):.3e}, median ray {med:.3e}, attn max abs "
          f"{float((ag - aw).abs().max()):.3e}")
    assert sa.attend_eval_idx.launches == before + 1
    assert _rel(fg, fw) <= 1e-2 and med <= FWD_MEDIAN_REL["attend_eval"]
    assert float((ag - aw).abs().max()) <= 5e-3
    assert torch.isfinite(fg).all() and torch.isfinite(ag).all()
    # The all-dead ray: all attention on the background token.
    assert float(ag[5, :K].abs().max()) == 0.0 and float(ag[5, K]) == 1.0


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


# ------------------------------------------------- training-path kernels ----
# Backward tolerance: relative Frobenius error <= 3e-2 per gradient, d_rec
# per lane group; where the plain gradient is all zero the kernel's must be
# too. Both sides round activations and dz to bf16; the plain version also
# rounds dW to bf16 (autograd through the bf16 weight cast) and sums in
# another order, the kernel keeps dW / db in fp32; a hidden relu whose input
# the two forwards round to opposite signs switches one token's path in
# one of them. The plain key stream is given the kernel forward's score
# relu pattern (``relu_on``), so both differentiate the same function.
# The sound kernels read up to 2.2e-2 here (value d_rec, T = 100); planted
# faults (a score scale off by 10 %, the LayerNorm backward's variance term
# dropped, a routing lane left out, the renormalization term dropped) read
# 8.9e-2 and above (PERF.md, Findings).

BWD_REL = 3e-2


def _close_all(got, want, tol, name):
    assert len(got) == len(want)
    rels = []
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), i
        assert torch.isfinite(g).all(), i
        if float(w.abs().max()) == 0.0:
            assert float(g.abs().max()) == 0.0, i
            rels.append(0.0)
        else:
            rels.append(_rel(g, w))
    print(f"{name}: rel Frobenius " + ", ".join(f"{r:.2e}" for r in rels))
    assert max(rels) <= tol, (name, rels)


def _rec_lanes(grads):
    """d_rec split by routing rule: geometry (lanes 0:3), d_influence
    (lane 3), the rest."""
    d = grads[0]
    return [d[..., :3], d[..., 3], d[..., 4:]] + list(grads[1:])


@pytest.mark.parametrize("R,norm", [(1000, True), (100, False)])
def test_fused_mlp_bwd_kernel_matches_plain(dev, R, norm):
    """Row-3 backward; R = 100 leaves an overhang tile of 36 rows."""
    rng = np.random.default_rng(4)
    _, cols = posenc_plan((3,), (6,), 1, 2.0, 1.0, 0)
    walk = _walk(rng, cols, 5, 256, 256, norm, dev)
    x = torch.as_tensor(rng.normal(size=(R, 3)).astype(np.float32), device=dev)
    dy = torch.as_tensor(rng.normal(size=(R, 256)).astype(np.float32), device=dev)
    dx, grads = fm.fused_mlp_bwd(x, dy, walk, torch.bfloat16)
    dxp, gp = fm.fused_mlp_bwd_plain(x, dy, walk, torch.bfloat16)
    _close_all([dx] + grads, [dxp] + gp, BWD_REL, f"fused_mlp_bwd R={R}")


@pytest.mark.parametrize("dims,Ls,extra,n,d_out,norm",
                         [((3, 3, 3), (6, 6, 6), 0, 5, 256, True),
                          ((3, 3), (6, 6), 64, 8, 32, False)],
                         ids=["key", "value"])
def test_fused_mlp_kernels_on_key_value_stacks(dev, dims, Ls, extra, n, d_out,
                                               norm):
    """The embedder kernels on the flagship key and value stacks (several
    posenc features, pass-through point-feature columns), forward and
    backward, dx held per column group; R = 1100 leaves an overhang tile."""
    rng = np.random.default_rng(8)
    d_raw, cols = posenc_plan(dims, Ls, 1, 2.0, 1.0, extra)
    walk = _walk(rng, cols, n, 256, d_out, norm, dev)
    R, n_geo = 1100, sum(dims)
    x = torch.as_tensor(rng.normal(size=(R, d_raw)).astype(np.float32), device=dev)
    got = fm.fused_mlp(x, walk, torch.bfloat16)
    want = fm.fused_mlp_plain(x, walk, torch.bfloat16)
    assert got.shape == (R, d_out) and _rel(got, want) <= 1e-2
    dy = torch.as_tensor(rng.normal(size=(R, d_out)).astype(np.float32), device=dev)
    split = lambda r: ([r[0][:, :n_geo]] + ([r[0][:, n_geo:]] if extra else [])
                       + list(r[1]))
    _close_all(split(fm.fused_mlp_bwd(x, dy, walk, torch.bfloat16)),
               split(fm.fused_mlp_bwd_plain(x, dy, walk, torch.bfloat16)),
               BWD_REL, f"fused_mlp_bwd {dims} + {extra}")


# The bf16 embedder on wgmma (rows 2, 3: fused_mlp_fwd_wgmma_kernel,
# fused_mlp_bwd_wgmma_kernel). Besides the Frobenius bounds above, the median
# row (the forward's output, the backward's dx): a rounding-point fault
# moves every row a little, a summation order only the rows where it flips a
# bf16 rounding; the backward's against the plain backward at the TPU
# kernel's rounding points (``kernel_grads=True``: every gradient fp32,
# dz rounded for the two products, db from the fp32 dz; autograd's own rule
# rounds dz at each cast, a rounding point away), as are the biases'
# gradients: the last layer's (its dz comes from dy through the output
# LayerNorm alone) held, the others printed (a summation order's flips reach
# every column of an inner layer's db). Sound and planted-fault readings:
# PERF.md, Findings.
EMBED_MEDIAN_REL = 1e-4         # sound: K2 0, dx <= 3.9e-7
EMBED_DB_REL = 3e-4             # sound <= 1.7e-4; db from rounded dz 1.9e-3
EMBED_REL = 2e-3                # the forward: sound <= 5.8e-4
EMBED_STACKS = {"query": ((3,), (6,), 0, 5, 256),
                "key": ((3, 3, 3), (6, 6, 6), 0, 5, 256),
                "value": ((3, 3), (6, 6), 64, 8, 32)}


def _embed_case(rng, dev, stack, R, norm):
    dims, Ls, extra, n, d_out = EMBED_STACKS[stack]
    d_raw, cols = posenc_plan(dims, Ls, 1, 2.0, 1.0, extra)
    walk = _walk(rng, cols, n, 256, d_out, norm, dev)
    x = torch.as_tensor(rng.normal(size=(R, d_raw)).astype(np.float32),
                        device=dev)
    return walk, x


def _ray_median(got, want):
    """The median over rays of the relative error of a (K, T, ...) or (T,
    ...) output, each ray's entries together (rays whose plain value is 0
    left out)."""
    g, w = got.float(), want.float()
    if g.dim() == 3:
        g, w = g.transpose(0, 1), w.transpose(0, 1)
    g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
    d, n = (g - w).norm(dim=-1), w.norm(dim=-1)
    return float((d[n > 0] / n[n > 0]).median())


def _median_row_rels(got, want):
    """Median over rows of each row's relative error, for each output (a
    vector: its entries), rows whose plain value is 0 left out."""
    out = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        g, w = (g[:, None], w[:, None]) if g.dim() == 1 else (g, w)
        d, n = (g - w).norm(dim=-1), w.norm(dim=-1)
        out.append(float((d[n > 0] / n[n > 0]).median()) if (n > 0).any()
                   else 0.0)
    return out


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "bare"])
@pytest.mark.parametrize("R", [1, 77, 128, 300, 25_600])
@pytest.mark.parametrize("stack", list(EMBED_STACKS))
def test_fused_mlp_wgmma_matches_plain(dev, stack, R, norm):
    """Row 2's bf16 forward on wgmma: ragged R (one row, under a warpgroup,
    one tile, a partial tile, 200 tiles on the persistent grid), the three
    stacks, with and without LayerNorms; one launch."""
    rng = np.random.default_rng(500 + R)
    walk, x = _embed_case(rng, dev, stack, R, norm)
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, walk, torch.bfloat16)
    assert fm.fused_mlp.launches == before + 1
    want = fm.fused_mlp_plain(x, walk, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    rel, med = _rel(got, want), _median_row_rels([got], [want])[0]
    print(f"fused_mlp wgmma {stack} R={R} norm={norm}: rel {rel:.2e}, "
          f"median row {med:.2e}")
    assert bool(torch.isfinite(got.float()).all())
    assert rel <= EMBED_REL and med <= EMBED_MEDIAN_REL
    assert torch.equal(got, fm.fused_mlp(x, walk, torch.bfloat16))


@pytest.mark.parametrize("grid", [1, 3])
def test_fused_mlp_wgmma_on_a_small_grid(dev, monkeypatch, grid):
    """Fewer blocks than tiles: each block walks its share of the 128-row
    tiles (the ring runs on across tiles), forward and backward."""
    rng = np.random.default_rng(600 + grid)
    walk, x = _embed_case(rng, dev, "query", 1000, True)
    dy = torch.as_tensor(rng.normal(size=(1000, 256)).astype(np.float32),
                         device=dev).bfloat16().float()
    want = fm.fused_mlp(x, walk, torch.bfloat16), fm.fused_mlp_bwd(
        x, dy, walk, torch.bfloat16)
    monkeypatch.setattr(fm, "wgmma_grid", lambda R: grid)
    assert torch.equal(fm.fused_mlp(x, walk, torch.bfloat16), want[0])
    dx, grads = fm.fused_mlp_bwd(x, dy, walk, torch.bfloat16)
    assert torch.equal(dx, want[1][0])
    # The partial rows sum in another grouping: fp32 order only.
    _close_all(grads, want[1][1], 1e-5, f"fused_mlp_bwd grid={grid}")


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "bare"])
@pytest.mark.parametrize("R", [1, 77, 128, 300, 25_600])
@pytest.mark.parametrize("stack", list(EMBED_STACKS))
def test_fused_mlp_bwd_wgmma_matches_plain(dev, stack, R, norm):
    """Row 3's bf16 backward on wgmma, as the forward above: every gradient
    against the plain backward (BWD_REL), the median dx row and the biases'
    gradients against the plain backward at the kernel's rounding points;
    one launch."""
    rng = np.random.default_rng(700 + R)
    walk, x = _embed_case(rng, dev, stack, R, norm)
    d_out = int(walk.ws[-1].shape[1])
    dy = torch.as_tensor(rng.normal(size=(R, d_out)).astype(np.float32),
                         device=dev).bfloat16().float()
    before = fm.fused_mlp_bwd.launches
    dx, grads = fm.fused_mlp_bwd(x, dy, walk, torch.bfloat16)
    assert fm.fused_mlp_bwd.launches == before + 1
    dxp, gp = fm.fused_mlp_bwd_plain(x, dy, walk, torch.bfloat16)
    name = f"fused_mlp_bwd wgmma {stack} R={R} norm={norm}"
    _close_all([dx] + grads, [dxp] + gp, BWD_REL, name)
    dxk, gk = fm.fused_mlp_bwd_plain(x, dy, walk, torch.bfloat16,
                                     kernel_grads=True)
    med = _median_row_rels([dx], [dxk])[0]
    n = len(walk.ws)
    db = [_rel(a, b) for a, b in zip(grads[n:2 * n], gk[n:2 * n])]
    print(f"{name}: median dx row {med:.1e}; db per layer, at the kernel's "
          "rounding points " + ", ".join(f"{r:.1e}" for r in db))
    assert med <= EMBED_MEDIAN_REL and db[-1] <= EMBED_DB_REL
    assert torch.equal(dx, fm.fused_mlp_bwd(x, dy, walk, torch.bfloat16)[0])


def _stream_case(rng, dev, T, K, dm=256):
    """Records k-major (K, T, 128) with random alive bits and ray 5 all dead;
    the flagship walks (key 117 -> 5 x 256 with LNs, value 142 -> 8 layers to
    32)."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    rec = np.zeros((K, T, 128), np.float32)
    rec[..., :3] = rng.normal(size=(K, T, 3))
    rec[..., 3] = rng.normal(size=(K, T))
    rec[..., 4] = rng.random((K, T)) > 0.2
    rec[:, 5, 4] = 0.0
    rec[..., 5:69] = rng.normal(size=(K, T, 64))
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
    return t(rec), rayo, rays, qq, kw, vw, wk, bk


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_kernels_match_plain(dev, T):
    """Row 5 forward and backward (T = 100: an overhang tile)."""
    rng = np.random.default_rng(5)
    K = 20
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    opts = ("relu", 5.0, 1e-6, torch.bfloat16)
    attn, raw, ss = sa.key_stream_fwd(*args, *opts)
    attn_p, raw_p, ss_p = sa.key_stream_plain(*args, *opts)
    assert float((attn - attn_p).abs().max()) <= 5e-3
    assert _rel(raw, raw_p) <= 1e-2
    alive = (rec[..., 4] > 0.5).T
    assert torch.equal(ss, torch.where(alive, torch.clamp_min(raw, 0.0)
                                       * rec[..., 3].T, sa.NEG_BIG))
    assert torch.equal(ss_p > -1e29, alive)
    assert float(attn[5, K]) == 1.0                      # the all-dead ray
    # alive scores whose relu both forwards agree on: nearly all, and their
    # masked scores match
    same = (raw > 0) == (raw_p > 0)
    assert float(same[alive].float().mean()) >= 0.99
    assert _rel(ss[alive & same], ss_p[alive & same]) <= 3e-2
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    got = sa.key_stream_bwd(*args, raw, ss, dattn, *opts)
    want = sa.key_stream_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(_rec_lanes(got), _rec_lanes(want), BWD_REL,
               f"key_stream_bwd T={T}")
    assert float(got[0][:, 5].abs().max()) == 0.0        # no gradient there


@pytest.mark.parametrize("T,normalize", [(256, True), (100, False)])
def test_value_stream_kernels_match_plain(dev, T, normalize):
    """Row 6 forward and backward, with an all-dead ray (attention mass 0
    on the foreground) and an overhang tile."""
    rng = np.random.default_rng(6)
    K = 20
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    args = (rec, rayo, rays, attn, vw)
    opts = (normalize, 1e-6, torch.bfloat16)
    fused = sa.value_stream_fwd(*args, *opts)
    fused_p = sa.value_stream_plain(*args, *opts)
    assert _rel(fused, fused_p) <= 1e-2
    assert float(fused[5].abs().max()) == 0.0
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    got = sa.value_stream_bwd(*args, dfused, *opts)
    want = sa.value_stream_bwd_plain(*args, dfused, *opts)
    _close_all(_rec_lanes(got), _rec_lanes(want), BWD_REL,
               f"value_stream_bwd T={T} normalize={normalize}")
    assert float(got[0][:, 5].abs().max()) == 0.0


# The bf16 stream forwards on wgmma: chip_smoke's bounds (relative
# Frobenius of attn, raw and fused; the masked scores on the alive scores
# whose relu both forwards agree on). The key's raw dots here are held
# tighter: sound <= 7.5e-4; y_k truncated to bf16 before w_k (a rounding
# point) reads 3.5e-3 and above (PERF.md, Findings).
FWD_REL = 5e-3
FWD_RAW_REL = 2e-3
SS_REL = 3e-2
# The forward walk on wgmma (K3 and the two bf16 stream forwards) also holds
# the median ray's relative error (K3 and the value: fused; the key: raw):
# a rounding-point fault moves every ray a little. Sound: K3 <= 1.2e-4,
# value <= 1.3e-4, key <= 2.3e-4; planted: value rows not rounded before the
# fuse K3 >= 3.9e-4, value >= 4.5e-4; the output LayerNorm's biased
# variance K3 up to 6.2e-4, key >= 4.6e-3 (PERF.md, Findings).
FWD_MEDIAN_REL = {"attend_eval": 3e-4, "key": 1e-3, "value": 3e-4}
# The folded key stream (row 7, WMMA) on its own qq against the unfolded
# bf16 key forward (wgmma): one function, one set of rounding points, two
# summation orders; chip_smoke's Q_UNFOLD_ABS / Q_UNFOLD_REL.
Q_UNFOLD_ABS = 5e-4
Q_UNFOLD_REL = 5e-4


def _fwd_grid(monkeypatch, grid):
    """A grid smaller than the tiles: each block's share of the (tile, k)
    units then splits tiles between two blocks."""
    if grid is not None:
        monkeypatch.setattr(fm, "wgmma_grid", lambda T: grid)


@pytest.mark.parametrize("score_act", ["relu", "none"])
@pytest.mark.parametrize("T,K,grid", [(300, 20, None), (100, 7, None),
                                      (257, 1, None), (300, 7, 2),
                                      (131, 20, 1)])
def test_key_stream_fwd_wgmma_matches_plain(dev, monkeypatch, T, K, grid,
                                            score_act):
    """Row 5's bf16 forward on wgmma: ragged T (not a multiple of the
    128-ray tile, and below it), K = 1 / 7 / 20, both score_act values, an
    all-dead ray (5) and, with T > 128, a whole warpgroup of all-dead rays
    (64..127); a grid that splits tiles between blocks; one launch."""
    rng = np.random.default_rng(300 + T + K)
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    if T > 128:
        rec[:, 64:128, 4] = 0.0
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    opts = (score_act, 5.0, 1e-6, torch.bfloat16)
    before = sa.key_stream_fwd.launches
    attn, raw, ss = sa.key_stream_fwd(*args, *opts)
    assert sa.key_stream_fwd.launches == before + 1
    attn_p, raw_p, ss_p = sa.key_stream_plain(*args, *opts)
    rels = _rel(attn, attn_p), _rel(raw, raw_p)
    med = _median_row_rels([raw], [raw_p])[0]
    print(f"key_stream_fwd wgmma T={T} K={K} grid={grid} {score_act}: attn "
          f"{rels[0]:.2e}, raw {rels[1]:.2e}, median ray raw {med:.2e}")
    assert rels[0] <= FWD_REL and rels[1] <= FWD_RAW_REL
    assert med <= FWD_MEDIAN_REL["key"]
    alive = (rec[..., 4] > 0.5).T
    sact = torch.clamp_min(raw, 0.0) if score_act == "relu" else raw
    assert torch.equal(ss, torch.where(alive, sact * rec[..., 3].T,
                                       sa.NEG_BIG))
    same = ((raw > 0) == (raw_p > 0) if score_act == "relu"
            else torch.ones_like(alive))
    assert float(same[alive].float().mean()) >= 0.99
    assert _rel(ss[alive & same], ss_p[alive & same]) <= SS_REL
    dead = ~alive.any(dim=1)
    assert bool(dead[5]) and (T <= 128 or bool(dead[64:128].all()))
    assert bool((attn[dead, K] == 1.0).all())
    assert float(attn[dead, :K].abs().max()) == 0.0
    assert torch.allclose(attn.sum(-1), torch.ones(T, device=dev), atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K,grid", [(300, 20, None), (100, 7, None),
                                      (257, 1, None), (300, 7, 2),
                                      (131, 20, 1)])
def test_value_stream_fwd_wgmma_matches_plain(dev, monkeypatch, T, K, grid,
                                              normalize):
    """Row 6's bf16 forward on wgmma, as the key's above: ray 5 and, with T
    > 128, rays 64..127 have no foreground mass (divide by 1); split tiles
    add two blocks' sums."""
    rng = np.random.default_rng(400 + T + K)
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    if T > 128:
        a[64:128, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, attn, vw)
    opts = (normalize, 1e-6, torch.bfloat16)
    before = sa.value_stream_fwd.launches
    fused = sa.value_stream_fwd(*args, *opts)
    assert sa.value_stream_fwd.launches == before + 1
    fused_p = sa.value_stream_plain(*args, *opts)
    rel = _rel(fused, fused_p)
    med = _median_row_rels([fused], [fused_p])[0]
    print(f"value_stream_fwd wgmma T={T} K={K} grid={grid} normalize="
          f"{normalize}: fused {rel:.2e}, median ray {med:.2e}")
    assert rel <= FWD_REL and bool(torch.isfinite(fused).all())
    assert med <= FWD_MEDIAN_REL["value"]
    assert float(fused[5].abs().max()) == 0.0
    if T > 128:
        assert float(fused[64:128].abs().max()) == 0.0
    # Deterministic: the split tiles' two sums land in either order.
    assert torch.equal(fused, sa.value_stream_fwd(*args, *opts))


def test_stream_fwd_wgmma_against_k3(dev):
    """The stream forwards run K3's walk code: on one ray set, the key
    forward's attention is K3's bit for bit, and the value forward on K3's
    attention is K3's fused up to the fuse's arithmetic (K3 sums with an
    online softmax, the stream renormalizes the attention it is given)."""
    rng = np.random.default_rng(21)
    T, K, P = 300, 20, 900
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    record = torch.zeros(P, 128, device=dev)
    idx = torch.as_tensor(rng.integers(0, P, size=(T, K)), device=dev)
    record[idx.T.reshape(-1)] = rec.reshape(K * T, 128)
    rec = record[idx.T]                        # (K, T, 128), idx's rows
    fused3, attn3 = sa.attend_eval_idx(record, idx, rayo, rays, qq, kw, wk,
                                       bk, vw, "relu", 5.0, True, 1e-6,
                                       torch.bfloat16)
    attn = sa.key_stream_fwd(rec, rayo, rays, qq, kw, wk, bk, "relu", 5.0,
                             1e-6, torch.bfloat16)[0]
    assert torch.equal(attn, attn3)
    fused = sa.value_stream_fwd(rec, rayo, rays, attn3, vw, True, 1e-6,
                                torch.bfloat16)
    assert _rel(fused, fused3) <= 1e-5


# The bf16 stream backwards on wgmma also hold the median of the per-ray
# relative error of d_rec and of the per-row error of the walk gradients: a
# rounding-point fault moves every ray a little. Sound <= 8.2e-3 (value walk
# rows, T=200 K=7); dz truncated to bf16 instead of rounded reads d_rec
# 1.44e-2 (key) / 2.32e-2 (value) and above (PERF.md, Findings).
BWD_MEDIAN_REL = 1e-2


def _median_rels(got, want, n_walk):
    """(median over rays of d_rec's relative error, each ray's K x lanes
    entries together; median over the rows of the last n_walk outputs, the
    walk gradients: a row of a matrix, an entry of a vector), on
    ``_rec_lanes`` outputs; zero rays and rows left out."""
    def med(d, n):
        return float((d[n > 0] / n[n > 0]).median())

    def per_ray(lanes):
        x = torch.cat([t.reshape(t.shape[0], t.shape[1], -1) for t in lanes],
                      -1)
        return x.transpose(0, 1).reshape(x.shape[1], -1)

    g, w = per_ray(got[:3]), per_ray(want[:3])
    rows = lambda t: t.reshape(t.shape[0], -1) if t.dim() > 1 else t[:, None]
    d = torch.cat([(rows(a) - rows(b)).norm(dim=-1)
                   for a, b in zip(got[-n_walk:], want[-n_walk:])])
    n = torch.cat([rows(b).norm(dim=-1) for b in want[-n_walk:]])
    return med((g - w).norm(dim=-1), w.norm(dim=-1)), med(d, n)


def _n_walk(walk):
    return len(fm.walk_tensors(walk))


# The walk's bias gradients against the plain backward at the TPU kernels'
# rounding points (``kernel_grads=True``: db from the fp32 dz; autograd's
# own rule rounds dz first), the key's on the kernel forward's raw dots; the
# last layer's held. Sound: key <= 1.1e-4, value <= 1.5e-7; db from the
# bf16-rounded dz: key >= 1.7e-3, value >= 2.5e-4 (PERF.md, Findings).
STREAM_DB_REL = {"key": 5e-4, "value": 5e-5}


def _db_rels(got, ref, walk):
    """Relative error of each layer's bias gradient, from a stream
    backward's outputs (the walk's gradients last, walk_tensors order)."""
    n, b0 = len(walk.ws), len(got) - _n_walk(walk) + len(walk.ws)
    return [_rel(a, b) for a, b in zip(got[b0:b0 + n], ref[b0:b0 + n])]


@pytest.mark.parametrize("T,K", [(300, 20), (131, 1), (200, 7), (257, 33)])
def test_key_stream_bwd_wgmma_matches_plain(dev, T, K):
    """Row 5's bf16 backward on wgmma: ragged T (not a multiple of the
    128-ray block), K from 1 to 33, an all-dead ray (5), the cotangent kept
    on rays whose relu inputs stay 1e-5 rms from 0; one launch."""
    rng = np.random.default_rng(100 + T + K)
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    opts = ("relu", 5.0, 1e-6, torch.bfloat16)
    _, raw, ss = sa.key_stream_fwd(*args, *opts)
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    dattn = _firm(dattn, sa.rec_relu_margin(rec, rayo, rays, kw))
    before = sa.key_stream_bwd.launches
    got = sa.key_stream_bwd(*args, raw, ss, dattn, *opts)
    assert sa.key_stream_bwd.launches == before + 1
    want = sa.key_stream_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    got, want = _rec_lanes(got), _rec_lanes(want)
    _close_all(got, want, BWD_REL, f"key_stream_bwd T={T} K={K}")
    med = _median_rels(got, want, _n_walk(kw))
    ref = _rec_lanes(sa.key_stream_bwd_plain(*args, dattn, *opts,
                                             relu_on=raw > 0, raw_saved=raw,
                                             kernel_grads=True))
    db = _db_rels(got, ref, kw)
    print(f"key_stream_bwd T={T} K={K}: median ray d_rec {med[0]:.2e}, "
          f"median row of the walk gradients {med[1]:.2e}; db per layer at "
          "the kernel's rounding points " + ", ".join(f"{r:.1e}" for r in db))
    assert max(med) <= BWD_MEDIAN_REL and db[-1] <= STREAM_DB_REL["key"]
    assert float(got[0][:, 5].abs().max()) == 0.0     # the all-dead ray


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K", [(300, 20), (131, 1), (200, 7), (257, 33)])
def test_value_stream_bwd_wgmma_matches_plain(dev, T, K, normalize):
    """Row 6's bf16 backward on wgmma, as the key's above; ray 5 has no
    foreground mass (divides by 1: no gradient into its walk)."""
    rng = np.random.default_rng(200 + T + K)
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    args = (rec, rayo, rays, attn, vw)
    opts = (normalize, 1e-6, torch.bfloat16)
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    dfused = _firm(dfused, sa.rec_relu_margin(rec, rayo, rays, vw))
    before = sa.value_stream_bwd.launches
    got = sa.value_stream_bwd(*args, dfused, *opts)
    assert sa.value_stream_bwd.launches == before + 1
    want = sa.value_stream_bwd_plain(*args, dfused, *opts)
    got, want = _rec_lanes(got), _rec_lanes(want)
    _close_all(got, want, BWD_REL,
               f"value_stream_bwd T={T} K={K} normalize={normalize}")
    med = _median_rels(got, want, _n_walk(vw))
    ref = _rec_lanes(sa.value_stream_bwd_plain(*args, dfused, *opts,
                                               kernel_grads=True))
    db = _db_rels(got, ref, vw)
    print(f"value_stream_bwd T={T} K={K} normalize={normalize}: median ray "
          f"d_rec {med[0]:.2e}, median row of the walk gradients "
          f"{med[1]:.2e}; db per layer at the kernel's rounding points "
          + ", ".join(f"{r:.1e}" for r in db))
    assert max(med) <= BWD_MEDIAN_REL and db[-1] <= STREAM_DB_REL["value"]
    assert float(got[0][:, 5].abs().max()) == 0.0


@pytest.mark.parametrize("P,R,k,n_alive", [(3000, 777, 20, 2800),
                                           (4096, 64, 8, 4096),
                                           (2500, 130, 20, 12)])
def test_topk_stream_kernel_bit_equal_to_plain(dev, P, R, k, n_alive):
    """Streaming top-k: the kernel rounds like the plain version, so the
    rows are equal; fewer than k alive points fill the tail with dead /
    padded slots in index order in both."""
    from papr_tpu_torch.ops import pallas_topk as pt
    rng = np.random.default_rng(7)
    pts = torch.as_tensor(rng.normal(size=(P, 3)).astype(np.float32) * 3,
                          device=dev)
    alive = torch.zeros(P, dtype=torch.bool, device=dev)
    alive[torch.as_tensor(rng.permutation(P)[:n_alive], device=dev)] = True
    o = torch.as_tensor(rng.normal(size=3).astype(np.float32), device=dev)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=dev)
    ops = pt.stream_inputs(pts, alive, o, d, 1e-6)
    got = pt.topk_stream(*ops, k)
    want = pt.topk_stream_plain(*ops, k)
    assert got.dtype == torch.int32 and got.shape == (R, k)
    assert torch.equal(got, want)
    idx = pt.pallas_select_topk(pts, alive, o, d, k, 1e-6)
    assert int(idx.max()) < P
    if n_alive >= k:
        assert bool(alive[idx.long()].all())


def _score_inputs(rng, T, K, Dk, Dq, dm, dev):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    ek = t(rng.normal(size=(K, T, Dk))).to(torch.bfloat16)
    eq = t(rng.normal(size=(T, Dq))).to(torch.bfloat16)
    wk = t(rng.normal(size=(dm, Dk)) / math.sqrt(Dk))
    bk = t(rng.normal(size=dm) * 0.1)
    wq = t(rng.normal(size=(dm, Dq)) / math.sqrt(Dq))
    bq = t(rng.normal(size=dm) * 0.1)
    influ = t(rng.normal(size=(T, K)) * 0.5 + 1.0)
    alive = t(rng.random((T, K)) > 0.2)
    alive[3] = 0.0                                        # an all-dead ray
    return ek, eq, wk, bk, wq, bq, influ, alive


@pytest.mark.parametrize("T,K,Dk,Dq,dm,act", [(300, 20, 256, 256, 256, "relu"),
                                              (100, 7, 48, 40, 32, "none"),
                                              (64, 5, 33, 24, 32, "relu")])
def test_fused_scores_fwd_kernel_matches_plain(dev, T, K, Dk, Dq, dm, act):
    """bf16 projections, fp32 softmax: attn within 5e-3 absolute, the raw
    dots within 1e-2 relative Frobenius (summation order in the MMAs and a
    bf16 rounding of each projection); the all-dead ray is pure background."""
    from papr_tpu_torch.ops import fused_attn as fa
    args = _score_inputs(np.random.default_rng(11), T, K, Dk, Dq, dm, dev)
    got, raw = fa.fused_scores_fwd(*args, act, 5.0, torch.bfloat16,
                                   with_raw=True)
    want, raw_w = fa.fused_scores_plain(*args, act, 5.0, torch.bfloat16)
    assert got.shape == (T, K + 1) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-3
    assert _rel(raw, raw_w) <= 1e-2
    assert float(got[3, K]) == 1.0
    with pytest.raises(NotImplementedError, match="bf16 or fp32"):
        fa.fused_scores_fwd(*args, act, 5.0, torch.float16)


@pytest.mark.parametrize("T,K,Dk,Dq,dm,act", [(300, 20, 256, 256, 256, "relu"),
                                              (100, 7, 48, 40, 32, "none")])
def test_fused_scores_bwd_kernel_matches_plain(dev, T, K, Dk, Dq, dm, act):
    """Every gradient within 3e-2 relative Frobenius of the plain backward
    (bf16 on both sides; the plain version is given the kernel forward's
    relu pattern so both differentiate the same function)."""
    from papr_tpu_torch.ops import fused_attn as fa
    rng = np.random.default_rng(13)
    args = _score_inputs(rng, T, K, Dk, Dq, dm, dev)
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    _, raw = fa.fused_scores_fwd(*args, act, 5.0, torch.bfloat16,
                                 with_raw=True)
    got = fa.fused_scores_bwd(*args, dattn, act, 5.0, torch.bfloat16)
    want = fa.fused_scores_bwd_plain(*args, dattn, act, 5.0, torch.bfloat16,
                                     relu_on=raw > 0)
    names = ("d_embedk", "d_embedq", "dwk", "dbk", "dwq", "dbq", "d_influ")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert _rel(g, w) <= 3e-2, (name, _rel(g, w))
    assert float(got[6][3].abs().max()) == 0.0            # all-dead ray


def test_split_kernel_training_step_on_card(dev):
    """``fused_attn: true`` + ``topk_impl: pallas`` on the card: forward and
    gradients run through the embedder, score and top-k kernels and no plain
    version."""
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import pallas_topk as pt
    from papr_tpu_torch.model.papr import forward
    cfg = load_config(overrides={
        "use_amp": True, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}},
        "tpu": {"fused_attn": True, "topk_impl": "pallas"}})
    params, state = create_model(cfg, seed=0, device=dev)
    params["points_influ_scores"].normal_(generator=_gen(dev))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    fns = (pt.topk_stream, fm.fused_mlp, fm.fused_mlp_bwd,
           fa.fused_scores_fwd, fa.fused_scores_bwd)
    plains = (pt.topk_stream_plain, fm.fused_mlp_plain,
              fm.fused_mlp_bwd_plain, fa.fused_scores_plain,
              fa.fused_scores_bwd_plain)
    before = [f.launches for f in fns], [p.calls for p in plains]
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.optim import tree_leaves, tree_map
    live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            for k, v in params.items()}
    out = forward(live, state, cfg, torch.as_tensor(rayo, device=dev),
                  torch.as_tensor(rayd, device=dev),
                  policy=policy_from_config(cfg))
    leaves = tree_leaves(live["attn"]) + [live["points"],
                                          live["points_influ_scores"]]
    grads = torch.autograd.grad(out.square().mean(), leaves)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
    assert [f.launches for f in fns] == [b + n for b, n in
                                         zip(before[0], (1, 3, 3, 1, 1))]
    assert [p.calls for p in plains] == before[1]


# ------------------------------------- feature streams, query-folded stream ----
# The kernels of ``tpu.fused_attn: stream`` (raw feature tensors in,
# ``csrc/key_stream_feat.cu`` / ``csrc/value_stream_feat.cu``) and of
# ``tpu.query_fold`` (``csrc/key_stream_q.cu``), forward and backward, at two
# T (100 leaves an overhang tile), with an all-dead ray. Bounds as the
# record-native streams' above.

def _feat_case(rng, dev, T, K, dm=256):
    """Raw key features (K, T, 9) and value features (K, T, 6 + 64), (T, K)
    influence and alive (ray 5 all dead), and the flagship walks."""
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    xk = t(rng.normal(size=(K, T, 9)))
    xv = t(rng.normal(size=(K, T, 70)))
    influ = t(rng.normal(size=(T, K)))
    alive = rng.random((T, K)) > 0.2
    alive[5] = False
    qq = t(rng.normal(size=(T, dm)))
    kw = _walk(rng, posenc_plan((3, 3, 3), (6, 6, 6), 1, 2.0, 1.0, 0)[1], 5,
               256, 256, True, dev)
    vw = _walk(rng, posenc_plan((3, 3), (6, 6), 1, 2.0, 1.0, 64)[1], 8, 256,
               32, False, dev)
    wk = t(rng.normal(size=(dm, 256)) / 16)
    bk = t(rng.normal(size=dm) * 0.1)
    return xk, xv, qq, influ, t(alive), kw, vw, wk, bk


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_feat_kernels_match_plain(dev, T):
    """Row 8 forward and backward; dxk held per column group (the position
    columns are returned too: the caller detaches them), dinflu on its own."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(15)
    K = 20
    xk, _, qq, influ, alive, kw, _, wk, bk = _feat_case(rng, dev, T, K)
    args = (xk, qq, kw, wk, bk, influ, alive)
    opts = ("relu", 5.0, torch.bfloat16)
    attn, raw = sf.key_stream_feat_fwd(*args, *opts)
    attn_p, raw_p = sf.key_stream_feat_plain(*args, *opts)
    assert float((attn - attn_p).abs().max()) <= 5e-3
    assert _rel(raw, raw_p) <= 1e-2
    assert float(attn[5, K]) == 1.0                      # the all-dead ray
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    split = lambda g: [g[0][..., :3], g[0][..., 3:]] + list(g[1:])
    got = sf.key_stream_feat_bwd(*args, raw, dattn, *opts)
    want = sf.key_stream_feat_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(split(got), split(want), BWD_REL, f"key_stream_feat_bwd T={T}")
    assert float(got[0][:, 5].abs().max()) == 0.0        # no gradient there
    assert float(got[2][5].abs().max()) == 0.0
    assert float(got[0][..., :3].abs().max()) > 0.0


@pytest.mark.parametrize("T,normalize", [(256, True), (100, False)])
def test_value_stream_feat_kernels_match_plain(dev, T, normalize):
    """Row 9 forward and backward, with an all-dead ray (attention mass 0 on
    the foreground) and an overhang tile; dxv held per column group."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(16)
    K = 20
    _, xv, _, _, _, _, vw, _, _ = _feat_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    opts = (normalize, torch.bfloat16)
    fused = sf.value_stream_feat_fwd(xv, attn, vw, *opts)
    fused_p = sf.value_stream_feat_plain(xv, attn, vw, *opts)
    assert _rel(fused, fused_p) <= 1e-2
    assert float(fused[5].abs().max()) == 0.0
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    split = lambda g: [g[0][..., :6], g[0][..., 6:]] + list(g[1:])
    got = sf.value_stream_feat_bwd(xv, attn, vw, dfused, *opts)
    want = sf.value_stream_feat_bwd_plain(xv, attn, vw, dfused, *opts)
    _close_all(split(got), split(want), BWD_REL,
               f"value_stream_feat_bwd T={T} normalize={normalize}")
    assert float(got[0][:, 5].abs().max()) == 0.0
    assert float(got[1][:, K].abs().max()) == 0.0        # background column


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_q_kernels_match_plain(dev, T):
    """Row 7 forward and backward: the key stream with the query chain
    inside; d_rayd, dW_q, db_q and the query stack's gradients included."""
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    rng = np.random.default_rng(17)
    K = 20
    rec, rayo, rays, _, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    rayd = rays * t(rng.uniform(0.5, 2.0, size=(T, 1)))
    qw = _walk(rng, posenc_plan((3,), (6,), 1, 2.0, 1.0, 0)[1], 5, 256, 256,
               True, dev)
    wq = t(rng.normal(size=(256, 256)) / 16)
    bq = t(rng.normal(size=256) * 0.1)
    args = (rec, rayo, rays, rayd, kw, wk, bk, qw, wq, bq)
    opts = ("relu", 5.0, 1e-6, torch.bfloat16)
    attn, raw, ss, qq = sa.key_stream_q_fwd(*args, *opts)
    attn_p, raw_p, _, qq_p = sa.key_stream_q_plain(*args, *opts)
    assert _rel(qq, qq_p) <= 1e-2
    assert float((attn - attn_p).abs().max()) <= 5e-3
    assert _rel(raw, raw_p) <= 1e-2
    assert float(attn[5, K]) == 1.0
    # the same function as the unfolded kernel on the kernel's own qq (the
    # bf16 unfolded forward runs on wgmma: another summation order)
    attn_u, raw_u, ss_u = sa.key_stream_fwd(rec, rayo, rays, qq, kw, wk, bk,
                                            *opts)
    u_attn = float((attn - attn_u).abs().max())
    u_raw = _rel(raw, raw_u)
    print(f"key_stream_q T={T} against the unfolded forward: attn max abs "
          f"{u_attn:.2e}, raw {u_raw:.2e}")
    assert u_attn <= Q_UNFOLD_ABS and u_raw <= Q_UNFOLD_REL
    alive = (rec[..., 4] > 0.5).T
    assert torch.equal(ss, torch.where(alive, torch.clamp_min(raw, 0.0)
                                       * rec[..., 3].T, sa.NEG_BIG))
    dattn = t(rng.normal(size=(T, K + 1)))
    got = sa.key_stream_q_bwd(*args, qq, raw, ss, dattn, *opts)
    want = sa.key_stream_q_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(_rec_lanes(got), _rec_lanes(want), BWD_REL,
               f"key_stream_q_bwd T={T}")
    assert float(got[0][:, 5].abs().max()) == 0.0


@pytest.mark.parametrize("tpu,n_embed", [({"fused_attn": "stream"}, 1),
                                         ({"fused_attn": "streamrec",
                                           "query_fold": True}, 0)],
                         ids=["stream", "query_fold"])
def test_stream_modes_training_step_on_card(dev, tpu, n_embed):
    """``fused_attn: stream`` and ``streamrec`` + ``query_fold`` on the card:
    forward and gradients run through their kernels (one key and one value
    launch each way; the query embedder only where the query is not folded)
    and no plain version."""
    from papr_tpu_torch.model.papr import forward
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import stream_feat as sf
    from papr_tpu_torch.train.optim import tree_leaves, tree_map
    cfg = load_config(overrides={
        "use_amp": True, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}},
        "tpu": {"topk_impl": "cull", **tpu}})
    params, state = create_model(cfg, seed=0, device=dev)
    params["points_influ_scores"].normal_(generator=_gen(dev))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    if "query_fold" in tpu:
        fns = (sa.key_stream_q_fwd, sa.key_stream_q_bwd, sa.value_stream_fwd,
               sa.value_stream_bwd)
    else:
        fns = (sf.key_stream_feat_fwd, sf.key_stream_feat_bwd,
               sf.value_stream_feat_fwd, sf.value_stream_feat_bwd)
    plains = (sa.key_stream_q_plain, sa.key_stream_q_bwd_plain,
              sa.value_stream_plain, sa.value_stream_bwd_plain,
              sf.key_stream_feat_plain, sf.key_stream_feat_bwd_plain,
              sf.value_stream_feat_plain, sf.value_stream_feat_bwd_plain,
              fm.fused_mlp_plain, fm.fused_mlp_bwd_plain)
    before = ([f.launches for f in fns], [p.calls for p in plains],
              fm.fused_mlp.launches, fm.fused_mlp_bwd.launches)
    live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            for k, v in params.items()}
    out = forward(live, state, cfg, torch.as_tensor(rayo, device=dev),
                  torch.as_tensor(rayd, device=dev),
                  policy=policy_from_config(cfg))
    leaves = tree_leaves(live["attn"]) + [live["points"],
                                          live["points_influ_scores"],
                                          live["pc_feats"]]
    grads = torch.autograd.grad(out.square().mean(), leaves)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads[:-3])
    assert all(float(g.abs().max()) > 0 for g in grads[-3:])
    assert [f.launches for f in fns] == [b + 1 for b in before[0]]
    assert [p.calls for p in plains] == before[1]
    assert fm.fused_mlp.launches == before[2] + n_embed
    assert fm.fused_mlp_bwd.launches == before[3] + n_embed


# ------------------------------------------------------------ int8 walks ----
# The int8 kernels (``attend_eval_i8``, ``key_stream_i8_fwd``,
# ``value_stream_i8_fwd``; ``tpu.int8_eval`` / ``tpu.int8_train``) against
# their plain versions on the same quantization. The integer products are
# exact on both sides; they differ where an fp32 activation lands within an
# ulp of a rounding boundary (``sincosf`` against ``torch.sin``, LayerNorm
# summation order) and one quantized value flips by 1. Sound readings: fused
# <= 3.7e-4, attn max abs <= 4.5e-5 (self-calibrated), raw 5.8e-4. Planted
# faults: a layer quantizing the bf16-rounded activation reads attn 5.5e-3 to
# 1.4e-2 and raw 1.3e-2; truncation instead of rounding fused 2.9e-2 and up;
# the clamp at 128, a neighbour layer's dq and the bias before the
# dequantization 4e-2 and up (PERF.md, Findings). The eval attention also
# holds its median ray, which no flip reaches: fp32 noise on both sides of
# the same rounding points (the wgmma kernel reads <= 1.1e-7); its value
# rows left unrounded move every ray (4.4e-4 to 1.0e-3).

I8_FUSED_REL = 2e-3
I8_RAW_REL = 5e-3
I8_MEDIAN_REL = 1e-5

def _idx_form(rec):
    """(K, T, rp) gathered records as the (P, rp) record + (T, K) indices the
    index form takes."""
    K, T, rp = rec.shape
    idx = torch.arange(K * T, dtype=torch.int32, device=rec.device)
    return rec.reshape(K * T, rp), idx.reshape(K, T).T.contiguous()


@pytest.mark.parametrize("carried", [False, True],
                         ids=["self-calibrated", "quant_params"])
@pytest.mark.parametrize("T,K", [(256, 20), (100, 4)])
def test_attend_eval_i8_kernel_matches_plain(dev, T, K, carried):
    """Row 4q; T = 100 leaves an overhang tile. ``quant_params`` calibrated on
    records pulled towards the rays, so some activations clip at +-127 (pulled
    to 0.7 the key walk saturates, its output LayerNorm divides by a small
    deviation and one flip moves an attention weight by 5.4e-3)."""
    rng = np.random.default_rng(21)
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    qp = None
    if carried:
        near = rec.clone()
        near[..., :3] *= 0.9
        qp = tuple(sa.calibrate_walk(near, rayo, rays, w, 1e-6, torch.bfloat16)
                   for w in (kw, vw))
    record, idx = _idx_form(rec)
    args = (record, idx, rayo, rays, qq, kw, wk, bk, vw, "relu", 5.0, True,
            1e-6, torch.bfloat16, True, qp)
    before = (sa.attend_eval_i8.launches, sa.attend_eval_idx.launches,
              sa.attend_eval_plain.calls)
    fg, ag = sa.attend_eval_idx(*args)
    assert (sa.attend_eval_i8.launches, sa.attend_eval_idx.launches,
            sa.attend_eval_plain.calls) == (before[0] + 1, before[1],
                                            before[2])
    fw, aw = sa.attend_eval_plain(*args)
    print(f"attend_eval_i8 T={T} K={K} carried={carried}: fused rel "
          f"{_rel(fg, fw):.3e}, median ray {_median_ray_rel(fg, fw):.3e}, "
          f"attn max abs {float((ag - aw).abs().max()):.3e}")
    assert _rel(fg, fw) <= I8_FUSED_REL
    assert _median_ray_rel(fg, fw) <= I8_MEDIAN_REL
    assert float((ag - aw).abs().max()) <= 5e-3
    assert torch.isfinite(fg).all() and torch.isfinite(ag).all()
    assert float(ag[5, K]) == 1.0 and float(fg[5].abs().max()) == 0.0
    # not the bf16 kernel
    fb, _ = sa.attend_eval_idx(*args[:-2])
    assert _rel(fg, fb) > 1e-4


@pytest.mark.parametrize("T,K", [(256, 20), (100, 4)])
def test_key_stream_i8_kernel_matches_plain(dev, T, K):
    """Row 5q forward, then the unchanged backward kernel on the int8
    forward's saved dots and scores against the plain backward given the same
    dots (the bf16 recompute, straight-through)."""
    rng = np.random.default_rng(22)
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    opts = ("relu", 5.0, 1e-6, torch.bfloat16)
    before = (sa.key_stream_i8_fwd.launches, sa.key_stream_fwd.launches,
              sa.key_stream_plain.calls)
    attn, raw, ss = sa.key_stream_fwd(*args, *opts, int8=True)
    assert (sa.key_stream_i8_fwd.launches, sa.key_stream_fwd.launches,
            sa.key_stream_plain.calls) == (before[0] + 1, before[1],
                                           before[2])
    attn_p, raw_p, _ = sa.key_stream_plain(*args, *opts, int8=True)
    print(f"key_stream_i8_fwd T={T} K={K}: attn max abs "
          f"{float((attn - attn_p).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_p):.3e}")
    assert float((attn - attn_p).abs().max()) <= 5e-3
    assert _rel(raw, raw_p) <= I8_RAW_REL
    alive = (rec[..., 4] > 0.5).T
    assert torch.equal(ss, torch.where(alive, torch.clamp_min(raw, 0.0)
                                       * rec[..., 3].T, sa.NEG_BIG))
    assert float(attn[5, K]) == 1.0
    raw_b = sa.key_stream_fwd(*args, *opts)[1]
    assert _rel(raw, raw_b) > 1e-4                        # not the bf16 kernel
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    got = sa.key_stream_bwd(*args, raw, ss, dattn, *opts)
    want = sa.key_stream_bwd_plain(*args, dattn, *opts, relu_on=raw > 0,
                                   raw_saved=raw)
    _close_all(_rec_lanes(got), _rec_lanes(want), BWD_REL,
               f"key_stream_bwd after the int8 forward T={T}")


@pytest.mark.parametrize("T,K,normalize", [(256, 20, True), (100, 4, False)])
def test_value_stream_i8_kernel_matches_plain(dev, T, K, normalize):
    """Row 6q forward."""
    rng = np.random.default_rng(23)
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    args = (rec, rayo, rays, attn, vw)
    opts = (normalize, 1e-6, torch.bfloat16)
    before = (sa.value_stream_i8_fwd.launches, sa.value_stream_fwd.launches,
              sa.value_stream_plain.calls)
    fused = sa.value_stream_fwd(*args, *opts, int8=True)
    assert (sa.value_stream_i8_fwd.launches, sa.value_stream_fwd.launches,
            sa.value_stream_plain.calls) == (before[0] + 1, before[1],
                                             before[2])
    fused_p = sa.value_stream_plain(*args, *opts, int8=True)
    print(f"value_stream_i8_fwd T={T} K={K}: fused rel "
          f"{_rel(fused, fused_p):.3e}")
    assert _rel(fused, fused_p) <= I8_FUSED_REL
    assert float(fused[5].abs().max()) == 0.0
    assert _rel(fused, sa.value_stream_fwd(*args, *opts)) > 1e-4


def _bench_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "torch_int8_walk_microbench.py")
    spec = importlib.util.spec_from_file_location("torch_int8_walk_microbench",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layers", [3, 8])
def test_int8_walk_bench_kernels_match_plain(dev, layers):
    """Row 12: the microbenchmark's four variants against their plain
    versions, 212 rows (an overhang tile). ``int8raw`` is integers all the
    way: equal. The scaled variants take the same fp32 operations in the same
    order as their plain versions; bf16 differs by summation order."""
    mb = _bench_tool()
    x = torch.randn(212, mb.D, generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    ws, bs = mb.make_weights(layers, dev)
    bs = tuple(b + 0.05 for b in bs)
    for kind, tol in (("bf16", 1e-2), ("int8", 1e-5), ("int8s", 1e-5),
                      ("int8raw", 0.0)):
        n = mb.int8_walk_bench.launches, mb.walk_bench_plain.calls
        got = mb.int8_walk_bench(kind, x, ws, bs, 0.25)
        assert (mb.int8_walk_bench.launches, mb.walk_bench_plain.calls) == (
            n[0] + 1, n[1])
        want = mb.walk_bench_plain(kind, x, ws, bs, 0.25)
        assert got.shape == want.shape == (212, mb.D)
        assert float(want.abs().max()) > 0
        print(f"int8_walk_bench {kind} layers={layers}: rel "
              f"{_rel(got, want):.3e}, equal {torch.equal(got, want)}")
        assert _rel(got, want) <= tol, kind


def _small_model(dev, **tpu):
    cfg = load_config(overrides={
        "use_amp": True, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}},
        "tpu": {"topk_impl": "cull", "fused_attn": "streamrec", **tpu}})
    params, state = create_model(cfg, seed=0, device=dev)
    params["points_influ_scores"].normal_(generator=_gen(dev))
    return cfg, params, state


def test_int8_frame_on_card_launch_counts(dev):
    """``int8_eval``: a 64 x 64 frame in 32 x 32 tiles launches the int8
    one-shot kernel once per tile and the bf16 one never, calibrates once,
    runs no plain version, and stays close to the bf16 frame."""
    from papr_tpu_torch.model import papr as tpapr
    cfg, params, state = _small_model(dev, int8_eval=True)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    before = (sa.attend_eval_i8.launches, sa.attend_eval_idx.launches,
              sa.attend_eval_plain.calls, tpapr.eval_quant_params.calls,
              sa.walk_amax.calls)
    frame = render_frame(params, state, cfg, c2w, 60.0, 60.0, 64, 64, 32, 32)
    after = (sa.attend_eval_i8.launches, sa.attend_eval_idx.launches,
             sa.attend_eval_plain.calls, tpapr.eval_quant_params.calls,
             sa.walk_amax.calls)
    assert [a - b for a, b in zip(after, before)] == [4, 0, 0, 1, 2]
    cfg_b, _, _ = _small_model(dev)
    want = render_frame(params, state, cfg_b, c2w, 60.0, 60.0, 64, 64, 32, 32)
    assert frame.shape == (64, 64, 3) and frame.dtype == np.uint8
    diff = np.abs(frame.astype(np.int16) - want.astype(np.int16))
    print(f"int8 frame vs bf16 frame: max diff {int(diff.max())}, within "
          f"2/255 {float((diff.max(-1) <= 2).mean()):.4f}")
    assert float((diff.max(-1) <= 8).mean()) >= 0.99


def test_int8_train_step_on_card_launch_counts(dev):
    """``int8_train``: one forward + backward launches each int8 stream
    forward once, the bf16 forwards never, the unchanged backwards once, and
    no plain version."""
    from papr_tpu_torch.model.papr import forward
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.optim import tree_leaves, tree_map
    cfg, params, state = _small_model(dev, int8_train=True)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    fns = (sa.key_stream_i8_fwd, sa.value_stream_i8_fwd, sa.key_stream_bwd,
           sa.value_stream_bwd, sa.key_stream_fwd, sa.value_stream_fwd)
    plains = (sa.key_stream_plain, sa.value_stream_plain,
              sa.key_stream_bwd_plain, sa.value_stream_bwd_plain,
              fm.fused_mlp_plain, fm.fused_mlp_bwd_plain)
    before = [f.launches for f in fns], [p.calls for p in plains]
    live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            for k, v in params.items()}
    out = forward(live, state, cfg, torch.as_tensor(rayo, device=dev),
                  torch.as_tensor(rayd, device=dev),
                  policy=policy_from_config(cfg))
    leaves = tree_leaves(live["attn"]) + [live["points"],
                                          live["points_influ_scores"],
                                          live["pc_feats"]]
    grads = torch.autograd.grad(out.square().mean(), leaves)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads[-3:])
    assert [f.launches - b for f, b in zip(fns, before[0])] == [1, 1, 1, 1,
                                                                0, 0]
    assert [p.calls for p in plains] == before[1]


# ------------------------------------------------------------ fp32 walks ----
# The fp32 forms (use_amp: false: ``fused_mlp_f32`` / ``fused_mlp_f32_bwd``,
# ``attend_eval_f32``, ``key_stream_f32_fwd`` / ``_bwd``,
# ``value_stream_f32_fwd`` / ``_bwd``, ``wgrad_f32``) against their plain
# fp32 versions (TF32 off: true fp32 products) on the same inputs. The
# kernels' products are 3xTF32 (~2^-21 relative each) and sum in another
# order, so now and then a hidden relu's input lands on the other side of 0
# in one of them, which moves that token's gradient by O(1): the backward
# is held on the rows whose relu inputs all stay F32_MARGIN x rms away from
# 0 (``walk_relu_margin``; the cotangent is zero on the others), and the
# key stream's score relu is given the kernel forward's pattern. Bounds from
# planted faults (PERF.md, Findings): sound forwards <= 1.4e-6, attn <=
# 6.9e-7, backwards <= 3.6e-6, wgrad 1.7e-7; the products accumulated in the
# tensor cores' own accumulator read 5.5e-6-1.0e-5, 4.0e-6-6.0e-6, 1.0e-5-
# 4.0e-3 and 4.2e-6, a bf16 stash 1.4e-3-1.8e-3 (backwards), single-pass
# TF32, one cross term and bf16 rounding between layers 1.6e-4 and up.

F32_REL = 5e-6
F32_ATTN_ABS = 5e-6
F32_BWD_REL = 1e-5
# The key's fp32 backward on wgmma: the median ray of dqq (its forward
# recompute's products; sound 6.9e-7-1.2e-6, the products accumulated in the
# tensor cores' own accumulator across the whole K 3.3e-6-3.8e-6).
F32_DQQ_MEDIAN_REL = 2e-6
# ... and the median ray of d_rec[0:3], the geometry gradient, which the
# whole reverse walk feeds: sound 1.05e-6-2.31e-6, the reverse walk's
# products in the tensor cores' own accumulator 7.30e-6-9.31e-6, the
# forward and reverse products so 4.42e-6-6.32e-6 (PERF.md, Findings).
F32_GEO_MEDIAN_REL = 4e-6
F32_WGRAD_REL = 1e-6           # against the fp64 product
WGRAD_REL = 1e-5               # bf16 operands, against the fp64 product
F32_MARGIN = 1e-5
F32_STEP_GRAD_REL = 1e-2       # the whole step, flips included


def _firm(cot, margin):
    """The cotangent with the rows whose relu margin is under F32_MARGIN
    zeroed (at least half the rows kept)."""
    keep = margin >= F32_MARGIN
    assert float(keep.float().mean()) >= 0.5
    return torch.where(keep[:, None], cot, 0.0)


# The fp32 embedder on wgmma (rows 2f, 3f: fused_mlp_fwd_wgmma_f32_kernel,
# fused_mlp_bwd_wgmma_f32_kernel) also holds the forward's median row and
# the backward's input-side walk gradients (b0, the input LayerNorm's),
# which the whole reverse walk feeds: a fault only in the reverse products
# moves them where the last layer's gradients stay. Sound: median rows <=
# 8.0e-7, input-side gradients <= 1.44e-6; the products in the tensor cores'
# own accumulator across K read forwards 3.1e-6-5.7e-6 (median 3.07e-6) and
# input-side gradients 3.67e-6-3.94e-6, the reverse products alone so
# 6.4e-6-7.7e-6 (PERF.md, Findings).
F32_EMBED_MEDIAN_REL = 2e-6
F32_EMBED_IN_REL = 3e-6
# (stack, R, LayerNorms, grid): the query stack with an overhang tile of 36
# rows (R = 100, under a warpgroup) and on 200 tiles, a grid of 3 blocks
# taking several tiles each, the key and value stacks (the value's 142-wide
# encoding: its last 32-deep chunk reads E columns past it).
F32_EMBED_CASES = [("query", 1000, True, None), ("query", 100, False, None),
                   ("query", 25_600, True, None), ("query", 1000, True, 3),
                   ("key", 1100, True, None), ("value", 1100, False, None),
                   ("value", 777, False, 2)]


@pytest.mark.parametrize("stack,R,norm,grid", F32_EMBED_CASES)
def test_fused_mlp_f32_kernels_match_plain(dev, monkeypatch, stack, R, norm,
                                           grid):
    """Rows 2 and 3 in fp32 on wgmma against the plain fp32 versions; each
    one launch, and bit-equal on a second run."""
    rng = np.random.default_rng(11 + R)
    walk, x = _embed_case(rng, dev, stack, R, norm)
    if grid is not None:
        monkeypatch.setattr(fm, "wgmma_grid", lambda R: grid)
    d_out = int(walk.ws[-1].shape[1])
    before = fm.fused_mlp_f32.launches, fm.fused_mlp_bwd_f32.launches
    got = fm.fused_mlp_f32(x, walk)
    want = fm.fused_mlp_plain(x, walk, torch.float32)
    rel, med = _rel(got, want), _median_row_rels([got], [want])[0]
    name = f"fused_mlp_f32 {stack} R={R} norm={norm} grid={grid}"
    print(f"{name}: rel Frobenius {rel:.3e}, median row {med:.3e}")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert rel <= F32_REL and med <= F32_EMBED_MEDIAN_REL
    assert torch.equal(got, fm.fused_mlp_f32(x, walk))
    dy = torch.as_tensor(rng.normal(size=(R, d_out)).astype(np.float32),
                         device=dev)
    dy = _firm(dy, fm.walk_relu_margin(fm.encode_plain(x, walk.cols), walk))
    dx, grads = fm.fused_mlp_bwd_f32(x, dy, walk)
    dxp, gp = fm.fused_mlp_bwd_plain(x, dy, walk, torch.float32)
    _close_all([dx] + grads, [dxp] + gp, F32_BWD_REL, f"{name} bwd")
    n = len(walk.ws)
    ins = [_rel(grads[i], gp[i]) for i in
           [n] + ([2 * n, 2 * n + 1] if norm else [])]
    print(f"{name} bwd: input-side gradients (b0, ln_in) "
          + ", ".join(f"{r:.3e}" for r in ins))
    assert max(ins) <= F32_EMBED_IN_REL
    assert torch.equal(dx, fm.fused_mlp_bwd_f32(x, dy, walk)[0])
    assert (fm.fused_mlp_f32.launches, fm.fused_mlp_bwd_f32.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("normalize", [True, False])
def test_attend_eval_f32_kernel_matches_plain(dev, normalize):
    """Row 4 in fp32 on the flagship walks, with an all-dead ray."""
    rng = np.random.default_rng(12)
    P, T, K, dm = 500, 300, 20, 256
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    idx = rng.integers(0, P, size=(T, K)).astype(np.int32)
    dead = np.where(record[:, 4] == 0)[0]
    idx[5] = dead[:K]
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
            wk, bk, vw, "relu", 5.0, normalize, 1e-6)
    before = sa.attend_eval_f32.launches, sa.attend_eval_idx.launches
    fg, ag = sa.attend_eval_f32(*args)
    fw, aw = sa.attend_eval_plain(*args, torch.float32)
    print(f"attend_eval_f32: fused rel {_rel(fg, fw):.3e}, attn max abs "
          f"{float((ag - aw).abs().max()):.3e}")
    assert _rel(fg, fw) <= F32_REL
    assert float((ag - aw).abs().max()) <= F32_ATTN_ABS
    assert float(ag[5, K]) == 1.0 and float(fg[5].abs().max()) == 0.0
    assert (sa.attend_eval_f32.launches, sa.attend_eval_idx.launches) == (
        before[0] + 1, before[1])


def _f32_eval_case(rng, dev, T, K, dm=256):
    """The fp32 eval attention's inputs on the flagship walks, with a ray
    whose K points are all dead."""
    P = 500
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    idx = rng.integers(0, P, size=(T, K)).astype(np.int32)
    idx[5] = np.where(record[:, 4] == 0)[0][:K]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rays = rng.normal(size=(T, 3))
    kw = _walk(rng, sa.rec_pe_plan(True, (6, 6, 6), 1, 2.0, 1.0, 0), 5, 256,
               256, True, dev)
    vw = _walk(rng, sa.rec_pe_plan(False, (6, 6), 1, 2.0, 1.0, 64), 8, 256,
               32, False, dev)
    return (t(record), torch.as_tensor(idx, device=dev),
            t(np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3))),
            t(rays / np.linalg.norm(rays, axis=-1, keepdims=True)),
            t(rng.normal(size=(T, dm))), kw, t(rng.normal(size=(dm, 256)) / 16),
            t(rng.normal(size=dm) * 0.1), vw)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K", [(300, 20), (131, 8), (257, 30), (1, 8)])
def test_attend_eval_f32_wgmma_matches_plain(dev, T, K, normalize):
    """Row 4 in fp32 on wgmma (3xTF32, walk_wgmma.cuh's fp32 form) at T not
    a multiple of its 128-ray tile, K 8 / 20 / 30 (configs/nerfsyn/hotdog.yml
    selects 30): fused and attn to the fp32 bounds, the all-dead ray's
    background weight 1 and fused 0, one launch counted."""
    rng = np.random.default_rng(T + K)
    args = _f32_eval_case(rng, dev, max(T, 6), K)
    args = tuple(a[:T] if i in (1, 2, 3, 4) else a for i, a in enumerate(args))
    args = args + ("relu", 5.0, normalize, 1e-6)
    n = sa.attend_eval_f32.launches
    fg, ag = sa.attend_eval_f32(*args)
    fw, aw = sa.attend_eval_plain(*args, torch.float32)
    a_abs = float((ag - aw).abs().max())
    print(f"attend_eval_f32 wgmma T={T} K={K} normalize={normalize}: fused "
          f"rel {_rel(fg, fw):.3e}, attn max abs {a_abs:.3e}")
    assert sa.attend_eval_f32.launches == n + 1
    assert bool(torch.isfinite(fg).all() and torch.isfinite(ag).all())
    assert _rel(fg, fw) <= F32_REL and a_abs <= F32_ATTN_ABS
    if T > 5:
        assert float(ag[5, K]) == 1.0 and float(fg[5].abs().max()) == 0.0


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_f32_kernels_match_plain(dev, T):
    """Row 5 in fp32, forward and backward (T = 100: an overhang tile)."""
    rng = np.random.default_rng(13)
    K = 20
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    opts = ("relu", 5.0, 1e-6, torch.float32)
    attn, raw, ss = sa.key_stream_f32_fwd(*args)
    attn_p, raw_p, ss_p = sa.key_stream_plain(*args, *opts,
                                              relu_on=None)
    print(f"key_stream_f32_fwd T={T}: attn max abs "
          f"{float((attn - attn_p).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_p):.3e}")
    assert float((attn - attn_p).abs().max()) <= F32_ATTN_ABS
    assert _rel(raw, raw_p) <= F32_REL
    alive = (rec[..., 4] > 0.5).T
    assert torch.equal(ss, torch.where(alive, torch.clamp_min(raw, 0.0)
                                       * rec[..., 3].T, sa.NEG_BIG))
    assert float(attn[5, K]) == 1.0
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    dattn = _firm(dattn, sa.rec_relu_margin(rec, rayo, rays, kw))
    got = sa.key_stream_f32_bwd(*args, raw, ss, dattn)
    want = sa.key_stream_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"key_stream_f32_bwd T={T}")
    assert float(got[0][:, 5].abs().max()) == 0.0


@pytest.mark.parametrize("T,normalize", [(256, True), (100, False)])
def test_value_stream_f32_kernels_match_plain(dev, T, normalize):
    """Row 6 in fp32, forward and backward, with an all-dead ray and an
    overhang tile."""
    rng = np.random.default_rng(14)
    K = 20
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    args = (rec, rayo, rays, attn, vw)
    fused = sa.value_stream_f32_fwd(*args, normalize)
    fused_p = sa.value_stream_plain(*args, normalize, 1e-6, torch.float32)
    print(f"value_stream_f32_fwd T={T}: fused rel {_rel(fused, fused_p):.3e}")
    assert _rel(fused, fused_p) <= F32_REL
    assert float(fused[5].abs().max()) == 0.0
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    dfused = _firm(dfused, sa.rec_relu_margin(rec, rayo, rays, vw))
    got = sa.value_stream_f32_bwd(*args, dfused, normalize)
    want = sa.value_stream_bwd_plain(*args, dfused, normalize, 1e-6,
                                     torch.float32)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"value_stream_f32_bwd T={T} normalize={normalize}")
    assert float(got[0][:, 5].abs().max()) == 0.0


# The fp32 stream forwards on wgmma (walk_wgmma.cuh's fp32 operand form, the
# fp32 K3's walk): chip_smoke's phase 8 bounds (relative Frobenius of raw
# and fused, attn's max abs) and its median-ray bound; ragged T, K 1 / 7 /
# 20, a grid that splits tiles.
F32_FWD_REL = 1e-5
F32_FWD_ATTN_ABS = 3e-5
F32_FWD_MEDIAN_REL = 3e-6
F32_FWD_CASES = [(300, 20, None), (100, 7, None), (257, 1, None),
                 (300, 7, 2), (131, 20, 1)]


@pytest.mark.parametrize("score_act", ["relu", "none"])
@pytest.mark.parametrize("T,K,grid", F32_FWD_CASES)
def test_key_stream_f32_fwd_wgmma_matches_plain(dev, monkeypatch, T, K, grid,
                                                score_act):
    """Row 5's fp32 forward on wgmma against the plain fp32 forward: attn,
    raw and the median ray of raw at the fp32 bounds, the masked scores
    exactly from raw; an all-dead ray (5) and, with T > 128, a warpgroup of
    all-dead rays (64..127); one launch counted as fp32."""
    rng = np.random.default_rng(800 + T + K)
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    if T > 128:
        rec[:, 64:128, 4] = 0.0
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    before = sa.key_stream_f32_fwd.launches, sa.key_stream_fwd.launches
    attn, raw, ss = sa.key_stream_f32_fwd(*args, score_act, 5.0, 1e-6)
    assert (sa.key_stream_f32_fwd.launches, sa.key_stream_fwd.launches) == (
        before[0] + 1, before[1])
    attn_p, raw_p, _ = sa.key_stream_plain(*args, score_act, 5.0, 1e-6,
                                           torch.float32)
    a_abs = float((attn - attn_p).abs().max())
    med = _median_row_rels([raw], [raw_p])[0]
    print(f"key_stream_f32_fwd wgmma T={T} K={K} grid={grid} {score_act}: "
          f"attn max abs {a_abs:.2e}, raw {_rel(raw, raw_p):.2e}, median ray "
          f"raw {med:.2e}")
    assert bool(torch.isfinite(attn).all() and torch.isfinite(raw).all())
    assert a_abs <= F32_FWD_ATTN_ABS and _rel(raw, raw_p) <= F32_FWD_REL
    assert med <= F32_FWD_MEDIAN_REL
    alive = (rec[..., 4] > 0.5).T
    sact = torch.clamp_min(raw, 0.0) if score_act == "relu" else raw
    assert torch.equal(ss, torch.where(alive, sact * rec[..., 3].T,
                                       sa.NEG_BIG))
    dead = ~alive.any(dim=1)
    assert bool(dead[5]) and (T <= 128 or bool(dead[64:128].all()))
    assert bool((attn[dead, K] == 1.0).all())


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K,grid", F32_FWD_CASES)
def test_value_stream_f32_fwd_wgmma_matches_plain(dev, monkeypatch, T, K,
                                                  grid, normalize):
    """Row 6's fp32 forward on wgmma, as the key's above (the value rows
    fused unrounded): ray 5 and, with T > 128, rays 64..127 have no
    foreground mass; split tiles add two blocks' sums, in either order."""
    rng = np.random.default_rng(900 + T + K)
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    if T > 128:
        a[64:128, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, attn, vw, normalize)
    before = sa.value_stream_f32_fwd.launches, sa.value_stream_fwd.launches
    fused = sa.value_stream_f32_fwd(*args)
    assert (sa.value_stream_f32_fwd.launches,
            sa.value_stream_fwd.launches) == (before[0] + 1, before[1])
    fused_p = sa.value_stream_plain(*args, 1e-6, torch.float32)
    med = _median_row_rels([fused], [fused_p])[0]
    print(f"value_stream_f32_fwd wgmma T={T} K={K} grid={grid} normalize="
          f"{normalize}: fused {_rel(fused, fused_p):.2e}, median ray "
          f"{med:.2e}")
    assert bool(torch.isfinite(fused).all())
    assert _rel(fused, fused_p) <= F32_FWD_REL and med <= F32_FWD_MEDIAN_REL
    assert float(fused[5].abs().max()) == 0.0
    if T > 128:
        assert float(fused[64:128].abs().max()) == 0.0
    assert torch.equal(fused, sa.value_stream_f32_fwd(*args))


def _f32_fwd_case(dev, T, K, P, rp, kL, vL, n_feat, d_ff, dm, seed):
    """Records gathered k-major from a (P, rp) point table (alive 80 %),
    rays, qq and the walks at the given widths (key n_ff 3 or 5 with
    LayerNorms, value to 32), drawn on the card from a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    table = torch.zeros(P, rp, device=dev)
    table[:, :4] = rn(P, 4)
    table[:, 4] = (torch.rand(P, generator=g, device=dev) > 0.2).float()
    table[:, 5:5 + n_feat] = rn(P, n_feat)
    idx = torch.randint(0, P, (K, T), generator=g, device=dev)
    rec = table[idx].contiguous()
    rays = rn(T, 3)
    rays = rays / rays.norm(dim=-1, keepdim=True)
    rng = np.random.default_rng(seed)
    n_key = 5 if d_ff == 256 else 3
    n_val = 8 if d_ff == 256 else 3
    kw = _walk(rng, sa.rec_pe_plan(True, kL, 1, 2.0, 1.0, 0), n_key, d_ff,
               d_ff, True, dev)
    vw = _walk(rng, sa.rec_pe_plan(False, vL, 1, 2.0, 1.0, n_feat), n_val,
               d_ff, 32, False, dev)
    wk = rn(dm, d_ff) / math.sqrt(d_ff)
    return (rec, (rn(1, 3) * 3).expand(T, 3).contiguous(), rays, rn(T, dm),
            kw, wk, rn(dm) * 0.1, vw)


# (T, K, P, the walks' widths): phase 8's (Caterpillar's 180 x 180 patch,
# its 5,000 points and walks: key encoding 81, value 118 with 64 point
# features), configs/demo.yml's (key 3 x 64, d_model 64; value 3 layers on a
# 70-wide encoding with 16 point features, padded to 80: its last 32-deep
# chunk reads E columns past the encoding) and a narrow key whose 45-wide
# encoding (48 padded) does the same.
F32_FWD_WIDTHS = {
    "phase 8": (32_400, 20, 5_000, (4, 4, 4), (4, 4), 64, 256, 256),
    "demo": (4_096, 8, 400, (4, 4, 4), (4, 4), 16, 64, 64),
    "narrow key": (1_000, 8, 400, (2, 2, 2), (2, 2), 4, 64, 64),
}


@pytest.mark.parametrize("stream", ["key", "value"])
@pytest.mark.parametrize("widths", list(F32_FWD_WIDTHS))
def test_stream_f32_fwd_wgmma_at_shipped_widths(dev, widths, stream):
    """Both fp32 forwards against their plain fp32 versions at phase 8's
    shapes and at ``configs/demo.yml``'s widths (and a narrow key): the
    fp32 bounds and the median ray."""
    T, K, P, kL, vL, n_feat, d_ff, dm = F32_FWD_WIDTHS[widths]
    rec, rayo, rays, qq, kw, wk, bk, vw = _f32_fwd_case(
        dev, T, K, P, 128, kL, vL, n_feat, d_ff, dm, 31)
    kargs = (rec, rayo, rays, qq, kw, wk, bk, "relu", 5.0, 1e-6)
    if stream == "key":
        attn, raw, _ = sa.key_stream_f32_fwd(*kargs)
        attn_p, raw_p, _ = sa.key_stream_plain(*kargs, torch.float32)
        a_abs = float((attn - attn_p).abs().max())
        rel, med = _rel(raw, raw_p), _median_row_rels([raw], [raw_p])[0]
        print(f"key_stream_f32_fwd wgmma {widths} widths: attn max abs "
              f"{a_abs:.2e}, raw {rel:.2e}, median ray raw {med:.2e}")
        assert a_abs <= F32_FWD_ATTN_ABS
    else:
        attn = sa.key_stream_plain(*kargs, torch.float32)[0]
        args = (rec, rayo, rays, attn, vw, True)
        fused = sa.value_stream_f32_fwd(*args)
        fused_p = sa.value_stream_plain(*args, 1e-6, torch.float32)
        rel, med = _rel(fused, fused_p), _median_row_rels([fused],
                                                          [fused_p])[0]
        print(f"value_stream_f32_fwd wgmma {widths} widths: fused "
              f"{rel:.2e}, median ray {med:.2e}")
    assert rel <= F32_FWD_REL and med <= F32_FWD_MEDIAN_REL


def test_stream_f32_fwd_wgmma_against_k3(dev):
    """The fp32 stream forwards run the fp32 K3's walk code: on one ray
    set (the record gathered k-major by K3's indices), the key forward's
    attention is K3's bit for bit, and the value forward on K3's attention
    is K3's fused up to the fuse's arithmetic."""
    rng = np.random.default_rng(22)
    T, K, P = 300, 20, 900
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    record = torch.zeros(P, 128, device=dev)
    idx = torch.as_tensor(rng.integers(0, P, size=(T, K)), device=dev)
    record[idx.T.reshape(-1)] = rec.reshape(K * T, 128)
    rec = record[idx.T]                        # (K, T, 128), idx's rows
    fused3, attn3 = sa.attend_eval_f32(record, idx, rayo, rays, qq, kw, wk,
                                       bk, vw, "relu", 5.0, True, 1e-6)
    attn = sa.key_stream_f32_fwd(rec, rayo, rays, qq, kw, wk, bk, "relu",
                                 5.0, 1e-6)[0]
    a_abs = float((attn - attn3).abs().max())
    fused = sa.value_stream_f32_fwd(rec, rayo, rays, attn3, vw, True, 1e-6)
    print(f"fp32 stream forwards against the fp32 K3: attn max abs "
          f"{a_abs:.2e}, fused {_rel(fused, fused3):.2e}")
    assert torch.equal(attn, attn3)
    assert _rel(fused, fused3) <= 1e-5


# The fp32 stream backwards on wgmma (walk_wgmma_bwd.cuh in the fp32 operand
# form): T not a multiple of the 128-ray tile (and under it), K from 1 to
# 33, a grid smaller than the tiles (a tile split between two blocks, its
# second part's per-ray sums added by the combine kernel).
F32_BWD_CASES = [(300, 20, None), (131, 1, None), (200, 7, None),
                 (257, 33, None), (300, 7, 2), (131, 20, 1)]


@pytest.mark.parametrize("T,K,grid", F32_BWD_CASES)
def test_key_stream_f32_bwd_wgmma_matches_plain(dev, monkeypatch, T, K, grid):
    """Row 5's fp32 backward on wgmma against the plain fp32 backward on the
    held rays (relu inputs 1e-5 rms from 0; the plain softmax backward reads
    the kernel forward's raw dots, as the kernel does), every output at
    F32_BWD_REL, the median ray of dqq at F32_DQQ_MEDIAN_REL and of
    d_rec[0:3] at F32_GEO_MEDIAN_REL;
    an all-dead ray (5) and, with T > 128, a warpgroup of all-dead rays
    (64..127) get no gradient; one launch counted."""
    rng = np.random.default_rng(500 + T + K)
    rec, rayo, rays, qq, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    if T > 128:
        rec[:, 64:128, 4] = 0.0
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, qq, kw, wk, bk)
    _, raw, ss = sa.key_stream_f32_fwd(*args)
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    dattn = _firm(dattn, sa.rec_relu_margin(rec, rayo, rays, kw))
    before = sa.key_stream_f32_bwd.launches, sa.key_stream_bwd.launches
    got = sa.key_stream_f32_bwd(*args, raw, ss, dattn)
    assert (sa.key_stream_f32_bwd.launches, sa.key_stream_bwd.launches) == (
        before[0] + 1, before[1])
    want = sa.key_stream_bwd_plain(*args, dattn, "relu", 5.0, 1e-6,
                                   torch.float32, relu_on=raw > 0,
                                   raw_saved=raw)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"key_stream_f32_bwd wgmma T={T} K={K} grid={grid}")
    med = _median_row_rels([got[3]], [want[3]])[0]
    geo = _ray_median(got[0][..., :3], want[0][..., :3])
    rays_m = [_ray_median(a, b) for a, b in zip(got[1:3], want[1:3])]
    print(f"key_stream_f32_bwd wgmma T={T} K={K} grid={grid}: median ray "
          f"dqq {med:.2e}, d_rec[0:3] {geo:.2e}; (printed) d_rayo "
          f"{rays_m[0]:.2e}, d_rays {rays_m[1]:.2e}")
    assert med <= F32_DQQ_MEDIAN_REL and geo <= F32_GEO_MEDIAN_REL
    dead = [5] + (list(range(64, 128)) if T > 128 else [])
    assert float(got[0][:, dead].abs().max()) == 0.0


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K,grid", F32_BWD_CASES)
def test_value_stream_f32_bwd_wgmma_matches_plain(dev, monkeypatch, T, K,
                                                  grid, normalize):
    """Row 6's fp32 backward on wgmma, as the key's above; rays with no
    foreground mass (5, and 64..127 with T > 128) divide by 1: no gradient
    into their walks."""
    rng = np.random.default_rng(600 + T + K)
    rec, rayo, rays, _, _, vw, _, _ = _stream_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    if T > 128:
        a[64:128, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    _fwd_grid(monkeypatch, grid)
    args = (rec, rayo, rays, attn, vw)
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    dfused = _firm(dfused, sa.rec_relu_margin(rec, rayo, rays, vw))
    before = sa.value_stream_f32_bwd.launches, sa.value_stream_bwd.launches
    got = sa.value_stream_f32_bwd(*args, dfused, normalize)
    assert (sa.value_stream_f32_bwd.launches,
            sa.value_stream_bwd.launches) == (before[0] + 1, before[1])
    want = sa.value_stream_bwd_plain(*args, dfused, normalize, 1e-6,
                                     torch.float32)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"value_stream_f32_bwd wgmma T={T} K={K} grid={grid} "
               f"normalize={normalize}")
    dead = [5] + (list(range(64, 128)) if T > 128 else [])
    assert float(got[0][:, dead].abs().max()) == 0.0


@pytest.mark.parametrize("stream", ["key", "value"])
def test_stream_f32_bwd_wgmma_on_demo_widths(dev, stream):
    """The fp32 backwards on ``configs/demo.yml``'s narrow walks (key 3 x
    64, d_model 64; value 3 layers to 32, 16 point features; posenc orders
    4): one-pass layers and a 64-wide head, against the plain fp32
    backward on the held rays."""
    rng = np.random.default_rng(700)
    T, K, dm = 300, 8, 64
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rec = np.zeros((K, T, 32), np.float32)
    rec[..., :3] = rng.normal(size=(K, T, 3))
    rec[..., 3] = rng.normal(size=(K, T))
    rec[..., 4] = rng.random((K, T)) > 0.2
    rec[..., 5:21] = rng.normal(size=(K, T, 16))
    rec = t(rec)
    rayo = t(np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3)))
    rays = rng.normal(size=(T, 3))
    rays = t(rays / np.linalg.norm(rays, axis=-1, keepdims=True))
    if stream == "key":
        kw = _walk(rng, sa.rec_pe_plan(True, (4, 4, 4), 1, 2.0, 1.0, 0), 3,
                   64, 64, True, dev)
        args = (rec, rayo, rays, t(rng.normal(size=(T, dm))), kw,
                t(rng.normal(size=(dm, 64)) / 8), t(rng.normal(size=dm) * 0.1))
        _, raw, ss = sa.key_stream_f32_fwd(*args)
        dattn = _firm(t(rng.normal(size=(T, K + 1))),
                      sa.rec_relu_margin(rec, rayo, rays, kw))
        got = sa.key_stream_f32_bwd(*args, raw, ss, dattn)
        want = sa.key_stream_bwd_plain(*args, dattn, "relu", 5.0, 1e-6,
                                       torch.float32, relu_on=raw > 0,
                                       raw_saved=raw)
    else:
        vw = _walk(rng, sa.rec_pe_plan(False, (4, 4), 1, 2.0, 1.0, 16), 3,
                   64, 32, False, dev)
        a = rng.random((T, K + 1)).astype(np.float32)
        args = (rec, rayo, rays, t(a / a.sum(-1, keepdims=True)), vw)
        dfused = _firm(t(rng.normal(size=(T, 32))),
                       sa.rec_relu_margin(rec, rayo, rays, vw))
        got = sa.value_stream_f32_bwd(*args, dfused, True)
        want = sa.value_stream_bwd_plain(*args, dfused, True, 1e-6,
                                         torch.float32)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"{stream}_stream_f32_bwd wgmma demo widths")


# Every (da, db) the walks stash: the flagship's key (posenc 117 -> 128),
# query (39 -> 48) and value (142 -> 144, out 32) stacks, the score head
# (256 x 256), Caterpillar's key / query / value encodings (81 -> 96, 27 ->
# 32, 118 -> 128); a ragged N, and a short one.
WGRAD_SHAPES = [(5001, 128, 256), (5001, 256, 256), (5001, 144, 256),
                (5001, 256, 32), (5001, 48, 256), (5001, 96, 256),
                (5001, 32, 256), (777, 48, 32)]


def _wgrad_case(dev, N, da, db, cdt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(N, da, generator=g, device=dev).to(cdt)
    dz = torch.randn(N, db, generator=g, device=dev).to(cdt)
    return h, dz, (h.double().T @ dz.double()).float()


@pytest.mark.parametrize("N,da,db", WGRAD_SHAPES)
def test_wgrad_matches_fp64_product(dev, N, da, db):
    """The bf16 dW reduction (wgmma on TMA tiles) against the fp64 product
    of the same bf16 operands: every product is exact in fp32, so only the
    fp32 summation order separates them; two runs are bit-equal."""
    from papr_tpu_torch.kernels import build
    h, dz, want = _wgrad_case(dev, N, da, db, torch.bfloat16, 14)
    stream = torch.cuda.current_stream(dev).cuda_stream
    run = lambda: fm.wgrad(build.load(), h.data_ptr(), dz.data_ptr(), N, da,
                           db, dev, stream)
    before = fm.wgrad.launches
    got = run()
    print(f"wgrad N={N} {da}x{db}: rel Frobenius {_rel(got, want):.3e}")
    assert _rel(got, want) <= WGRAD_REL
    assert torch.equal(got, run())
    assert fm.wgrad.launches == before + 2


@pytest.mark.parametrize("N,da,db", WGRAD_SHAPES + [(5000, 256, 256)])
def test_wgrad_f32_matches_fp64_product(dev, N, da, db):
    """The fp32 dW reduction (3xTF32) against the fp64 product of the same
    fp32 operands: fp32-level error, where one TF32 pass reads ~2e-4; two
    runs are bit-equal."""
    from papr_tpu_torch.kernels import build
    h, dz, want = _wgrad_case(dev, N, da, db, torch.float32, 15)
    stream = torch.cuda.current_stream(dev).cuda_stream
    run = lambda: fm.wgrad_f32(build.load(), h.data_ptr(), dz.data_ptr(), N,
                               da, db, dev, stream)
    before = fm.wgrad_f32.launches
    got = run()
    print(f"wgrad_f32 N={N} {da}x{db}: rel Frobenius {_rel(got, want):.3e}")
    assert _rel(got, want) <= F32_WGRAD_REL
    assert torch.equal(got, run())
    assert fm.wgrad_f32.launches == before + 2


def test_wgmma_kernels_run_on_hgmma(dev):
    """The built library's SASS: the one-shot eval attention, the key /
    value stream forwards and backwards and the embedder forward and
    backward (bf16 and fp32), the fp32 feature stream forwards and both dW
    reductions issue Hopper's warpgroup MMAs (HGMMA); the int8 eval
    attention (both epilogues) its s8 ones (IGMMA)."""
    import os
    import shutil
    import subprocess
    from papr_tpu_torch.kernels import build
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    assert tool, "cuobjdump not found (set CUDA_HOME)"
    sass = subprocess.run([tool, "-sass", build.build()], capture_output=True,
                          text=True, check=True).stdout
    funcs = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body
    for kernel in ("attend_eval_wgmma_kernel", "key_fwd_wgmma_kernel",
                   "value_fwd_wgmma_kernel", "key_bwd_wgmma_kernel",
                   "value_bwd_wgmma_kernel", "fused_mlp_fwd_wgmma_kernel",
                   "fused_mlp_bwd_wgmma_kernel", "wgrad_bf16_kernel",
                   "wgrad_f32_kernel", "fused_mlp_fwd_wgmma_f32_kernel",
                   "fused_mlp_bwd_wgmma_f32_kernel", "key_fwd_wgmma_f32_kernel",
                   "value_fwd_wgmma_f32_kernel", "key_bwd_wgmma_f32_kernel",
                   "value_bwd_wgmma_f32_kernel", "key_feat_fwd_wgmma_f32_kernel",
                   "value_feat_fwd_wgmma_f32_kernel"):
        bodies = [b for n, b in funcs.items() if kernel in n]
        assert bodies, f"{kernel} not in the library"
        assert all("HGMMA" in b for b in bodies), f"{kernel}: no HGMMA"
    # The int8 eval attention's walk products: s8 warpgroup MMAs (IGMMA).
    bodies = [b for n, b in funcs.items() if "attend_eval_i8_wgmma_kernel" in n]
    assert len(bodies) == 2 and all("IGMMA" in b for b in bodies)


def _leaf_names(tree, path="") -> list:
    """Names of ``tree_leaves(tree)``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}[{i}]")]
    return [path]


def _fp32_model(dev, **tpu):
    cfg = load_config(overrides={
        "use_amp": False, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}},
        "tpu": {"topk_impl": "cull", **tpu}})
    params, state = create_model(cfg, seed=0, device=dev)
    params["points_influ_scores"].normal_(generator=_gen(dev))
    return cfg, params, state


def _gen(dev):
    """The influence scores' draw: a generator seeded once (the global CUDA
    generator is seeded differently in every process on the card's
    machine)."""
    return torch.Generator(device=dev).manual_seed(0)


def _held_rays(params, state, cfg, rayo, rayd):
    """1 for the rays whose walks' relu inputs all stay F32_MARGIN x rms from
    0 on the inputs the kernels are given in one forward (``model.papr
    .ray_margin``; phase 8's filter), else 0: two fp32 forwards that sum in
    different orders switch a relu whose input lies closer to 0 on one side
    or the other now and then, which moves that ray's gradient by O(1); a
    loss held to the other rays compares both paths at fp32 precision
    (``tools/torch_grad_spread.py --seeds``: the step's ``points`` tail,
    1.1e-4-5.0e-3 over 40 draws, falls to <= 8.3e-5 on these rays)."""
    from papr_tpu_torch.model.papr import ray_margin
    keep = ray_margin(params, state, cfg, rayo, rayd) >= F32_MARGIN
    assert float(keep.float().mean()) >= 0.5
    return keep.float()


def test_fp32_training_step_and_frame_on_card(dev):
    """``use_amp: false`` with ``fused_attn: auto`` on the card: one forward +
    backward runs the fp32 kernels (query embedder, key and value streams,
    each way once; wgrad_f32), a tiled frame the fp32 one-shot kernel once a
    tile, no bf16 kernel and no plain version; the gradients agree with the
    plain fp32 path (``fused_attn: false``) on the same model. The other
    modes' fp32 kernels: ``test_fp32_modes_training_step_on_card``."""
    from papr_tpu_torch.model.papr import forward
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.optim import tree_leaves, tree_map
    cfg, params, state = _fp32_model(dev)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    rayo, rayd = torch.as_tensor(rayo, device=dev), torch.as_tensor(rayd,
                                                                    device=dev)
    fns = (fm.fused_mlp_f32, fm.fused_mlp_bwd_f32, sa.key_stream_f32_fwd,
           sa.key_stream_f32_bwd, sa.value_stream_f32_fwd,
           sa.value_stream_f32_bwd, fm.wgrad_f32, fm.fused_mlp,
           fm.fused_mlp_bwd, sa.key_stream_fwd, sa.key_stream_bwd,
           sa.value_stream_fwd, sa.value_stream_bwd, fm.wgrad)
    plains = (fm.fused_mlp_plain, fm.fused_mlp_bwd_plain, sa.key_stream_plain,
              sa.key_stream_bwd_plain, sa.value_stream_plain,
              sa.value_stream_bwd_plain, sa.attend_eval_plain)

    keep = _held_rays(params, state, cfg, rayo, rayd)

    def grads_of(c):
        live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
                for k, v in params.items()}
        out = forward(live, state, c, rayo, rayd,
                      policy=policy_from_config(c))
        leaves = tree_leaves(live["attn"]) + [live["points"],
                                              live["points_influ_scores"],
                                              live["pc_feats"]]
        loss = (out.square() * keep.reshape(*out.shape[:-1], 1)).mean()
        return out, torch.autograd.grad(loss, leaves)

    before = [f.launches for f in fns], [p.calls for p in plains]
    out, grads = grads_of(cfg)
    torch.cuda.synchronize()
    got = [f.launches - b for f, b in zip(fns, before[0])]
    assert got[:6] == [1] * 6 and got[6] >= 1 and got[7:] == [0] * 7, got
    assert [p.calls for p in plains] == before[1]
    ref_cfg = load_config(overrides={
        "use_amp": False, "max_num_pts": 2048,
        "geoms": {"points": {"init_num": 2000, "select_k": 8}},
        "tpu": {"topk_impl": "cull", "fused_attn": False}})
    out_p, grads_p = grads_of(ref_cfg)
    print(f"fp32 step vs plain path: out rel {_rel(out, out_p):.3e}, grads "
          f"max rel {max(_rel(g, w) for g, w in zip(grads, grads_p)):.3e}")
    assert _rel(out, out_p) <= F32_REL
    assert max(_rel(g, w) for g, w in zip(grads, grads_p)) <= F32_STEP_GRAD_REL

    before = sa.attend_eval_f32.launches, sa.attend_eval_idx.launches
    frame = render_frame(params, state, cfg, c2w, 60.0, 60.0, 64, 64, 32, 32)
    assert frame.shape == (64, 64, 3) and frame.dtype == np.uint8
    assert (sa.attend_eval_f32.launches - before[0],
            sa.attend_eval_idx.launches - before[1]) == (4, 0)


# ------------------------------ fp32 forms of rows 7-10 and of the int8 walks
# ``key_stream_q_f32_*`` (row 7), ``key_stream_feat_f32_*`` (row 8),
# ``value_stream_feat_f32_*`` (row 9), ``fused_scores_f32_*`` (row 10) and
# the int8 walks' fp32 epilogue (``attend_eval_i8_f32``,
# ``key_stream_i8_f32_fwd``, ``value_stream_i8_f32_fwd``) against their plain
# fp32 versions, with the F32_* bounds of the fp32 walks above (backwards on
# the rays whose relu inputs all keep F32_MARGIN, the score relu given the
# kernel forward's pattern) and the int8 bounds for the int8 forms. Planted
# faults (PERF.md, Findings): a single TF32 pass in ``fused_attn.cu``, qq
# rounded to bf16, a bf16 dkk stash and value rows rounded to bf16 each read
# above these bounds.

I8_F32_FUSED_REL = 1e-3        # the int8 flips: 3.7e-4 with the bf16 epilogue
I8_F32_MEDIAN_REL = 1e-5       # the median ray: no flip, fp32 noise


def _median_ray_rel(got, want):
    """The median over rows of each row's relative error: a flipped
    quantized activation moves a few rays, a rounding in the epilogue all."""
    d, n = (got - want).norm(dim=-1), want.norm(dim=-1)
    return float((d[n > 0] / n[n > 0]).median())


def _tokens_margin(x, walk):
    """``walk_relu_margin`` of a walk over k-major raw features x (K, T, d)
    per ray: the smallest over the ray's K tokens."""
    K, T, d = x.shape
    enc = fm.encode_plain(x.reshape(K * T, d), walk.cols)
    return fm.walk_relu_margin(enc, walk).reshape(K, T).amin(dim=0)


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_q_f32_kernels_match_plain(dev, T):
    """Row 7 in fp32: qq, attn and raw; then every gradient (d_rayd, dW_q,
    db_q and the query stack's included) on the rays whose key and query
    relus keep their margin."""
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    rng = np.random.default_rng(31)
    K = 20
    rec, rayo, rays, _, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rayd = rays * t(rng.uniform(0.5, 2.0, size=(T, 1)))
    qw = _walk(rng, posenc_plan((3,), (4,), 1, 2.0, 1.0, 0)[1], 5, 256, 256,
               True, dev)
    wq = t(rng.normal(size=(256, 256)) / 16)
    bq = t(rng.normal(size=256) * 0.1)
    args = (rec, rayo, rays, rayd, kw, wk, bk, qw, wq, bq)
    opts = ("relu", 5.0, 1e-6, torch.float32)
    before = (sa.key_stream_q_f32_fwd.launches,
              sa.key_stream_q_f32_bwd.launches, sa.key_stream_q_fwd.launches,
              sa.key_stream_q_bwd.launches)
    attn, raw, ss, qq = sa.key_stream_q_fwd(*args, *opts)
    attn_p, raw_p, _, qq_p = sa.key_stream_q_plain(*args, *opts)
    print(f"key_stream_q_f32_fwd T={T}: qq rel {_rel(qq, qq_p):.3e}, attn "
          f"max abs {float((attn - attn_p).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_p):.3e}")
    assert _rel(qq, qq_p) <= F32_REL and _rel(raw, raw_p) <= F32_REL
    assert float((attn - attn_p).abs().max()) <= F32_ATTN_ABS
    assert float(attn[5, K]) == 1.0
    margin = torch.minimum(
        sa.rec_relu_margin(rec, rayo, rays, kw),
        fm.walk_relu_margin(fm.encode_plain(rayd, qw.cols), qw))
    dattn = _firm(t(rng.normal(size=(T, K + 1))), margin)
    got = sa.key_stream_q_bwd(*args, qq, raw, ss, dattn, *opts)
    want = sa.key_stream_q_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL,
               f"key_stream_q_f32_bwd T={T}")
    assert (sa.key_stream_q_f32_fwd.launches, sa.key_stream_q_f32_bwd.launches,
            sa.key_stream_q_fwd.launches, sa.key_stream_q_bwd.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])


# The fp32 folded key stream on wgmma (row 7f): the query chain on the fp32
# embedder walk with w_q as its head (query_head_fwd_wgmma_f32_kernel /
# query_head_bwd_wgmma_f32_kernel), the key on key_stream.cu's fp32 wgmma
# kernels. Phase 8's shapes (T = 32,400, K = 20), T not a multiple of the
# 128-ray tile, K 1 / 7 / 33, grids that split the key's tiles, points with
# alive = 0 (20 % of them, ray 5 all dead, with T > 128 a warpgroup of dead
# rays), query posencs of order 4 (27 columns) and 2 (15 columns: the first
# 32-deep chunk reads E columns past them): the forward at the fp32
# forwards' bounds, the query stack's median row (qq) at
# F32_EMBED_MEDIAN_REL, the backward at F32_BWD_REL on the held rays
# (d_rayd, dW_q, db_q and the query walk's gradients among them; the plain
# backward reads the kernel forward's raw dots, raw_saved, as the kernel
# does and as row 5f's cases do); the key's outputs bit for bit row 5f's
# (key_stream_f32_fwd / _bwd) on the fold's own qq and dattn.
F32_FOLD_CASES = [(32_400, 20, None, 4), (300, 20, None, 4),
                  (131, 1, None, 2), (257, 33, None, 4), (300, 7, 2, 2),
                  (131, 20, 1, 4)]


def _fold_case(rng, dev, T, K, qL):
    rec, rayo, rays, _, kw, _, wk, bk = _stream_case(rng, dev, T, K)
    if T > 128:
        rec[:, 64:128, 4] = 0.0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rayd = rays * t(rng.uniform(0.5, 2.0, size=(T, 1)))
    qw = _walk(rng, posenc_plan((3,), (qL,), 1, 2.0, 1.0, 0)[1], 5, 256, 256,
               True, dev)
    return (rec, rayo, rays, rayd, kw, wk, bk, qw,
            t(rng.normal(size=(256, 256)) / 16), t(rng.normal(size=256) * 0.1))


def _check_fold(dev, args, rng, name):
    """Row 7f forward and backward against the plain fp32 versions and the
    key's outputs against row 5f's on the fold's qq (see above); one call
    of each counted once."""
    rec, rayo, rays, rayd, kw, wk, bk, qw, _, _ = args
    K, T = rec.shape[:2]
    opts, f32 = ("relu", 5.0, 1e-6), torch.float32
    counters = (sa.key_stream_q_f32_fwd, sa.key_stream_q_f32_bwd,
                sa.key_stream_q_fwd, sa.key_stream_q_bwd,
                sa.key_stream_f32_fwd, sa.key_stream_f32_bwd)
    before = [c.launches for c in counters]
    attn, raw, ss, qq = sa.key_stream_q_f32_fwd(*args, *opts)
    attn_p, raw_p, _, qq_p = sa.key_stream_q_plain(*args, *opts, f32)
    a_abs = float((attn - attn_p).abs().max())
    med_q, med_raw = _median_row_rels([qq, raw], [qq_p, raw_p])
    print(f"{name} fwd: attn max abs {a_abs:.2e}, raw {_rel(raw, raw_p):.2e}, "
          f"qq {_rel(qq, qq_p):.2e}, median row qq {med_q:.2e}, median ray "
          f"raw {med_raw:.2e}")
    assert all(bool(torch.isfinite(x).all()) for x in (attn, raw, ss, qq))
    assert a_abs <= F32_FWD_ATTN_ABS and _rel(raw, raw_p) <= F32_FWD_REL
    assert _rel(qq, qq_p) <= F32_FWD_REL and med_q <= F32_EMBED_MEDIAN_REL
    assert med_raw <= F32_FWD_MEDIAN_REL
    dead = [5] + (list(range(64, 128)) if T > 128 else [])
    assert bool((attn[dead, K] == 1.0).all())
    k5 = sa.key_stream_f32_fwd(rec, rayo, rays, qq, kw, wk, bk, *opts)
    assert all(torch.equal(a, b) for a, b in zip((attn, raw, ss), k5))
    margin = torch.minimum(
        sa.rec_relu_margin(rec, rayo, rays, kw),
        fm.walk_relu_margin(fm.encode_plain(rayd, qw.cols), qw))
    dattn = _firm(torch.as_tensor(rng.normal(size=(T, K + 1)).astype(
        np.float32), device=dev), margin)
    got = sa.key_stream_q_f32_bwd(*args, qq, raw, ss, dattn, *opts)
    want = sa.key_stream_q_bwd_plain(*args, dattn, *opts, f32,
                                     relu_on=raw > 0, raw_saved=raw)
    _close_all(_rec_lanes(got), _rec_lanes(want), F32_BWD_REL, f"{name} bwd")
    assert float(got[0][:, dead].abs().max()) == 0.0
    g5 = sa.key_stream_f32_bwd(rec, rayo, rays, qq, kw, wk, bk, raw, ss,
                               dattn, *opts)
    nk = len(fm.walk_tensors(kw))
    key_q = got[:3] + got[4:6] + got[8:8 + nk]
    assert len(key_q) == len(g5) - 1
    assert all(torch.equal(a, b) for a, b in zip(key_q, g5[:3] + g5[4:]))
    assert [c.launches for c in counters] == [
        before[0] + 1, before[1] + 1, before[2], before[3], before[4] + 1,
        before[5] + 1]


@pytest.mark.parametrize("T,K,grid,qL", F32_FOLD_CASES)
def test_key_stream_q_f32_wgmma_matches_plain(dev, monkeypatch, T, K, grid,
                                              qL):
    """Row 7f on wgmma, forward and backward (see above)."""
    rng = np.random.default_rng(2000 + T + K)
    args = _fold_case(rng, dev, T, K, qL)
    _fwd_grid(monkeypatch, grid)
    _check_fold(dev, args, rng, f"key_stream_q_f32 wgmma T={T} K={K} "
                                f"grid={grid} qL={qL}")


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("T,K,grid,qL", [(300, 7, 2, 2), (131, 20, None, 2),
                                         (257, 33, None, 4)])
def test_key_stream_q_f32_wgmma_after_nan_shared_memory(
        dev, monkeypatch, smem_aid, direction, T, K, grid, qL):
    """Row 7f's cases above with every SM's shared memory set to NaN just
    before the query walk's kernel: forward, before each call of
    ``papr_key_stream_q_f32_fwd``, whose first kernel is the query head's
    (the key's forward after it meets the head's leftovers); backward,
    before each call of ``papr_key_stream_f32_bwd`` (the key's half) and
    again before each of ``papr_key_stream_q_f32_bwd`` (the query head's
    backward, launched alone). The query walk's tiles are zeroed at the
    start, so a 15-column query encoding's columns 16..31 meet zeros, and
    every output holds as above."""
    rng = np.random.default_rng(2100 + T + K)
    args = _fold_case(rng, dev, T, K, qL)
    _fwd_grid(monkeypatch, grid)
    entries = ([f"papr_key_stream_q_f32_{direction}"] if direction == "fwd"
               else ["papr_key_stream_f32_bwd", "papr_key_stream_q_f32_bwd"])
    survived = [_poison(monkeypatch, smem_aid, e) for e in entries]
    _check_fold(dev, args, rng, f"key_stream_q_f32 {direction} after NaN "
                                f"shared memory T={T} K={K} qL={qL}")
    for entry, check in zip(entries, survived):
        print(entry, check())


@pytest.mark.parametrize("T", [256, 100])
def test_key_stream_feat_f32_kernels_match_plain(dev, T):
    """Row 8 in fp32, forward and backward."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(32)
    K = 20
    xk, _, qq, influ, alive, kw, _, wk, bk = _feat_case(rng, dev, T, K)
    args = (xk, qq, kw, wk, bk, influ, alive)
    opts = ("relu", 5.0, torch.float32)
    before = (sf.key_stream_feat_f32_fwd.launches,
              sf.key_stream_feat_f32_bwd.launches,
              sf.key_stream_feat_fwd.launches)
    attn, raw = sf.key_stream_feat_fwd(*args, *opts)
    attn_p, raw_p = sf.key_stream_feat_plain(*args, *opts)
    print(f"key_stream_feat_f32_fwd T={T}: attn max abs "
          f"{float((attn - attn_p).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_p):.3e}")
    assert float((attn - attn_p).abs().max()) <= F32_ATTN_ABS
    assert _rel(raw, raw_p) <= F32_REL
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    dattn = _firm(dattn, _tokens_margin(xk, kw))
    split = lambda g: [g[0][..., :3], g[0][..., 3:]] + list(g[1:])
    got = sf.key_stream_feat_bwd(*args, raw, dattn, *opts)
    want = sf.key_stream_feat_bwd_plain(*args, dattn, *opts, relu_on=raw > 0)
    _close_all(split(got), split(want), F32_BWD_REL,
               f"key_stream_feat_f32_bwd T={T}")
    assert (sf.key_stream_feat_f32_fwd.launches,
            sf.key_stream_feat_f32_bwd.launches,
            sf.key_stream_feat_fwd.launches) == (before[0] + 1, before[1] + 1,
                                                 before[2])


@pytest.mark.parametrize("T,normalize", [(256, True), (100, False)])
def test_value_stream_feat_f32_kernels_match_plain(dev, T, normalize):
    """Row 9 in fp32, forward and backward, the value rows unrounded."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(33)
    K = 20
    _, xv, _, _, _, _, vw, _, _ = _feat_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    opts = (normalize, torch.float32)
    before = (sf.value_stream_feat_f32_fwd.launches,
              sf.value_stream_feat_f32_bwd.launches,
              sf.value_stream_feat_fwd.launches)
    fused = sf.value_stream_feat_fwd(xv, attn, vw, *opts)
    fused_p = sf.value_stream_feat_plain(xv, attn, vw, *opts)
    print(f"value_stream_feat_f32_fwd T={T}: fused rel "
          f"{_rel(fused, fused_p):.3e}")
    assert _rel(fused, fused_p) <= F32_REL
    assert float(fused[5].abs().max()) == 0.0
    dfused = torch.as_tensor(rng.normal(size=(T, 32)).astype(np.float32),
                             device=dev)
    dfused = _firm(dfused, _tokens_margin(xv, vw))
    split = lambda g: [g[0][..., :6], g[0][..., 6:]] + list(g[1:])
    got = sf.value_stream_feat_bwd(xv, attn, vw, dfused, *opts)
    want = sf.value_stream_feat_bwd_plain(xv, attn, vw, dfused, *opts)
    _close_all(split(got), split(want), F32_BWD_REL,
               f"value_stream_feat_f32_bwd T={T} normalize={normalize}")
    assert (sf.value_stream_feat_f32_fwd.launches,
            sf.value_stream_feat_f32_bwd.launches,
            sf.value_stream_feat_fwd.launches) == (before[0] + 1,
                                                   before[1] + 1, before[2])


# The fp32 feature stream forwards on wgmma (rows 8f / 9f fwd:
# key_feat_fwd_wgmma_f32_kernel, value_feat_fwd_wgmma_f32_kernel, the record
# streams' stream_fwd_wg with the raw feature rows as its token source):
# F32_FWD_CASES' T / K / grids, the record forwards' bounds, an all-dead ray
# and an all-dead warpgroup.

def _interpose(monkeypatch, name, wrap):
    """``build.load()`` returns the library with its entry point ``name``
    replaced by ``wrap(entry)``."""
    from papr_tpu_torch.kernels import build
    lib = build.load()

    class Interposed:
        def __getattr__(self, attr):
            fn = getattr(lib, attr)
            return wrap(fn) if attr == name else fn
    monkeypatch.setattr(build, "load", lambda: Interposed())


@pytest.mark.parametrize("score_act", ["relu", "none"])
@pytest.mark.parametrize("T,K,grid", F32_FWD_CASES)
def test_key_stream_feat_f32_fwd_wgmma_matches_plain(dev, monkeypatch, T, K,
                                                     grid, score_act):
    """Row 8's fp32 forward on wgmma against the plain fp32 forward: attn,
    raw and the median ray of raw at the fp32 bounds; the masked scores the
    kernel hands the softmax kernel exactly from raw, influence and alive;
    ray 5 and, with T > 128, rays 64..127 (a warpgroup) all dead; one
    launch counted as fp32."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(1800 + T + K)
    xk, _, qq, influ, alive, kw, _, wk, bk = _feat_case(rng, dev, T, K)
    if T > 128:
        alive[64:128] = 0.0
    _fwd_grid(monkeypatch, grid)
    args = (xk, qq, kw, wk, bk, influ, alive, score_act, 5.0)
    # The masked scores the kernel hands the softmax kernel: the entry
    # point's (T, K) buffer (its fifth argument from the end) is this one.
    ss = torch.full((T, K), float("nan"), device=dev)
    _interpose(monkeypatch, "papr_key_stream_feat_f32_fwd",
               lambda fn: lambda *a: fn(*a[:-5], ss.data_ptr(), *a[-4:]))
    before = (sf.key_stream_feat_f32_fwd.launches,
              sf.key_stream_feat_fwd.launches)
    attn, raw = sf.key_stream_feat_fwd(*args, torch.float32)
    assert (sf.key_stream_feat_f32_fwd.launches,
            sf.key_stream_feat_fwd.launches) == (before[0] + 1, before[1])
    attn_p, raw_p = sf.key_stream_feat_plain(*args, torch.float32)
    a_abs = float((attn - attn_p).abs().max())
    med = _median_row_rels([raw], [raw_p])[0]
    print(f"key_stream_feat_f32_fwd wgmma T={T} K={K} grid={grid} "
          f"{score_act}: attn max abs {a_abs:.2e}, raw {_rel(raw, raw_p):.2e}, "
          f"median ray raw {med:.2e}")
    assert bool(torch.isfinite(attn).all() and torch.isfinite(raw).all())
    assert a_abs <= F32_FWD_ATTN_ABS and _rel(raw, raw_p) <= F32_FWD_REL
    assert med <= F32_FWD_MEDIAN_REL
    live = alive > 0.5
    sact = torch.clamp_min(raw, 0.0) if score_act == "relu" else raw
    assert torch.equal(ss, torch.where(live, sact * influ, sa.NEG_BIG))
    dead = ~live.any(dim=1)
    assert bool(dead[5]) and (T <= 128 or bool(dead[64:128].all()))
    assert bool((attn[dead, K] == 1.0).all())


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("T,K,grid", F32_FWD_CASES)
def test_value_stream_feat_f32_fwd_wgmma_matches_plain(dev, monkeypatch, T, K,
                                                       grid, normalize):
    """Row 9's fp32 forward on wgmma, as the key's above (the value rows
    fused unrounded): ray 5 and, with T > 128, rays 64..127 have no
    foreground mass and read exactly 0; split tiles add two blocks' sums,
    in either order (a rerun is bit-equal); one launch counted as fp32."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(1900 + T + K)
    _, xv, _, _, _, _, vw, _, _ = _feat_case(rng, dev, T, K)
    a = rng.random((T, K + 1)).astype(np.float32)
    a[5, :K] = 0.0
    if T > 128:
        a[64:128, :K] = 0.0
    attn = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    _fwd_grid(monkeypatch, grid)
    args = (xv, attn, vw, normalize)
    before = (sf.value_stream_feat_f32_fwd.launches,
              sf.value_stream_feat_fwd.launches)
    fused = sf.value_stream_feat_f32_fwd(*args)
    assert (sf.value_stream_feat_f32_fwd.launches,
            sf.value_stream_feat_fwd.launches) == (before[0] + 1, before[1])
    fused_p = sf.value_stream_feat_plain(*args, torch.float32)
    med = _median_row_rels([fused], [fused_p])[0]
    print(f"value_stream_feat_f32_fwd wgmma T={T} K={K} grid={grid} "
          f"normalize={normalize}: fused {_rel(fused, fused_p):.2e}, median "
          f"ray {med:.2e}")
    assert bool(torch.isfinite(fused).all())
    assert _rel(fused, fused_p) <= F32_FWD_REL and med <= F32_FWD_MEDIAN_REL
    assert float(fused[5].abs().max()) == 0.0
    if T > 128:
        assert float(fused[64:128].abs().max()) == 0.0
    assert torch.equal(fused, sf.value_stream_feat_f32_fwd(*args))


@pytest.mark.parametrize("stream", ["key", "value"])
def test_stream_feat_f32_fwd_wgmma_at_caterpillar_widths(dev, stream):
    """Both fp32 feature forwards at phase 8's shapes and Caterpillar's
    widths (T = 32,400, K = 20; xk 9 columns, a key encoding of 81, 5 x
    256 with LayerNorms and w_k 256 x 256; xv 6 + 64 columns, a value
    encoding of 118, 8 layers to 32), drawn on the card from a seeded
    generator: the fp32 bounds and the median ray."""
    from papr_tpu_torch.ops import stream_feat as sf
    T, K, L, n_feat = 32_400, 20, 4, 64
    g = torch.Generator(device=dev).manual_seed(41)
    rn = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    rng = np.random.default_rng(41)
    if stream == "key":
        kw = _walk(rng, posenc_plan((3, 3, 3), (L, L, L), 1, 2.0, 1.0, 0)[1],
                   5, 256, 256, True, dev)
        alive = (torch.rand(T, K, generator=g, device=dev) > 0.2).float()
        args = (rn(K, T, 9), rn(T, 256), kw, rn(256, 256) / 16, rn(256) * 0.1,
                rn(T, K), alive, "relu", 5.0, torch.float32)
        attn, raw = sf.key_stream_feat_fwd(*args)
        attn_p, raw_p = sf.key_stream_feat_plain(*args)
        a_abs = float((attn - attn_p).abs().max())
        rel, med = _rel(raw, raw_p), _median_row_rels([raw], [raw_p])[0]
        print(f"key_stream_feat_f32_fwd wgmma at Caterpillar's widths: attn "
              f"max abs {a_abs:.2e}, raw {rel:.2e}, median ray raw {med:.2e}")
        assert a_abs <= F32_FWD_ATTN_ABS
    else:
        vw = _walk(rng, posenc_plan((3, 3), (L, L), 1, 2.0, 1.0, n_feat)[1], 8,
                   256, 32, False, dev)
        w = torch.rand(T, K + 1, generator=g, device=dev)
        args = (rn(K, T, 6 + n_feat), w / w.sum(-1, keepdim=True), vw, True,
                torch.float32)
        fused = sf.value_stream_feat_fwd(*args)
        fused_p = sf.value_stream_feat_plain(*args)
        rel, med = _rel(fused, fused_p), _median_row_rels([fused],
                                                          [fused_p])[0]
        print(f"value_stream_feat_f32_fwd wgmma at Caterpillar's widths: "
              f"fused {rel:.2e}, median ray {med:.2e}")
    assert rel <= F32_FWD_REL and med <= F32_FWD_MEDIAN_REL


@pytest.mark.parametrize("norm,grid", [(False, None), (True, None),
                                       (False, 2)])
def test_value_stream_feat_f32_fwd_one_hot_is_the_embedder(dev, monkeypatch,
                                                          norm, grid):
    """The value forward on a one-hot attention (slot 3, normalize off) is
    the fp32 embedder (row 2f: the same wg_walk) on the rows xv[3], bit for
    bit: the fuse adds one weight of 1 and K - 1 of 0 to each row, into a
    zeroed output (split tiles: a second part of 0)."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(1950 + int(norm))
    T, K, k0 = 300, 7, 3
    _, xv, _, _, _, _, vw, _, _ = _feat_case(rng, dev, T, K)
    if norm:
        vw = _walk(rng, vw.cols, 8, 256, 32, True, dev)
    onehot = torch.zeros(T, K + 1, device=dev)
    onehot[:, k0] = 1.0
    _fwd_grid(monkeypatch, grid)
    fused = sf.value_stream_feat_f32_fwd(xv, onehot, vw, False)
    rows = fm.fused_mlp_f32(xv[k0].contiguous(), vw)
    print(f"value_stream_feat_f32_fwd one-hot norm={norm} grid={grid}: max "
          f"abs against fused_mlp_f32 {float((fused - rows).abs().max()):.3e}")
    assert torch.equal(fused, rows)


QNAN = 0x7FC00000


@pytest.fixture(scope="module")
def smem_aid(tmp_path_factory):
    """tests/smem_fill.cu, a check aid that is no part of the port's
    library, built alone by nvcc into a temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    import ctypes
    import os
    import subprocess
    from papr_tpu_torch.kernels import build
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smem_fill.cu")
    so = str(tmp_path_factory.mktemp("smem_fill") / "libsmem_fill.so")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        so, src], capture_output=True, text=True)
    assert r.returncode == 0, (r.stdout + r.stderr)[-4000:]
    lib = ctypes.CDLL(so)
    I, P = ctypes.c_int, ctypes.c_void_p
    for name, args in (("papr_smem_fill", [I, P]),
                       ("papr_smem_probe", [I, P, P]),
                       ("papr_smem_words", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _poison(monkeypatch, aid, entry):
    """Just before each call of the entry point, on the launch's stream:
    every SM's shared memory set to NaN (papr_smem_fill), then read back by
    a kernel that only reads it (papr_smem_probe), so the entry's kernel is
    the next to find the fill. Returns a check to call after the calls: it
    fails unless each call found the fill whole on every SM, and says so."""
    from papr_tpu_torch.kernels import build
    words = aid.papr_smem_words()
    assert words > 0, f"papr_smem_words failed with code {-words}"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counts = torch.zeros(sms, dtype=torch.int32, device="cuda")
    calls = []

    def wrap(fn):
        def launch(*args):
            build.check(aid.papr_smem_fill(QNAN, args[-1]), "papr_smem_fill")
            build.check(aid.papr_smem_probe(QNAN, counts.data_ptr(),
                                            args[-1]), "papr_smem_probe")
            calls.append(entry)
            return fn(*args)
        return launch
    _interpose(monkeypatch, entry, wrap)

    def survived():
        torch.cuda.synchronize()
        n = len(calls)
        text = (f"{n} poisoned launches, the fill found on each SM "
                f"{int(counts.min())}-{int(counts.max())} of {n} x {words} "
                f"words, {sms} SMs")
        assert n >= 1 and bool((counts == n * words).all()), text
        return text
    return survived


@pytest.mark.parametrize("stream", ["key", "value"])
def test_stream_feat_f32_fwd_wgmma_after_nan_shared_memory(dev, monkeypatch,
                                                          smem_aid, stream):
    """Every SM's shared memory set to NaN just before each launch of the
    forward: its activation tiles are zeroed at the start, so the
    encoding's columns past its width that the first 32-deep chunk
    products read (a 45-wide key encoding: columns 48..63; the 142-wide
    value encoding: 144..159) meet zeros, and the outputs hold at the fp32
    bounds (with the zeroing taken out they read NaN)."""
    from papr_tpu_torch.ops import stream_feat as sf
    rng = np.random.default_rng(1990)
    T, K = 300, 7
    xk, xv, qq, influ, alive, _, vw, wk, bk = _feat_case(rng, dev, T, K)
    survived = _poison(monkeypatch, smem_aid,
                       f"papr_{stream}_stream_feat_f32_fwd")
    if stream == "key":
        kw = _walk(rng, posenc_plan((3, 3, 3), (2, 2, 2), 1, 2.0, 1.0, 0)[1],
                   5, 256, 256, True, dev)
        args = (xk, qq, kw, wk, bk, influ, alive, "relu", 5.0, torch.float32)
        got, want = sf.key_stream_feat_fwd(*args)[1], \
            sf.key_stream_feat_plain(*args)[1]
    else:
        a = torch.as_tensor(rng.random((T, K + 1)), dtype=torch.float32,
                            device=dev)
        args = (xv, a / a.sum(-1, keepdim=True), vw, True, torch.float32)
        got, want = sf.value_stream_feat_fwd(*args), \
            sf.value_stream_feat_plain(*args)
    print(f"{stream}_stream_feat_f32_fwd after NaN shared memory: "
          f"{survived()}; finite {bool(torch.isfinite(got).all())}, rel "
          f"{_rel(got, want):.2e}")
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= F32_FWD_REL


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_fused_mlp_f32_after_nan_shared_memory(dev, monkeypatch, smem_aid,
                                               direction):
    """The fp32 embedder (rows 2f / 3f) on the value stack, whose 142-wide
    encoding leaves columns 144..159 of its last 32-deep chunk to the
    zeroed tiles, launched right after every SM's shared memory is set to
    NaN: the outputs finite and at the fp32 bounds."""
    rng = np.random.default_rng(1995)
    walk, x = _embed_case(rng, dev, "value", 300, False)
    survived = _poison(monkeypatch, smem_aid,
                       f"papr_fused_mlp_f32_{direction}")
    name = f"fused_mlp_f32 {direction} after NaN shared memory"
    if direction == "fwd":
        got = [fm.fused_mlp_f32(x, walk)]
        want = [fm.fused_mlp_plain(x, walk, torch.float32)]
        tol = F32_REL
    else:
        dy = torch.as_tensor(rng.normal(size=(300, 32)).astype(np.float32),
                             device=dev)
        dy = _firm(dy, fm.walk_relu_margin(fm.encode_plain(x, walk.cols),
                                           walk))
        dx, grads = fm.fused_mlp_bwd_f32(x, dy, walk)
        dxp, gp = fm.fused_mlp_bwd_plain(x, dy, walk, torch.float32)
        got, want, tol = [dx] + grads, [dxp] + gp, F32_BWD_REL
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    print(f"{name}: {survived()}; finite {finite}")
    assert finite
    _close_all(got, want, tol, name)


@pytest.mark.parametrize("T,K,Dk,Dq,dm,act", [(300, 20, 256, 256, 256, "relu"),
                                              (100, 7, 48, 40, 32, "none")])
def test_fused_scores_f32_kernels_match_plain(dev, T, K, Dk, Dq, dm, act):
    """Row 10 in fp32: attn, raw and every gradient (fp32 d_embedk /
    d_embedq, dW through wgrad_f32); the score relu given the kernel
    forward's pattern."""
    from papr_tpu_torch.ops import fused_attn as fa
    rng = np.random.default_rng(34)
    args = [a.float() for a in _score_inputs(rng, T, K, Dk, Dq, dm, dev)]
    args[0] = torch.as_tensor(rng.normal(size=(K, T, Dk)).astype(np.float32),
                              device=dev)
    args[1] = torch.as_tensor(rng.normal(size=(T, Dq)).astype(np.float32),
                              device=dev)
    before = (fa.fused_scores_f32_fwd.launches,
              fa.fused_scores_f32_bwd.launches, fa.fused_scores_fwd.launches,
              fm.wgrad.launches)
    got, raw = fa.fused_scores_fwd(*args, act, 5.0, torch.float32,
                                   with_raw=True)
    want, raw_w = fa.fused_scores_plain(*args, act, 5.0, torch.float32)
    print(f"fused_scores_f32_fwd T={T}: attn max abs "
          f"{float((got - want).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_w):.3e}")
    assert float((got - want).abs().max()) <= F32_ATTN_ABS
    assert _rel(raw, raw_w) <= F32_REL
    assert float(got[3, K]) == 1.0
    dattn = torch.as_tensor(rng.normal(size=(T, K + 1)).astype(np.float32),
                            device=dev)
    g = fa.fused_scores_bwd(*args, dattn, act, 5.0, torch.float32)
    w = fa.fused_scores_bwd_plain(*args, dattn, act, 5.0, torch.float32,
                                  relu_on=raw > 0)
    assert g[0].dtype == torch.float32 and g[1].dtype == torch.float32
    _close_all(g, w, F32_BWD_REL, f"fused_scores_f32_bwd T={T}")
    assert float(g[6][3].abs().max()) == 0.0              # all-dead ray
    assert (fa.fused_scores_f32_fwd.launches, fa.fused_scores_f32_bwd.launches,
            fa.fused_scores_fwd.launches, fm.wgrad.launches) == (
        before[0] + 1, before[1] + 1, before[2], before[3])


def test_int8_walks_with_fp32_epilogue_match_plain(dev):
    """Rows 4q-6q beside fp32 compute: the int8 kernels with the fp32
    epilogue against the plain int8 walks with fp32 compute (the same
    calibration on both sides), whole outputs to the int8 flips' bounds and
    the median ray to fp32 noise (a bf16 rounding in the epilogue moves
    every ray)."""
    rng = np.random.default_rng(35)
    T, K = 256, 20
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    record, idx = _idx_form(rec)
    f32 = torch.float32
    qp = tuple(sa.calibrate_walk(rec, rayo, rays, w, 1e-6, f32)
               for w in (kw, vw))
    args = (record, idx, rayo, rays, qq, kw, wk, bk, vw, "relu", 5.0, True,
            1e-6)
    before = (sa.attend_eval_i8_f32.launches, sa.attend_eval_i8.launches,
              sa.key_stream_i8_f32_fwd.launches,
              sa.value_stream_i8_f32_fwd.launches)
    fg, ag = sa.attend_eval_idx(*args, f32, True, qp)
    fw, aw = sa.attend_eval_plain(*args, f32, True, qp)
    print(f"attend_eval_i8_f32: fused rel {_rel(fg, fw):.3e}, median ray "
          f"{_median_ray_rel(fg, fw):.3e}, attn max abs "
          f"{float((ag - aw).abs().max()):.3e}")
    assert _rel(fg, fw) <= I8_F32_FUSED_REL
    assert _median_ray_rel(fg, fw) <= I8_F32_MEDIAN_REL
    assert float((ag - aw).abs().max()) <= 5e-3
    sargs = (rec, rayo, rays, qq, kw, wk, bk)
    attn, raw, ss = sa.key_stream_fwd(*sargs, "relu", 5.0, 1e-6, f32, True)
    attn_p, raw_p, _ = sa.key_stream_plain(*sargs, "relu", 5.0, 1e-6, f32,
                                           int8=True)
    print(f"key_stream_i8_f32_fwd: attn max abs "
          f"{float((attn - attn_p).abs().max()):.3e}, raw rel "
          f"{_rel(raw, raw_p):.3e}, median ray "
          f"{_median_ray_rel(raw, raw_p):.3e}")
    assert float((attn - attn_p).abs().max()) <= 5e-3
    assert _rel(raw, raw_p) <= I8_RAW_REL
    assert _median_ray_rel(raw, raw_p) <= I8_F32_MEDIAN_REL
    fused = sa.value_stream_fwd(rec, rayo, rays, attn, vw, True, 1e-6, f32,
                                True)
    fused_p = sa.value_stream_plain(rec, rayo, rays, attn, vw, True, 1e-6,
                                    f32, True)
    print(f"value_stream_i8_f32_fwd: fused rel {_rel(fused, fused_p):.3e}, "
          f"median ray {_median_ray_rel(fused, fused_p):.3e}")
    assert _rel(fused, fused_p) <= I8_F32_FUSED_REL
    assert _median_ray_rel(fused, fused_p) <= I8_F32_MEDIAN_REL
    assert (sa.attend_eval_i8_f32.launches, sa.attend_eval_i8.launches,
            sa.key_stream_i8_f32_fwd.launches,
            sa.value_stream_i8_f32_fwd.launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3] + 1)


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_attend_eval_i8_after_nan_shared_memory(dev, monkeypatch, smem_aid,
                                                cdt):
    """Rows 4q / 4qf on wgmma launched right after every SM's shared memory
    is set to NaN: the int8 form reads no shared memory it has not written
    (the first layer's fragments past the encoding's width are zero, not
    read from E; an int8 product past a layer's depth reads the ring's next
    slot with zero fragments, which adds nothing whatever the slot holds);
    the outputs finite and at the int8 bounds, T = 300 (an overhang tile),
    K = 7."""
    rng = np.random.default_rng(2020)
    T, K = 300, 7
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    record, idx = _idx_form(rec)
    f32 = cdt == torch.float32
    survived = _poison(monkeypatch, smem_aid,
                       "papr_attend_eval_i8_f32" if f32
                       else "papr_attend_eval_i8")
    qp = tuple(sa.calibrate_walk(rec, rayo, rays, w, 1e-6, cdt)
               for w in (kw, vw))
    args = (record, idx, rayo, rays, qq, kw, wk, bk, vw, "relu", 5.0, True,
            1e-6, cdt, True, qp)
    fg, ag = sa.attend_eval_idx(*args)
    fw, aw = sa.attend_eval_plain(*args)
    finite = bool(torch.isfinite(fg).all() and torch.isfinite(ag).all())
    print(f"attend_eval_i8 ({'fp32' if f32 else 'bf16'} epilogue) after NaN "
          f"shared memory: {survived()}; finite {finite}, fused rel "
          f"{_rel(fg, fw):.3e}, median ray {_median_ray_rel(fg, fw):.3e}, "
          f"attn max abs {float((ag - aw).abs().max()):.3e}")
    assert finite
    assert _rel(fg, fw) <= (I8_F32_FUSED_REL if f32 else I8_FUSED_REL)
    assert _median_ray_rel(fg, fw) <= (I8_F32_MEDIAN_REL if f32
                                       else I8_MEDIAN_REL)
    assert float((ag - aw).abs().max()) <= 5e-3


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_attend_eval_i8_runs_on_the_int8_wgmma_kernel(dev, cdt):
    """One call of rows 4q / 4qf under the profiler: one device kernel of
    the eval attention, ``attend_eval_i8_wgmma_kernel`` in the epilogue's
    type, and no WMMA int8 kernel (``attend_eval_i8_kernel``) or bf16 /
    fp32 twin."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2021)
    T, K = 200, 5
    rec, rayo, rays, qq, kw, vw, wk, bk = _stream_case(rng, dev, T, K)
    record, idx = _idx_form(rec)
    args = (record, idx, rayo, rays, qq, kw, wk, bk, vw, "relu", 5.0, True,
            1e-6, cdt, True)
    sa.attend_eval_idx(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sa.attend_eval_idx(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    k3 = [n for n in names if "attend_eval" in n]
    print(f"attend_eval_i8 ({cdt}) kernels: {k3}")
    assert len(k3) == 1 and "attend_eval_i8_wgmma_kernel" in k3[0], names
    assert ("float" if cdt == torch.float32 else "bfloat16") in k3[0]
    assert not any("attend_eval_i8_kernel" in n for n in names)


@pytest.mark.parametrize("tpu", [{"fused_attn": "stream"},
                                 {"fused_attn": True}, {"fused_attn": "score"},
                                 {"query_fold": True}, {"int8_train": True}],
                         ids=["stream", "true", "score", "query_fold",
                              "int8_train"])
def test_fp32_modes_training_step_on_card(dev, tpu, request):
    """``use_amp: false`` under every other mode on the card: forward and
    gradients through the mode's fp32 kernels, no bf16 kernel and no plain
    version; the gradients agree with the plain fp32 path (int8_train: the
    straight-through int8 forward, held to the loss only)."""
    from papr_tpu_torch.model.papr import forward
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import stream_feat as sf
    from papr_tpu_torch.train.optim import tree_leaves, tree_map
    cfg, params, state = _fp32_model(dev, **tpu)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    rayo, rayd = torch.as_tensor(rayo, device=dev), torch.as_tensor(rayd,
                                                                    device=dev)
    f32 = (fm.fused_mlp_f32, fm.fused_mlp_bwd_f32, sa.key_stream_f32_fwd,
           sa.key_stream_f32_bwd, sa.value_stream_f32_fwd,
           sa.value_stream_f32_bwd, sa.key_stream_q_f32_fwd,
           sa.key_stream_q_f32_bwd, sf.key_stream_feat_f32_fwd,
           sf.key_stream_feat_f32_bwd, sf.value_stream_feat_f32_fwd,
           sf.value_stream_feat_f32_bwd, fa.fused_scores_f32_fwd,
           fa.fused_scores_f32_bwd, sa.key_stream_i8_f32_fwd,
           sa.value_stream_i8_f32_fwd)
    bf16 = (fm.fused_mlp, fm.fused_mlp_bwd, sa.key_stream_fwd,
            sa.key_stream_bwd, sa.value_stream_fwd, sa.value_stream_bwd,
            sa.key_stream_q_fwd, sa.key_stream_q_bwd, sf.key_stream_feat_fwd,
            sf.key_stream_feat_bwd, sf.value_stream_feat_fwd,
            sf.value_stream_feat_bwd, fa.fused_scores_fwd,
            fa.fused_scores_bwd, sa.key_stream_i8_fwd, sa.value_stream_i8_fwd,
            fm.wgrad)
    plains = (fm.fused_mlp_plain, fm.fused_mlp_bwd_plain, sa.key_stream_plain,
              sa.key_stream_bwd_plain, sa.value_stream_plain,
              sa.value_stream_bwd_plain, sa.key_stream_q_plain,
              sa.key_stream_q_bwd_plain, sf.key_stream_feat_plain,
              sf.key_stream_feat_bwd_plain, sf.value_stream_feat_plain,
              sf.value_stream_feat_bwd_plain, fa.fused_scores_plain,
              fa.fused_scores_bwd_plain)
    want = {"stream": (1, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0),
            "true": (3, 3) + (0,) * 10 + (1, 1, 0, 0),
            "score": (0,) * 12 + (1, 1, 0, 0),
            "query_fold": (0, 0, 0, 0, 1, 1, 1, 1) + (0,) * 8,
            "int8_train": (1, 1, 0, 1, 0, 1) + (0,) * 8 + (1, 1)}
    mode = request.node.callspec.id

    keep = _held_rays(params, state, cfg, rayo, rayd)

    def grads_of(c):
        live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
                for k, v in params.items()}
        out = forward(live, state, c, rayo, rayd,
                      policy=policy_from_config(c))
        leaves = tree_leaves(live["attn"]) + [live["points"],
                                              live["points_influ_scores"],
                                              live["pc_feats"]]
        loss = (out.square() * keep.reshape(*out.shape[:-1], 1)).mean()
        return out, torch.autograd.grad(loss, leaves)

    before = ([f.launches for f in f32], [f.launches for f in bf16],
              [p.calls for p in plains], fm.wgrad_f32.launches)
    out, grads = grads_of(cfg)
    torch.cuda.synchronize()
    got = tuple(f.launches - b for f, b in zip(f32, before[0]))
    assert got == want[mode], (mode, got)
    assert [f.launches for f in bf16] == before[1]
    assert [p.calls for p in plains] == before[2]
    assert fm.wgrad_f32.launches > before[3]
    cfg_p, _, _ = _fp32_model(dev, fused_attn=False)
    out_p, grads_p = grads_of(cfg_p)
    rels = [_rel(g, w) for g, w in zip(grads, grads_p)]
    names = _leaf_names(params["attn"], "attn") + [
        "points", "points_influ_scores", "pc_feats"]
    top = sorted(zip(rels, names), reverse=True)[:3]
    rel, worst = top[0]
    print(f"fp32 {mode} step vs plain path: out rel {_rel(out, out_p):.3e}, "
          f"grads max rel {rel:.3e}; largest: "
          + ", ".join(f"{n} {r:.3e}" for r, n in top))
    if mode == "int8_train":
        assert _rel(out, out_p) <= I8_F32_FUSED_REL * 10
    else:
        assert _rel(out, out_p) <= F32_REL
        assert rel <= F32_STEP_GRAD_REL, (worst, rel)

