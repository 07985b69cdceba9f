"""The host side of the bf16 fused embedder on wgmma (``csrc/fused_mlp.cu``
``papr_fused_mlp_fwd`` and ``csrc/fused_mlp_bwd.cu`` ``papr_fused_mlp_bwd``
on ``walk_wgmma.cuh`` / ``walk_wgmma_bwd.cuh``), on the CPU.

- ``pack_embed_wgmma``'s image unpacks exactly to the walk's weights: the
  forward layers, then (backward) W_l^T for l = n-1 .. 0, in the order a
  tile streams them (an unpacking written apart from the packer), for the
  query, key and value stacks and a narrow walk; its meta row, bias rows and
  LayerNorm table are ``pack_walk``'s; it follows the weights when they
  change; its size is the one the kernel's layer table computes.
- The bf16 wrappers reach the new entry points with their signature's
  argument count, the packed weights, their size and the persistent grid
  last; the backward's stash rows for R padded to the 128-row tile and one
  partial row a warp; the fp32 forms keep their entry points, which take
  the same tail (their image: ``test_torch_fused_mlp_f32_wgmma.py``).
- A walk the bf16 backward does not take is refused; the posenc segments
  are made on the device once; the stream wrappers launch on the one grid
  rule, ``fused_mlp.wgmma_grid``.
- ``model.papr.ray_margin`` (the card's fp32 step tests' filter) reads the
  walks the mode's kernels run, at most the query walk's own margin, and
  restores the entry points it records.
- The plain backward with ``kernel_grads=True`` (the reference of the
  card's bias-gradient checks) is JAX's Pallas bf16 backward (interpret
  mode) up to fp32 summation order (~1e-7, or a few rows where an order
  flips a bf16 rounding), where autograd's own rounding of dz moves every
  row (~2e-3).

Wrappers run on CPU tensors that read as CUDA tensors, against the stand-in
library of ``tests/test_torch_wgmma.py`` (nothing runs on a card).
"""

import math

import numpy as np
import pytest
import torch

from papr_tpu_torch.kernels import build
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops.fused_mlp import posenc_plan
from test_torch_wgmma import _card, _unpack, lib  # noqa: F401

# (posenc dims, orders, extras, layers, width, output width, LayerNorms):
# the flagship's query, key and value stacks (configs/default.yml) and a
# narrow walk.
STACKS = {
    "query": ((3,), (6,), 0, 5, 256, 256, True),
    "key": ((3, 3, 3), (6, 6, 6), 0, 5, 256, 256, True),
    "value": ((3, 3), (6, 6), 64, 8, 256, 32, False),
    "narrow": ((2,), (2,), 3, 2, 48, 16, True),
}


def _stack(name, seed=0):
    dims, Ls, extra, n, d_ff, d_out, norm = STACKS[name]
    d_raw, cols = posenc_plan(dims, Ls, 1, 2.0, 1.0, extra)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    w = [len(cols)] + [d_ff] * (n - 1) + [d_out]
    # Input-major views of output-major storage, as nn/mlp.py's parameters
    # reach the kernels (walk_from_params).
    ws = tuple(t(rng.normal(size=(w[i + 1], w[i]))).T for i in range(n))
    bs = tuple(t(rng.normal(size=w[i + 1]) * 0.1) for i in range(n))
    ln = lambda d: (t(1 + 0.2 * rng.normal(size=d)), t(0.1 * rng.normal(size=d)))
    walk = fm.Walk(ws, bs, ln(w[0]) if norm else None,
                   ln(w[-1]) if norm else None, "relu", "none", tuple(cols))
    return walk, d_raw


def _dims(walk, backward):
    """(in, out) of each streamed matrix, true widths, in stream order."""
    w = [len(walk.cols)] + [int(m.shape[1]) for m in walk.ws]
    fwd = list(zip(w[:-1], w[1:]))
    return fwd + ([(b, a) for a, b in reversed(fwd)] if backward else [])


def _image_elems(walk, backward):
    pd = lambda d: fm.round_up(d, 16)
    return sum(math.ceil(pd(a) / 64) * fm.wgmma_tile_n(pd(b)) * 64
               for a, b in _dims(walk, backward))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("name", list(STACKS))
def test_embed_pack_unpacks_to_the_walk(name, backward):
    walk, _ = _stack(name)
    meta, b_all, ln, plan, img, pd = fm.pack_embed_wgmma(walk, "cpu",
                                                         backward)
    assert img.dtype == torch.bfloat16
    assert img.numel() == _image_elems(walk, backward)
    mats = _unpack(img, _dims(walk, backward))
    n = len(walk.ws)
    for i, w in enumerate(walk.ws):
        assert torch.equal(mats[i], w.to(torch.bfloat16)), i
        if backward:
            assert torch.equal(mats[2 * n - 1 - i], w.T.to(torch.bfloat16)), i
    # Everything else is pack_walk's.
    meta_w, _, b_w, ln_w, plan_w, pd_w = fm.pack_walk(walk, len(walk.cols),
                                                      "cpu")
    assert meta == meta_w and pd == pd_w
    assert torch.equal(b_all, b_w) and torch.equal(ln, ln_w)
    assert torch.equal(plan, plan_w)


def test_embed_pack_follows_the_weights():
    walk, _ = _stack("narrow", 1)
    first = fm.pack_embed_wgmma(walk, "cpu", True)
    walk.ws[0].mul_(2.0)                 # in place, as an optimizer step
    walk.bs[1].add_(1.0)
    second = fm.pack_embed_wgmma(walk, "cpu", True)
    mats = _unpack(second[4], _dims(walk, True))
    assert torch.equal(mats[0], walk.ws[0].to(torch.bfloat16))
    assert torch.equal(mats[-1], walk.ws[0].T.to(torch.bfloat16))
    assert not torch.equal(first[1], second[1])
    assert torch.equal(second[1], fm.pack_walk(walk, len(walk.cols),
                                               "cpu")[2])


def _card_walk(walk):
    return fm.walk_with(walk, [_card(t) for t in fm.walk_tensors(walk)])


@pytest.mark.parametrize("R", [1, 300, 25_600])
@pytest.mark.parametrize("name", ["query", "value"])
def test_fused_mlp_bf16_reaches_the_wgmma_entry_point(lib, name, R):
    walk, d_raw = _stack(name)
    x = _card(torch.zeros(R, d_raw))
    n = fm.fused_mlp.launches
    y = fm.fused_mlp(x, _card_walk(walk), torch.bfloat16)
    assert fm.fused_mlp.launches == n + 1
    assert y.dtype == torch.bfloat16 and y.shape == (R, walk.ws[-1].shape[1])
    (entry, a), = lib.calls
    assert entry == "papr_fused_mlp_fwd"
    assert len(a) == len(build.SIGNATURES["papr_fused_mlp_fwd"])
    # ..., the pack, its bytes, the grid, the stream.
    assert a[-3] == 2 * _image_elems(walk, False)
    assert a[-2] == fm.wgmma_grid(R) == min(132, math.ceil(R / 128))


@pytest.mark.parametrize("R", [77, 300, 25_600])
@pytest.mark.parametrize("name", ["query", "key", "value"])
def test_fused_mlp_bwd_bf16_reaches_the_wgmma_entry_point(lib, name, R):
    walk, d_raw = _stack(name)
    x = _card(torch.zeros(R, d_raw))
    dy = _card(torch.zeros(R, int(walk.ws[-1].shape[1])))
    n = fm.fused_mlp_bwd.launches
    dx, grads = fm.fused_mlp_bwd(x, dy, _card_walk(walk), torch.bfloat16)
    assert fm.fused_mlp_bwd.launches == n + 1
    assert dx.shape == (R, d_raw)
    assert [tuple(g.shape) for g in grads] == [
        tuple(t.shape) for t in fm.walk_tensors(walk)]
    names = [c[0] for c in lib.calls]
    assert names == (["papr_fused_mlp_bwd"] + ["papr_wgrad"] * len(walk.ws)
                     + ["papr_colsum"])
    a = lib.calls[0][1]
    assert len(a) == len(build.SIGNATURES["papr_fused_mlp_bwd"])
    grid = fm.wgmma_grid(R)
    assert a[-3] == 2 * _image_elems(walk, True) and a[-2] == grid
    # Stash rows for R padded to the 128-row tile; 8 partial rows a block.
    tiles = math.ceil(R / 128)
    assert all(c[1][2] == tiles * 128 for c in lib.calls[1:-1])
    assert lib.calls[-1][1][1] == 8 * grid


@pytest.mark.parametrize("R", [100, 25_600])
@pytest.mark.parametrize("name", ["query", "key", "value"])
def test_fp32_embedder_keeps_its_entry_points(lib, name, R):
    """The fp32 forms keep their entry points, now with the wgmma tail: the
    fp32 image's bytes (hi / lo stages) and the persistent grid; the
    backward's fp32 stash rows for R padded to the 128-row tile, reduced by
    ``wgrad_f32``, and one partial row a warp."""
    walk, d_raw = _stack(name)
    d_out = int(walk.ws[-1].shape[1])
    x = _card(torch.zeros(R, d_raw))
    dy = _card(torch.zeros(R, d_out))
    n = fm.fused_mlp_f32.launches, fm.fused_mlp_bwd_f32.launches
    y = fm.fused_mlp(x, _card_walk(walk), torch.float32)
    dx, grads = fm.fused_mlp_bwd(x, dy, _card_walk(walk), torch.float32)
    assert (fm.fused_mlp_f32.launches, fm.fused_mlp_bwd_f32.launches) == (
        n[0] + 1, n[1] + 1)
    assert y.dtype == torch.float32 and y.shape == (R, d_out)
    assert dx.shape == (R, d_raw)
    names = [c[0] for c in lib.calls if "fused_mlp" in c[0]]
    assert names == ["papr_fused_mlp_f32_fwd", "papr_fused_mlp_f32_bwd"]
    assert [c[0] for c in lib.calls].count("papr_wgrad_f32") == len(walk.ws)
    assert "papr_wgrad" not in [c[0] for c in lib.calls]
    grid = fm.wgmma_grid(R)
    pd = lambda d: fm.round_up(d, 16)
    for (entry, a), bwd in zip(lib.calls[:1] + lib.calls[1:2], (False, True)):
        assert len(a) == len(build.SIGNATURES[entry])
        dims = _dims(walk, bwd)
        assert a[-3] == sum(math.ceil(pd(i) / 32) * math.ceil(pd(o) / 64)
                            * 16384 for i, o in dims)
        assert a[-2] == grid
    tiles = math.ceil(R / 128)
    wgrads = [c[1] for c in lib.calls if c[0] == "papr_wgrad_f32"]
    assert all(w[2] == tiles * 128 for w in wgrads)
    assert lib.calls[-1][1][1] == 8 * grid


def test_bwd_refuses_what_the_bf16_kernel_does_not_take(lib):
    walk, d_raw = _stack("narrow")
    cols = list(walk.cols)
    i = next(c for c, col in enumerate(cols) if col[2] == 1)
    cols[i], cols[i + 1] = cols[i + 1], cols[i]       # cos before its sin
    x = _card(torch.zeros(10, d_raw))
    dy = _card(torch.zeros(10, 16))
    with pytest.raises(NotImplementedError, match="partner"):
        fm.fused_mlp_bwd(x, dy, _card_walk(walk._replace(cols=tuple(cols))),
                         torch.bfloat16)
    wide = tuple((c, 0.0, 0) for c in range(100))
    walk = walk._replace(ws=(torch.zeros(100, 16),) + walk.ws[1:],
                         ln_in=None, cols=wide)
    with pytest.raises(NotImplementedError, match="96 sources"):
        fm.fused_mlp_bwd(_card(torch.zeros(10, 100)), dy, _card_walk(walk),
                         torch.bfloat16)
    assert lib.calls == []


def test_source_segments_are_made_once():
    _, cols = posenc_plan((3, 3), (6, 6), 1, 2.0, 1.0, 64)
    a = fm.source_segments(cols, 70, "cpu")
    assert fm.source_segments(list(cols), 70, torch.device("cpu")) is a


def test_stream_modules_share_the_grid_rule(lib, monkeypatch):
    """One grid rule, patched in one place (``fused_mlp.wgmma_grid``): the
    stream forwards and backwards launch on its grid, and the backwards
    size their partial rows by it."""
    from test_torch_stream_bwd_wgmma import _stream_args as bwd_args
    from test_torch_stream_fwd_wgmma import _stream_args as fwd_args
    assert not hasattr(sa, "wgmma_grid")
    monkeypatch.setattr(fm, "wgmma_grid", lambda T: 2)
    key, value, _ = fwd_args(True)
    sa.key_stream_fwd(*key, "relu", 5.0, 1e-6, torch.bfloat16)
    sa.value_stream_fwd(*value, True, 1e-6, torch.bfloat16)
    assert [a[-2] for _, a in lib.calls] == [2, 2]
    del lib.calls[:]
    key, value, _ = bwd_args(True)
    sa.key_stream_bwd(*key, "relu", 5.0, 1e-6, torch.bfloat16)
    sa.value_stream_bwd(*value, True, 1e-6, torch.bfloat16)
    walks = [a for n, a in lib.calls if n.endswith("stream_bwd")]
    assert [a[-5] for a in walks] == [2, 2]
    # 8 partial rows a block.
    assert [a[1] for n, a in lib.calls if n == "papr_colsum"] == [16, 16]


@pytest.mark.parametrize("norm,T", [(True, 256), (False, 300)])
def test_kernel_rounding_grads_are_the_tpu_kernels(norm, T):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from papr_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
    from test_torch_fused_mlp_bwd import DIMS, EXTRA, LS, _case

    x, dy, ws, bs, lns, cols = _case(norm, T, seed=T)
    # The cotangent of a bf16 output: bf16 values on both sides.
    dy = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16).astype(jnp.float32))
    pe_desc = (DIMS, LS, 1, 2.0, 1.0, EXTRA)

    def jloss(x, ws, bs, lns):
        y = jax_fused_mlp(x, ws, bs, lns[0] if lns else None,
                          lns[1] if lns else None, "relu", "none", True, 128,
                          pe_desc, "bfloat16")
        return jnp.sum(y.astype(jnp.float32) * dy)

    J = lambda a: jax.tree.map(jnp.asarray, a)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        J(x), J(tuple(ws)), J(tuple(bs)), J(tuple(map(tuple, lns))) if lns
        else None)
    want = [jg[0]] + list(jg[1]) + list(jg[2]) + (
        [t for ln in jg[3] for t in ln] if lns else [])
    t = torch.as_tensor
    walk = fm.Walk(tuple(map(t, ws)), tuple(map(t, bs)),
                   tuple(map(t, lns[0])) if lns else None,
                   tuple(map(t, lns[1])) if lns else None, "relu", "none",
                   cols)
    rel = lambda a, b: float(np.linalg.norm(a.numpy() - np.asarray(b))
                             / max(np.linalg.norm(np.asarray(b)), 1e-30))
    def rels(kernel_grads):
        dx, grads = fm.fused_mlp_bwd_plain(t(x), t(dy), walk, torch.bfloat16,
                                           kernel_grads=kernel_grads)
        return np.array([rel(a, b) for a, b in zip([dx] + grads, want)])

    kern = rels(True)
    auto = rels(False)
    # Both sides sum in fp32 in their own orders: now and then one flips a
    # bf16 rounding, which moves a few rows (up to ~5e-4 of an output here;
    # ~1e-7 without). Autograd's own rule rounds dz before each inner
    # layer's db and dX: every row moves (1.5e-3-3.8e-3).
    inner = slice(1 + len(ws), 2 * len(ws))          # db of layers 0 .. n-2
    assert max(kern) <= 2e-3
    assert np.mean(kern[inner]) <= 0.2 * np.mean(auto[inner])


@pytest.mark.parametrize("fused_attn", ["auto", False])
def test_ray_margin_reads_the_walks_the_kernels_run(fused_attn):
    """Under ``auto`` (the query embedder, the key and value streams) a
    ray's margin is at most its query walk's, and below it where a token's
    key or value walk comes nearer a relu flip; with no kernel on the path
    no walk is read."""
    from papr_tpu_torch.config import load_config
    from papr_tpu_torch.model.papr import (_query_walk, create_model,
                                           ray_margin)
    from papr_tpu_torch.ops.geometry import get_rays_np
    cfg = load_config(overrides={
        "max_num_pts": 512,
        "geoms": {"points": {"init_num": 500, "select_k": 8}},
        "tpu": {"topk_impl": "cull", "fused_attn": fused_attn}})
    params, state = create_model(cfg, seed=0, device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = map(torch.as_tensor, get_rays_np(8, 8, 8.0, 8.0, c2w[None]))
    entries = (fm.fused_mlp, sa.key_stream_fwd, sa.value_stream_fwd)
    m = ray_margin(params, state, cfg, rayo, rayd)
    assert (fm.fused_mlp, sa.key_stream_fwd, sa.value_stream_fwd) == entries
    assert m.shape == (64,)
    if fused_attn is False:
        assert bool(torch.isinf(m).all())
        return
    qw = _query_walk(params, cfg)
    qm = fm.walk_relu_margin(fm.encode_plain(rayd.reshape(-1, 3), qw.cols),
                             qw)
    assert bool(torch.isfinite(m).all()) and float(m.min()) >= 0.0
    assert bool((m <= qm).all()) and bool((m < qm).any())
