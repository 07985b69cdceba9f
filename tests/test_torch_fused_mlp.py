"""The port's plain fused embedder against the JAX Pallas kernel
``fused_mlp(..., interpret=True)`` with an in-kernel posenc (``pe_desc``).

Tolerances: fp32 compute rtol 1e-5, atol 1e-6 (same formula, float sums in
another order). bf16 compute: activations round to bf16 between layers, and
a sum that lands on a rounding boundary in one framework and not the other
flips one bf16 value, which later layers carry on. Bound: relative
Frobenius error <= 2e-3, at most 1% of outputs differ at all, and no output
by more than 2**-4 (two bf16 ulps at the largest magnitudes here, < 8)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from papr_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from papr_tpu_torch.ops.fused_mlp import (Walk, fused_mlp, fused_mlp_plain,
                                          pack_walk, posenc_plan)

DIMS, LS, EXTRA = (3, 3), (3, 2), 5


def _case(norm: bool, n_layers=3, d_ff=32, d_out=24, T=300, seed=0):
    rng = np.random.default_rng(seed)
    d_raw, cols = posenc_plan(DIMS, LS, 1, 2.0, 1.0, EXTRA)
    d_enc = len(cols)
    dims = [d_enc] + [d_ff] * (n_layers - 1) + [d_out]
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
          .astype(np.float32) for i in range(n_layers)]
    bs = [rng.normal(size=dims[i + 1]).astype(np.float32) * 0.1
          for i in range(n_layers)]
    lns = None
    if norm:
        lns = [(rng.normal(size=d).astype(np.float32) * 0.2 + 1,
                rng.normal(size=d).astype(np.float32) * 0.1)
               for d in (d_enc, d_out)]
    x = rng.normal(size=(T, d_raw)).astype(np.float32) * 3
    return x, ws, bs, lns, cols


def _run(x, ws, bs, lns, cols, compute, last="none"):
    pe_desc = (DIMS, LS, 1, 2.0, 1.0, EXTRA)
    want = jax_fused_mlp(
        jnp.asarray(x), tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
        tuple(map(jnp.asarray, lns[0])) if lns else None,
        tuple(map(jnp.asarray, lns[1])) if lns else None,
        "relu", last, True, 512, pe_desc, compute)
    t = lambda a: torch.as_tensor(a)
    walk = Walk(tuple(map(t, ws)), tuple(map(t, bs)),
                tuple(map(t, lns[0])) if lns else None,
                tuple(map(t, lns[1])) if lns else None, "relu", last, cols)
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    before = fused_mlp_plain.calls
    got = fused_mlp(t(x), walk, cdt)
    assert fused_mlp_plain.calls == before + 1      # CPU tensor: plain path
    return got, np.asarray(want.astype(jnp.float32)), walk


@pytest.mark.parametrize("norm,last", [(True, "none"), (False, "relu")])
def test_fp32_matches_jax_kernel(norm, last):
    x, ws, bs, lns, cols = _case(norm)
    got, want, _ = _run(x, ws, bs, lns, cols, "float32", last)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bf16_matches_jax_kernel():
    x, ws, bs, lns, cols = _case(True, T=517, seed=1)
    got, want, _ = _run(x, ws, bs, lns, cols, "bfloat16")
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    assert np.abs(want).max() < 8
    assert np.linalg.norm(g - want) / np.linalg.norm(want) <= 2e-3
    assert (g != want).mean() <= 0.01
    assert np.abs(g - want).max() <= 2 ** -4


def test_kernel_layout_reproduces_plain_walk():
    """pack_walk's buffers, read back with the offsets csrc/walk.cuh uses
    (meta row, 16-padded widths, flat weights/biases, LayerNorm tables and
    posenc plan), give the plain walk's result: checks the Python side of
    the kernel interface without a card."""
    x, ws, bs, lns, cols = _case(True, seed=2)
    got, _, walk = _run(x, ws, bs, lns, cols, "float32")
    meta, w_all, b_all, ln, plan, pd = pack_walk(walk, len(cols), "cpu")
    n, d_enc, d_out, act, last_act, has_li, has_lo = meta[:7]
    assert pd == list(meta[7:8 + n]) and all(p % 16 == 0 for p in pd)
    w_off, b_off = meta[8 + n:8 + 2 * n], meta[8 + 2 * n:8 + 3 * n]
    plan = plan.reshape(3, pd[0])
    src, freq, kind = plan[0].long(), plan[1], plan[2]
    xt = torch.as_tensor(x)
    xg = xt[:, src.clamp_max(xt.shape[1] - 1)]
    enc = torch.where(kind == 0, xg, torch.where(kind == 1, torch.sin(xg * freq),
                                                 torch.cos(xg * freq)))
    enc[:, d_enc:] = 0

    def ln_rows(h, n_true, a, b):
        hv = h[:, :n_true]
        mu = hv.sum(-1, keepdim=True) / n_true
        d = hv - mu
        r = 1 / (torch.sqrt((d * d).sum(-1, keepdim=True) / (n_true - 1)) + 1e-6)
        out = torch.zeros_like(h)
        out[:, :n_true] = d * r * a[:n_true] + b[:n_true]
        return out

    h = ln_rows(enc, d_enc, ln[:pd[0]], ln[pd[0]:2 * pd[0]]) if has_li else enc
    for i in range(n):
        W = w_all[w_off[i]:w_off[i] + pd[i] * pd[i + 1]].float().reshape(
            pd[i], pd[i + 1])
        h = h @ W + b_all[b_off[i]:b_off[i] + pd[i + 1]]
        if (last_act if i == n - 1 else act) == 1:
            h = torch.clamp_min(h, 0)
    lo = ln[2 * pd[0]:]
    if has_lo:
        h = ln_rows(h, d_out, lo[:pd[-1]], lo[pd[-1]:])
    # the packed weights are bf16, so compare against a bf16-weight walk
    ref = fused_mlp_plain(xt, walk._replace(
        ws=tuple(w.to(torch.bfloat16).float() for w in walk.ws)),
        torch.float32)
    np.testing.assert_allclose(h[:, :d_out].numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(h[:, d_out:].abs().max()) == 0.0       # pad lanes stay 0


def test_pack_walk_sees_writes_through_data():
    """Packing again after an in-place write through ``.data`` (which leaves
    ``_version`` alone) gives the new values: a training step rewrites the
    weights this way, so a cache keyed on address and version would hand
    the kernels stale weights."""
    x, ws, bs, lns, cols = _case(True, seed=3)
    t = lambda a: torch.as_tensor(a.copy())
    walk = Walk(tuple(map(t, ws)), tuple(map(t, bs)), tuple(map(t, lns[0])),
                tuple(map(t, lns[1])), "relu", "none", cols)
    first = pack_walk(walk, len(cols), "cpu")
    version = walk.ws[0]._version
    walk.ws[0].data.copy_(walk.ws[0] * 2 + 1)
    walk.bs[1].data.add_(3.0)
    assert walk.ws[0]._version == version
    second = pack_walk(walk, len(cols), "cpu")
    meta, w_all, b_all, _, _, pd = second
    n = meta[0]
    w_off, b_off = meta[8 + n:8 + 2 * n], meta[8 + 2 * n:8 + 3 * n]
    w0 = w_all[w_off[0]:w_off[0] + pd[0] * pd[1]].reshape(pd[0], pd[1])
    d0, d1 = walk.ws[0].shape
    assert torch.equal(w0[:d0, :d1], walk.ws[0].to(torch.bfloat16))
    b1 = b_all[b_off[1]:b_off[1] + pd[2]]
    assert torch.equal(b1[:walk.bs[1].shape[0]], walk.bs[1])
    assert not torch.equal(first[1], second[1])
