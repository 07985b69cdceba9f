"""The port's feature streams (``ops/stream_feat.py`` ``key_stream_scores``
/ ``value_stream_fuse``: forward, backward and the autograd functions, plain
versions on CPU tensors) against the JAX Pallas kernels in interpret mode,
on the shape lists of ``tests/test_stream_attn.py`` (overhang rows, K = 1,
with and without LayerNorm and renormalization) plus point-feature extras
and an all-dead ray. Inputs and weights are drawn with numpy from a seed and
go through both packages. fp32; forward rtol 1e-5 / atol 1e-6, gradients
rtol 3e-4 / atol 1e-6 (the JAX tests' own bounds). The value forward also
in bf16 (``BF16_FUSED_REL``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.nn.mlp import feedforward_init
from papr_tpu.ops.fused_mlp import _ff_lns
from papr_tpu.ops.stream_attn import key_stream_scores, value_stream_fuse
from papr_tpu_torch.convert import to_torch
from papr_tpu_torch.ops import stream_feat as sf
from papr_tpu_torch.ops.fused_mlp import (posenc_plan, walk_from_params,
                                          walk_tensors, walk_with)
from test_stream_attn import LS, PE, VLS, _ff_cfg

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=3e-4, atol=1e-6)


def np_ff(rng, d_in, d_out, ff_cfg):
    """A FeedForward tree of the JAX package's shapes with numpy-drawn
    leaves: weights N(0, 1 / fan_in), biases and LayerNorm tables moved off
    their 0 / 1 initial values."""
    ff = feedforward_init(jax.random.PRNGKey(0), d_in, d_out, ff_cfg)

    def draw(leaf):
        leaf = np.asarray(leaf)
        if leaf.ndim == 2:
            return (rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[1])
                    ).astype(np.float32)
        return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree.map(lambda l: jnp.asarray(draw(l)), ff)


def jwalk(ff):
    ln_in, ln_out = _ff_lns(ff)
    return (tuple(l["w"].T for l in ff["mlp"]["layers"]),
            tuple(l["bias"] for l in ff["mlp"]["layers"]), ln_in, ln_out)


def twalk(ff, ff_cfg, dims, Ls, extra):
    _, cols = posenc_plan(dims, Ls, 1, PE[0], PE[1], extra)
    return walk_from_params(to_torch(jax.tree.map(np.asarray, ff), "cpu"),
                            ff_cfg, cols)


def flat_walk_grads(ws, bs, ln_in, ln_out):
    return (list(ws) + list(bs) + [t for ln in (ln_in, ln_out)
                                   if ln is not None for t in ln])


def tt(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _key(seed, T, K, norm, extra, dm=16, d_out=32, dead_ray=None,
         compute="float32", dead_frac=0.2):
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    ff_cfg = _ff_cfg(32, d_out, 3, norm)
    d_in = sum(3 + 3 * 2 * l for l in LS) + extra
    ff = np_ff(rng, d_in, d_out, ff_cfg)
    xk = f32(rng.normal(size=(K, T, 9 + extra)))
    qq = f32(rng.normal(size=(T, dm)))
    wk = f32(rng.normal(size=(dm, d_out)) / np.sqrt(d_out))
    bk = f32(rng.normal(size=dm) * 0.1)
    influ = f32(rng.normal(size=(T, K)) * 0.5 + 1.0)
    alive = (rng.random((T, K)) > dead_frac).astype(np.float32)
    if dead_ray is not None:
        alive[dead_ray] = 0.0
    alive = f32(alive)
    jfn = lambda xk, qq, walk, wk, bk, influ: key_stream_scores(
        xk, qq, *walk, wk, bk, influ, alive,
        ((3, 3, 3), LS, 1, PE[0], PE[1], extra), ff_cfg.ff_act,
        ff_cfg.ff_last_act, "relu", 5.0, 32, True, compute)
    walk = twalk(ff, ff_cfg, (3, 3, 3), LS, extra)
    txk, tqq, twk, tbk, tinflu, talive = tt(xk, qq, wk, bk, influ, alive)
    return (jfn, (xk, qq, jwalk(ff), wk, bk, influ),
            (txk, tqq, walk, twk, tbk, tinflu, talive))


@pytest.mark.parametrize("T,K,norm,extra", [
    (64, 7, "none", 0), (100, 5, "layernorm", 0), (40, 1, "none", 0),
    (48, 11, "layernorm", 0), (37, 6, "layernorm", 4)])
def test_key_stream_forward_matches_jax(T, K, norm, extra):
    jfn, jargs, targs = _key(0, T, K, norm, extra, dead_ray=3)
    want = np.asarray(jfn(*jargs))
    attn, raw = sf.key_stream_feat_fwd(*targs, "relu", 5.0)
    assert raw.shape == (T, K)
    np.testing.assert_allclose(attn.numpy(), want, **FWD)
    np.testing.assert_allclose(
        sf.key_stream_scores(*targs, "relu", 5.0).numpy(), want, **FWD)
    np.testing.assert_allclose(attn.numpy()[3, -1], 1.0, atol=1e-6)


# The bf16 key forward (the compute dtype of row 8's bf16 kernel) against
# JAX's bf16 kernel on a seeded few percent of dead slots (alive = 0 on
# single (t, k)) and one all-dead ray: both walk in bf16 at the same rounding
# points and sum in another order, so a bf16 rounding may flip; attn within
# BF16_ATTN_ABS absolute (the folded key's bound in
# tests/test_torch_query_fold.py), every dead slot's attn exactly 0 and the
# all-dead ray pure background.
BF16_ATTN_ABS = 1e-3


@pytest.mark.parametrize("T,K,norm,extra", [(64, 7, "layernorm", 0),
                                            (37, 6, "none", 4)])
def test_key_stream_bf16_forward_with_dead_slots_matches_jax(T, K, norm,
                                                             extra):
    jfn, jargs, targs = _key(9, T, K, norm, extra, dead_ray=3,
                             compute="bfloat16", dead_frac=0.05)
    alive = targs[-1].numpy()
    assert 0 < (alive[:3] == 0).sum() + (alive[4:] == 0).sum() < 0.15 * T * K
    want = np.asarray(jfn(*jargs))
    attn, raw = sf.key_stream_feat_fwd(*targs, "relu", 5.0, torch.bfloat16)
    got = attn.numpy()
    assert got.shape == want.shape == (T, K + 1) and raw.shape == (T, K)
    assert float(np.abs(got - want).max()) <= BF16_ATTN_ABS
    assert float(np.abs(got[:, :K][alive == 0]).max()) == 0.0
    np.testing.assert_allclose(got[3, -1], 1.0, atol=1e-6)


@pytest.mark.parametrize("T,K,norm,extra", [
    (64, 6, "layernorm", 0), (90, 5, "none", 0), (37, 4, "layernorm", 4)])
def test_key_stream_backward_matches_jax(T, K, norm, extra):
    """Every gradient: dxk (positions included: the detach happens in the
    caller), dqq, dinflu, dW_k, db_k and the stack's."""
    jfn, jargs, targs = _key(1, T, K, norm, extra, dead_ray=5)
    rng = np.random.default_rng(2)
    ev = jnp.asarray(rng.normal(size=(K, T, 8)).astype(np.float32))
    tgt_f = jnp.asarray(rng.normal(size=(T, 8)).astype(np.float32))
    tgt_a = jnp.asarray(rng.normal(size=(T, 1)).astype(np.float32))

    def loss(attn):
        topk = attn[:, :-1]
        den = jnp.sum(topk, axis=-1, keepdims=True)
        fused = jnp.einsum("tk,ktc->tc", topk / jnp.where(den > 0, den, 1.0),
                           ev)
        return jnp.mean((fused - tgt_f) ** 2) + \
            jnp.mean((attn[:, -1:] - tgt_a) ** 2)

    attn, vjp = jax.vjp(jfn, *jargs)
    dattn = jax.grad(loss)(attn)
    dxk, dqq, dwalk, dwk, dbk, dinflu = vjp(dattn)
    want = [dxk, dqq, dinflu, dwk, dbk] + flat_walk_grads(*dwalk)
    tdattn = torch.tensor(np.asarray(dattn))
    got = sf.key_stream_feat_bwd(*targs, None, tdattn, "relu", 5.0)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))
    assert float(np.abs(np.asarray(dxk)[..., :3]).max()) > 0
    assert float(np.abs(np.asarray(dinflu)).max()) > 0
    # through autograd: the KeyStreamFeat function
    xk, qq, walk, wk, bk, influ, alive = targs
    leaves = [t.clone().requires_grad_() for t in (xk, qq, influ, wk, bk)]
    tw = [t.clone().requires_grad_() for t in walk_tensors(walk)]
    out = sf.key_stream_scores(leaves[0], leaves[1], walk_with(walk, tw),
                               leaves[3], leaves[4], leaves[2], alive, "relu",
                               5.0)
    out.backward(tdattn)
    for i, (l, b) in enumerate(zip(leaves + tw, want)):
        np.testing.assert_allclose(l.grad.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"autograd {i}")


def _value(seed, T, K, norm, extra, d_out=24, dead_ray=None,
           compute="float32"):
    rng = np.random.default_rng(seed)
    ff_cfg = _ff_cfg(32, d_out, 3, norm)
    d_in = sum(3 + 3 * 2 * l for l in VLS) + extra
    ff = np_ff(rng, d_in, d_out, ff_cfg)
    xv = jnp.asarray(rng.normal(size=(K, T, 6 + extra)).astype(np.float32))
    a = np.exp(rng.normal(size=(T, K + 1)))
    if dead_ray is not None:
        a[dead_ray, :K] = 0.0
    attn = jnp.asarray((a / a.sum(-1, keepdims=True)).astype(np.float32))
    jfn = lambda xv, attn, walk, renorm: value_stream_fuse(
        xv, attn, *walk, ((3, 3), VLS, 1, PE[0], PE[1], extra),
        ff_cfg.ff_act, ff_cfg.ff_last_act, renorm, 32, True, compute)
    walk = twalk(ff, ff_cfg, (3, 3), VLS, extra)
    return ff_cfg, jfn, (xv, attn, jwalk(ff)), tt(xv, attn) + [walk]


@pytest.mark.parametrize("T,K,norm,extra,renorm", [
    (64, 7, "layernorm", 0, True), (100, 5, "none", 0, True),
    (40, 1, "layernorm", 0, False), (48, 11, "none", 0, False),
    (37, 6, "none", 6, True)])
def test_value_stream_forward_matches_jax(T, K, norm, extra, renorm):
    _, jfn, jargs, targs = _value(3, T, K, norm, extra, dead_ray=3)
    want = np.asarray(jfn(*jargs, renorm))
    np.testing.assert_allclose(
        sf.value_stream_feat_fwd(*targs, renorm).numpy(), want, **FWD)
    np.testing.assert_allclose(
        sf.value_stream_fuse(*targs, renorm).numpy(), want, **FWD)
    assert float(np.abs(want[3]).max()) == 0.0           # the all-dead ray


# bf16 compute: JAX's Pallas kernel in interpret mode with compute
# "bfloat16" against the port's plain bf16 forward, the yardstick of the
# bf16 wgmma kernel on the card. Both round the walk's activations and the
# value rows to bf16 at the same points; their fp32 sums of bf16 products
# differ in order, so now and then one activation rounds to the bf16
# neighbour: fused relative Frobenius <= 1e-4 (these cases read <= 6.9e-8:
# no flip), and the all-dead ray exactly 0.
BF16_FUSED_REL = 1e-4


@pytest.mark.parametrize("T,K,norm,extra,renorm", [
    (48, 5, "layernorm", 0, True), (37, 3, "none", 6, False)])
def test_value_stream_bf16_forward_matches_jax(T, K, norm, extra, renorm):
    _, jfn, jargs, targs = _value(6, T, K, norm, extra, dead_ray=3,
                                  compute="bfloat16")
    want = np.asarray(jfn(*jargs, renorm))
    got = sf.value_stream_feat_fwd(*targs, renorm, torch.bfloat16).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert got.shape == want.shape == (T, 24)
    assert rel <= BF16_FUSED_REL, rel
    assert float(np.abs(got[3]).max()) == float(np.abs(want[3]).max()) == 0.0


@pytest.mark.parametrize("T,K,extra,renorm", [
    (64, 6, 0, True), (90, 5, 0, False), (90, 5, 0, True), (37, 4, 6, True)])
def test_value_stream_backward_matches_jax(T, K, extra, renorm):
    ff_cfg, jfn, jargs, targs = _value(4, T, K, "layernorm", extra,
                                       dead_ray=5)
    tgt = jnp.asarray(np.random.default_rng(5).normal(
        size=(T, ff_cfg.d_ff_out)).astype(np.float32))
    fused, vjp = jax.vjp(lambda *a: jfn(*a, renorm), *jargs)
    dfused = jax.grad(lambda f: jnp.mean((f - tgt) ** 2))(fused)
    dxv, dattn, dwalk = vjp(dfused)
    want = [dxv, dattn] + flat_walk_grads(*dwalk)
    tdf = torch.tensor(np.asarray(dfused))
    got = sf.value_stream_feat_bwd(*targs, tdf, renorm)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))
    assert float(np.abs(np.asarray(dattn)[:, -1]).max()) == 0.0
    xv, attn, walk = targs
    leaves = [t.clone().requires_grad_() for t in (xv, attn)]
    tw = [t.clone().requires_grad_() for t in walk_tensors(walk)]
    sf.value_stream_fuse(*leaves, walk_with(walk, tw), renorm).backward(tdf)
    for i, (l, b) in enumerate(zip(leaves + tw, want)):
        np.testing.assert_allclose(l.grad.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"autograd {i}")


def test_key_stream_feat_plain_takes_a_given_relu_pattern():
    """``relu_on`` replaces the score relu's own ``raw > 0``: its own
    pattern changes nothing; all on is the identity score (``none``). Up
    to the summation order of two backward graphs (rtol 1e-5)."""
    _, _, targs = _key(6, 64, 6, "layernorm", 0)
    _, raw = sf.key_stream_feat_plain(*targs, "relu", 5.0)
    dattn = torch.as_tensor(np.random.default_rng(0).normal(
        size=(64, 7)).astype(np.float32))
    want = sf.key_stream_feat_bwd_plain(*targs, dattn, "relu", 5.0)
    got = sf.key_stream_feat_bwd_plain(*targs, dattn, "relu", 5.0,
                                       relu_on=raw > 0)
    assert 0 < int((raw > 0).sum()) < raw.numel()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    got = sf.key_stream_feat_bwd_plain(
        *targs, dattn, "relu", 5.0,
        relu_on=torch.ones_like(raw, dtype=torch.bool))
    want = sf.key_stream_feat_bwd_plain(*targs, dattn, "none", 5.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
