"""The port's training streams (``key_stream_scores_rec`` /
``value_stream_fuse_rec``: forward, backward and the autograd functions,
plain versions on CPU tensors) against the JAX Pallas kernels in interpret
mode, on the cases of ``tests/test_stream_attn.py``'s rec-native tests
(overhang rows, point-feature extras in the record, with and without
LayerNorm and renormalization). The cotangents are those of the JAX tests'
losses. fp32; forward rtol 1e-5 / atol 1e-6, gradients rtol 3e-4 /
atol 1e-6 (the JAX tests' own bounds)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.ops.fused_mlp import _ff_lns
from papr_tpu.ops.stream_attn import (key_stream_scores_rec,
                                      value_stream_fuse_rec)
from papr_tpu_torch.convert import to_torch
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops.fused_mlp import walk_from_params
from test_stream_attn import EPS, LS, PE, VLS, _rec_setup, _vrec_setup

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=3e-4, atol=1e-6)


def _jwalk(ff):
    ln_in, ln_out = _ff_lns(ff)
    return (tuple(l["w"].T for l in ff["mlp"]["layers"]),
            tuple(l["bias"] for l in ff["mlp"]["layers"]), ln_in, ln_out)


def _twalk(ff, ff_cfg, has_pos, Ls, extra):
    cols = sa.rec_pe_plan(has_pos, Ls, 1, PE[0], PE[1], extra)
    return walk_from_params(to_torch(jax.tree.map(np.asarray, ff), "cpu"), ff_cfg,
                            cols)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread. With the default thread
    team, a loaded host hands the team fewer threads and the plain
    version's sgemm / reductions sum in another order:
    test_key_stream_forward_matches_jax[64-7-layernorm-0] read 1.32e-6 or
    6.73e-6 against atol 1e-6 in 5 of 66 processes (3 of 30, 2 of 36), while
    JAX's interpret-mode result was bit-equal in all 66; on one thread it
    read 1.19e-7, bit-equal, in 36 of 36 processes under the same load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_walk_grads(ws, bs, ln_in, ln_out):
    return (list(ws) + list(bs) + [t for ln in (ln_in, ln_out)
                                   if ln is not None for t in ln])


def _key(case, extra, norm="layernorm"):
    T, K = case
    ff_cfg, ff, rec, rayo, rays, qq, wk, bk = _rec_setup(
        jax.random.PRNGKey(10), T, K, extra_dim=extra, norm=norm)
    jfn = lambda rec, rayo, rays, qq, walk, wk, bk: key_stream_scores_rec(
        rec, rayo, rays, qq, *walk, wk, bk, (LS, 1, PE[0], PE[1], extra),
        ff_cfg.ff_act, ff_cfg.ff_last_act, "relu", 5.0, EPS, 32, True,
        "float32")
    targs = [torch.tensor(np.asarray(a)) for a in (rec, rayo, rays, qq)]
    twalk = _twalk(ff, ff_cfg, True, LS, extra)
    tk = (targs[0], targs[1], targs[2], targs[3], twalk,
          torch.tensor(np.asarray(wk)), torch.tensor(np.asarray(bk)))
    return jfn, (rec, rayo, rays, qq, _jwalk(ff), wk, bk), tk


@pytest.mark.parametrize("T,K,norm,extra", [
    (64, 7, "layernorm", 0), (100, 5, "none", 0), (48, 6, "layernorm", 8)])
def test_key_stream_forward_matches_jax(T, K, norm, extra):
    jfn, jargs, targs = _key((T, K), extra, norm)
    want = np.asarray(jfn(*jargs))
    attn, raw, ss = sa.key_stream_fwd(*targs, "relu", 5.0, EPS)
    np.testing.assert_allclose(attn.numpy(), want, **FWD)
    got = sa.key_stream_scores_rec(*targs, "relu", 5.0, EPS)
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("T,K,extra", [(64, 6, 0), (90, 5, 4)])
def test_key_stream_backward_matches_jax(T, K, extra):
    jfn, jargs, targs = _key((T, K), extra)
    ev = jax.random.normal(jax.random.PRNGKey(12), (K, T, 8))
    tgt_f = jax.random.normal(jax.random.PRNGKey(13), (T, 8))
    tgt_a = jax.random.normal(jax.random.PRNGKey(14), (T, 1))

    def loss(attn):
        topk = attn[:, :-1]
        topk = topk / jnp.sum(topk, axis=-1, keepdims=True)
        fused = jnp.einsum("tk,ktc->tc", topk, ev)
        return jnp.mean((fused - tgt_f) ** 2) + \
            jnp.mean((attn[:, -1:] - tgt_a) ** 2)

    attn, vjp = jax.vjp(jfn, *jargs)
    dattn = jax.grad(loss)(attn)
    drec, drayo, drays, dqq, dwalk, dwk, dbk = vjp(dattn)
    want = [drec, drayo, drays, dqq, dwk, dbk] + _flat_walk_grads(*dwalk)
    got = sa.key_stream_bwd(*targs, None, None,
                            torch.as_tensor(np.asarray(dattn)), "relu", 5.0,
                            EPS)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))
    # through autograd: the KeyStream function
    leaves = [t.clone().requires_grad_() for t in targs[:4]]
    tw = [t.clone().requires_grad_() for t in sa.walk_tensors(targs[4])]
    wkb = [t.clone().requires_grad_() for t in targs[5:]]
    out = sa.key_stream_scores_rec(*leaves, sa.walk_with(targs[4], tw), *wkb,
                                   "relu", 5.0, EPS)
    out.backward(torch.as_tensor(np.asarray(dattn)))
    for i, (l, b) in enumerate(zip(leaves + wkb + tw, want[:4] + want[4:])):
        np.testing.assert_allclose(l.grad.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"autograd {i}")


def _value(T, K, extra, norm="layernorm"):
    ff_cfg, ff, rec, rayo, rays, attn = _vrec_setup(
        jax.random.PRNGKey(16 if norm == "layernorm" else 15), T, K,
        extra_dim=extra, norm=norm)
    twalk = _twalk(ff, ff_cfg, False, VLS, extra)
    targs = [torch.tensor(np.asarray(a)) for a in (rec, rayo, rays, attn)]
    jfn = lambda rec, rayo, rays, attn, walk, renorm: value_stream_fuse_rec(
        rec, rayo, rays, attn, *walk, (VLS, 1, PE[0], PE[1], extra),
        ff_cfg.ff_act, ff_cfg.ff_last_act, renorm, EPS, 32, True, "float32")
    return ff_cfg, jfn, (rec, rayo, rays, attn, _jwalk(ff)), targs + [twalk]


@pytest.mark.parametrize("T,K,norm,extra,renorm", [
    (64, 7, "layernorm", 0, True), (100, 5, "none", 6, False)])
def test_value_stream_forward_matches_jax(T, K, norm, extra, renorm):
    _, jfn, jargs, targs = _value(T, K, extra, norm)
    want = np.asarray(jfn(*jargs, renorm))
    np.testing.assert_allclose(
        sa.value_stream_fwd(*targs, renorm, EPS).numpy(), want, **FWD)
    np.testing.assert_allclose(
        sa.value_stream_fuse_rec(*targs, renorm, EPS).numpy(), want, **FWD)


@pytest.mark.parametrize("T,K,extra,renorm", [
    (64, 6, 0, True), (90, 5, 4, False), (90, 5, 0, True)])
def test_value_stream_backward_matches_jax(T, K, extra, renorm):
    ff_cfg, jfn, jargs, targs = _value(T, K, extra)
    tgt = jax.random.normal(jax.random.PRNGKey(17), (T, ff_cfg.d_ff_out))
    fused, vjp = jax.vjp(lambda *a: jfn(*a, renorm), *jargs)
    dfused = jax.grad(lambda f: jnp.mean((f - tgt) ** 2))(fused)
    drec, drayo, drays, dattn, dwalk = vjp(dfused)
    want = [drec, drayo, drays, dattn] + _flat_walk_grads(*dwalk)
    got = sa.value_stream_bwd(*targs, torch.as_tensor(np.asarray(dfused)),
                              renorm, EPS)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))


def test_key_stream_plain_takes_a_given_relu_pattern():
    """``relu_on`` replaces the score relu's own ``raw > 0``: its own
    pattern changes nothing; all on is the identity score (``none``)."""
    _, _, targs = _key((64, 6), 0)
    _, raw, _ = sa.key_stream_plain(*targs, "relu", 5.0, EPS)
    dattn = torch.as_tensor(np.random.default_rng(0).normal(
        size=(64, 7)).astype(np.float32))
    want = sa.key_stream_bwd_plain(*targs, dattn, "relu", 5.0, EPS)
    got = sa.key_stream_bwd_plain(*targs, dattn, "relu", 5.0, EPS,
                                  relu_on=raw > 0)
    assert 0 < int((raw > 0).sum()) < raw.numel()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    on = torch.ones_like(raw, dtype=torch.bool)
    got = sa.key_stream_bwd_plain(*targs, dattn, "relu", 5.0, EPS,
                                  relu_on=on)
    want = sa.key_stream_bwd_plain(*targs, dattn, "none", 5.0, EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
