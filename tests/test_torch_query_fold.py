"""The port's query-folded key stream (``ops/stream_attn.py``
``key_stream_scores_recq``: forward, backward and the autograd function,
plain versions on CPU tensors) against the JAX Pallas kernel in interpret
mode, on the shape list of ``tests/test_stream_attn.py``'s recq tests
(overhang rows, K = 1, point-feature extras in the record, with and without
LayerNorm). Every gradient is held: d_rec, d_rayo, d_rays, d_rayd, dW_k,
db_k, dW_q, db_q and both stacks'. Inputs and weights are drawn with numpy
from a seed and go through both packages. fp32; forward rtol 1e-5 / atol
1e-6, gradients rtol 3e-4 / atol 1e-6 (the JAX tests' own bounds). The
forward also in bf16 (``BF16_ATTN_ABS``)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.ops.stream_attn import key_stream_scores_recq
from papr_tpu_torch.convert import to_torch
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops.fused_mlp import (posenc_plan, walk_from_params,
                                          walk_tensors, walk_with)
from test_stream_attn import EPS, LS, PE, QLS, _ff_cfg
from test_torch_stream_feat import FWD, GRAD, flat_walk_grads, jwalk, np_ff, tt


def _case(seed, T, K, norm, extra, dm=16, d_out=32, dq_out=24,
          compute="float32"):
    rng = np.random.default_rng(seed)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    kcfg, qcfg = _ff_cfg(32, d_out, 3, norm), _ff_cfg(32, dq_out, 2, norm)
    kff = np_ff(rng, sum(3 + 6 * l for l in LS) + extra, d_out, kcfg)
    qff = np_ff(rng, sum(3 + 6 * l for l in QLS), dq_out, qcfg)
    rec = np.zeros((K, T, 128), np.float32)
    rec[..., 0:3] = rng.normal(size=(K, T, 3)) * 2.0
    rec[..., 3] = rng.normal(size=(K, T)) * 0.5 + 1.0
    rec[..., 4] = rng.random((K, T)) > 0.2
    rec[:, 5, 4] = 0.0                                    # an all-dead ray
    rec[..., 5:5 + extra] = rng.normal(size=(K, T, extra))
    rayo = f32(rng.normal(size=(T, 3)) * 3.0)
    rayd = rng.normal(size=(T, 3))
    rays = f32(rayd / np.linalg.norm(rayd, axis=-1, keepdims=True))
    rayd = f32(rayd * rng.uniform(0.5, 2.0, size=(T, 1)))  # raw, unnormalized
    wk = f32(rng.normal(size=(dm, d_out)) / np.sqrt(d_out))
    bk = f32(rng.normal(size=dm) * 0.1)
    wq = f32(rng.normal(size=(dm, dq_out)) / np.sqrt(dq_out))
    bq = f32(rng.normal(size=dm) * 0.1)
    rec = f32(rec)
    jfn = lambda rec, rayo, rays, rayd, kw, wk, bk, qw, wq, bq: \
        key_stream_scores_recq(
            rec, rayo, rays, rayd, *kw, wk, bk, *qw, wq, bq,
            (LS, 1, PE[0], PE[1], extra), (QLS, 1, PE[0], PE[1]),
            kcfg.ff_act, kcfg.ff_last_act, qcfg.ff_act, qcfg.ff_last_act,
            "relu", 5.0, EPS, 32, True, compute)
    kwalk = walk_from_params(
        to_torch(jax.tree.map(np.asarray, kff), "cpu"), kcfg,
        sa.rec_pe_plan(True, LS, 1, PE[0], PE[1], extra))
    qwalk = walk_from_params(
        to_torch(jax.tree.map(np.asarray, qff), "cpu"), qcfg,
        posenc_plan((3,), QLS, 1, PE[0], PE[1], 0)[1])
    trec, trayo, trays, trayd, twk, tbk, twq, tbq = tt(
        rec, rayo, rays, rayd, wk, bk, wq, bq)
    return (jfn, (rec, rayo, rays, rayd, jwalk(kff), wk, bk, jwalk(qff), wq,
                  bq),
            (trec, trayo, trays, trayd, kwalk, twk, tbk, qwalk, twq, tbq))


@pytest.mark.parametrize("T,K,norm,extra", [
    (64, 7, "layernorm", 0), (100, 5, "none", 0), (48, 1, "layernorm", 8)])
def test_query_fold_forward_matches_jax(T, K, norm, extra):
    jfn, jargs, targs = _case(20, T, K, norm, extra)
    want = np.asarray(jfn(*jargs))
    attn, raw, ss, qq = sa.key_stream_q_fwd(*targs, "relu", 5.0, EPS)
    assert raw.shape == ss.shape == (T, K) and qq.shape == (T, 16)
    np.testing.assert_allclose(attn.numpy(), want, **FWD)
    np.testing.assert_allclose(
        sa.key_stream_scores_recq(*targs, "relu", 5.0, EPS).numpy(), want,
        **FWD)
    # the same function as the unfolded stream on the same qq
    unfolded, _, _ = sa.key_stream_fwd(*targs[:3], qq, *targs[4:7], "relu",
                                       5.0, EPS)
    np.testing.assert_allclose(attn.numpy(), unfolded.numpy(), **FWD)
    np.testing.assert_allclose(attn.numpy()[5, -1], 1.0, atol=1e-6)


# bf16 compute: JAX's Pallas kernel in interpret mode with compute
# "bfloat16" against the port's plain bf16 forward, the yardstick of the
# bf16 kernels on the card. Both round at the same points (activations, qq's
# and kk's products and bias adds in bf16); their fp32 sums of bf16
# products differ in order, so now and then a value rounds to its bf16
# neighbour: attn max abs <= 1e-3 (T = 48, K = 3 reads 1.3e-4).
BF16_ATTN_ABS = 1e-3


@pytest.mark.parametrize("T,K,norm,extra", [
    (48, 3, "layernorm", 0), (64, 5, "none", 8)])
def test_query_fold_bf16_forward_matches_jax(T, K, norm, extra):
    jfn, jargs, targs = _case(20, T, K, norm, extra, compute="bfloat16")
    want = np.asarray(jfn(*jargs))
    attn, raw, ss, qq = sa.key_stream_q_fwd(*targs, "relu", 5.0, EPS,
                                            torch.bfloat16)
    assert attn.shape == want.shape == (T, K + 1) and qq.shape == (T, 16)
    assert float(np.abs(attn.numpy() - want).max()) <= BF16_ATTN_ABS
    # qq holds bf16 values (the linear layer's bf16 rounding), in fp32
    assert torch.equal(qq, qq.to(torch.bfloat16).float())
    np.testing.assert_allclose(attn.numpy()[5, -1], 1.0, atol=1e-6)
    np.testing.assert_allclose(want[5, -1], 1.0, atol=1e-6)


@pytest.mark.parametrize("T,K,extra", [(64, 6, 0), (90, 5, 4), (48, 1, 0)])
def test_query_fold_backward_matches_jax(T, K, extra):
    jfn, jargs, targs = _case(21, T, K, "layernorm", extra)
    rng = np.random.default_rng(22)
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
    drec, drayo, drays, drayd, dkw, dwk, dbk, dqw, dwq, dbq = vjp(dattn)
    want = ([drec, drayo, drays, drayd, dwk, dbk, dwq, dbq]
            + flat_walk_grads(*dkw) + flat_walk_grads(*dqw))
    tdattn = torch.tensor(np.asarray(dattn))
    got = sa.key_stream_q_bwd(*targs, None, None, None, tdattn, "relu", 5.0,
                              EPS)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))
    assert float(np.abs(np.asarray(drayd)).max()) > 0
    assert float(np.abs(np.asarray(dqw[0][0])).max()) > 0
    # through autograd: the KeyStreamQ function
    rec, rayo, rays, rayd, kwalk, wk, bk, qwalk, wq, bq = targs
    leaves = [t.clone().requires_grad_()
              for t in (rec, rayo, rays, rayd, wk, bk, wq, bq)]
    ktw = [t.clone().requires_grad_() for t in walk_tensors(kwalk)]
    qtw = [t.clone().requires_grad_() for t in walk_tensors(qwalk)]
    out = sa.key_stream_scores_recq(
        *leaves[:4], walk_with(kwalk, ktw), leaves[4], leaves[5],
        walk_with(qwalk, qtw), leaves[6], leaves[7], "relu", 5.0, EPS)
    out.backward(tdattn)
    for i, (l, b) in enumerate(zip(leaves + ktw + qtw, want)):
        np.testing.assert_allclose(l.grad.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"autograd {i}")
