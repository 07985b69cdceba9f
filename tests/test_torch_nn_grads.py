"""Gradients of the port's nn primitives (autograd) against ``jax.grad``
through ``papr_tpu.nn`` on the same inputs and cotangents: posenc,
LayerNorm, activations (with trainable a / b and PReLU slopes), the
FeedForward block (LayerNorm, weight norm, skips) and the SmallUNet.
fp32; rtol 3e-4 with atol 1e-6 x the gradient's max (for the UNet 1e-5 x
the largest gradient of the tree: its convolution sums run in another order
than XLA's, and a bias ahead of an instance norm has an exactly-zero
gradient that both packages give as ~1e-7 noise)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.nn import activations as jact
from papr_tpu.nn import mlp as jmlp
from papr_tpu.nn import norm as jnorm
from papr_tpu.nn import posenc as jposenc
from papr_tpu.nn import unet as junet
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import to_torch
from papr_tpu_torch.nn import activations as tact
from papr_tpu_torch.nn import mlp as tmlp
from papr_tpu_torch.nn import norm as tnorm
from papr_tpu_torch.nn import posenc as tposenc
from papr_tpu_torch.nn import unet as tunet
from papr_tpu_torch.train.optim import tree_leaves, tree_map


def _grads_match(jfn, tfn, params_np, x, atol_scale=1e-6, whole_tree=False):
    """d/d(params, x) of sum(f(params, x) * cot) in both packages."""
    jp = jax.tree.map(jnp.asarray, params_np)
    out = jfn(jp, jnp.asarray(x))
    cot = np.random.default_rng(0).normal(size=out.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, v: jnp.sum(jfn(p, v) * cot), (0, 1)))(
        jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(), to_torch(params_np, "cpu"))
    tx = torch.tensor(x, requires_grad=True)
    (tfn(tp, tx) * torch.as_tensor(cot)).sum().backward()
    got = [l.grad for l in tree_leaves(tp)] + [tx.grad]
    want = [np.asarray(b) for b in jax.tree.leaves(jg[0]) + [jg[1]]]
    assert len(got) == len(want)
    top = max(float(np.abs(b).max()) for b in want)
    for i, (a, b) in enumerate(zip(got, want)):
        a = np.zeros_like(b) if a is None else a.numpy()
        scale = top if whole_tree else float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=atol_scale * scale,
                                   err_msg=str(i))


def test_posenc_and_layernorm_grads():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 5, 3)).astype(np.float32) * 3
    _grads_match(lambda p, v: jposenc.posenc(v, 4, 2.0, False, 1.0),
                 lambda p, v: tposenc.posenc(v, 4, 2.0, False, 1.0), {}, x)
    x = rng.normal(size=(20, 39)).astype(np.float32) * 2 + 1
    p = {"a": rng.normal(size=39).astype(np.float32),
         "b": rng.normal(size=39).astype(np.float32)}
    _grads_match(jnorm.layernorm_apply, tnorm.layernorm_apply, p, x)


@pytest.mark.parametrize("act", ["leakyrelu", "relu+1", "tanh", "gelu",
                                 "sine", "softplus_1.5_2_0.1", "gaussian",
                                 "super-gaussian", "expsin", "prelu"])
def test_activation_grads(act):
    """Trainable a / b (and PReLU's per-channel slopes) get gradients."""
    x = np.random.default_rng(2).normal(size=(7, 9)).astype(np.float32) * 2
    p = jax.tree.map(np.asarray, jact.activation_param_init(
        act, 0.8, 1.2, trainable=True, num_channels=9))
    _grads_match(lambda q, v: jact.apply_activation(act, v, q, a=0.8, b=1.2),
                 lambda q, v: tact.apply_activation(act, v, q, a=0.8, b=1.2),
                 p, x)


@pytest.mark.parametrize("norm,wn,skip,act", [
    ("layernorm", False, (), "relu"), ("none", True, (1,), "leakyrelu"),
    ("layernorm", False, (), "prelu")])
def test_feedforward_grads(norm, wn, skip, act):
    over = {"models": {"attn": {"embed": {"key": {
        "d_ff": 24, "d_ff_out": 16, "n_ff_layer": 3, "norm": norm,
        "use_wn": wn, "skip_layers": list(skip), "ff_act": act}}}}}
    ff_j = jax_load(overrides=over).models.attn.embed.key
    ff_t = load_config(overrides=over).models.attn.embed.key
    p = jax.tree.map(np.asarray, jmlp.feedforward_init(
        jax.random.PRNGKey(0), 20, 16, ff_j))
    x = np.random.default_rng(3).normal(size=(30, 20)).astype(np.float32)
    _grads_match(lambda q, v: jmlp.feedforward_apply(q, v, ff_j, 16),
                 lambda q, v: tmlp.feedforward_apply(q, v, ff_t, 16), p, x)


@pytest.mark.parametrize("variant", [dict(), dict(single=False,
                                                  norm="instance")])
def test_small_unet_grads(variant):
    init_kw = {k: variant[k] for k in ("single",) if k in variant}
    p = jax.tree.map(np.asarray, junet.small_unet_init(
        jax.random.PRNGKey(0), 8, 3, **init_kw))
    x = np.random.default_rng(5).normal(size=(1, 11, 14, 8)).astype(np.float32)
    _grads_match(lambda q, v: junet.small_unet_apply(q, v, **variant),
                 lambda q, v: tunet.small_unet_apply(q, v, **variant), p, x,
                 atol_scale=1e-5, whole_tree=True)
