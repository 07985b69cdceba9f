"""nn primitives of the port against papr_tpu.nn on the same inputs (fp32).

Tolerance: rtol 1e-5 with a small atol (1e-6 for elementwise ops, 1e-5 for
the convolution stack whose fp32 sums run in another order than XLA's)."""

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


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("L,without_self,mult", [(6, False, 1.0),
                                                 (3, True, 0.5)])
def test_posenc(L, without_self, mult):
    x = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32) * 10
    got = tposenc.posenc(torch.as_tensor(x), L, 2.0, without_self, mult)
    want = jposenc.posenc(jnp.asarray(x), L, 2.0, without_self, mult)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("width", [39, 256])
def test_layernorm_unbiased_std_plus_eps(width):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(33, width)).astype(np.float32) * 3 + 1
    p = {"a": rng.normal(size=width).astype(np.float32),
         "b": rng.normal(size=width).astype(np.float32)}
    got = tnorm.layernorm_apply(to_torch(p, "cpu"), torch.as_tensor(x))
    want = jnorm.layernorm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(got, want)


ACTS = ["none", "leakyrelu", "relu", "+1", "relu+1", "tanh", "shifted_tanh",
        "sigmoid", "gelu", "gaussian", "quadratic", "multi-quadratic",
        "laplacian", "super-gaussian", "expsin", "clamp", "sine",
        "softplus_1.5_2_0.1", "prelu"]


@pytest.mark.parametrize("act", ACTS)
def test_activations(act):
    x = np.random.default_rng(2).normal(size=(4, 9)).astype(np.float32) * 2
    got = tact.build_activation(act, a=0.7, b=1.3)(torch.as_tensor(x))
    want = jact.build_activation(act, a=0.7, b=1.3)(jnp.asarray(x))
    _close(got, want)


def test_trainable_activation_params():
    x = np.random.default_rng(3).normal(size=(4, 9)).astype(np.float32)
    for act in ("gaussian", "super-gaussian", "prelu"):
        jp = jact.activation_param_init(act, 0.8, 1.2, trainable=True,
                                        num_channels=9)
        tp = tact.activation_param_init(act, 0.8, 1.2, trainable=True,
                                        num_channels=9)
        assert sorted(jp) == sorted(tp)
        got = tact.apply_activation(act, torch.as_tensor(x), tp)
        want = jact.apply_activation(act, jnp.asarray(x), jp)
        _close(got, want)


@pytest.mark.parametrize("norm,residual,wn,skip", [
    ("layernorm", False, False, ()), ("none", True, False, ()),
    ("layernorm", False, True, (1,))])
def test_feedforward(norm, residual, wn, skip):
    over = {"models": {"attn": {"embed": {"key": {
        "d_ff": 24, "d_ff_out": 24, "n_ff_layer": 3, "norm": norm,
        "residual_ff": residual, "use_wn": wn, "skip_layers": list(skip),
        "ff_act": "leakyrelu"}}}}}
    ff_j = jax_load(overrides=over).models.attn.embed.key
    ff_t = load_config(overrides=over).models.attn.embed.key
    jp = jmlp.feedforward_init(jax.random.PRNGKey(0), 24, 24, ff_j)
    x = np.random.default_rng(4).normal(size=(40, 24)).astype(np.float32)
    got = tmlp.feedforward_apply(to_torch(jp, "cpu"), torch.as_tensor(x), ff_t, 24)
    want = jmlp.feedforward_apply(jp, jnp.asarray(x), ff_j, 24)
    _close(got, want, atol=1e-5)


def test_linear_init_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    tp = tmlp.mlp_init(gen, 10, 3, 16, 4, half_layers=(1,), skip_layers=(2,))
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), 10, 3, 16, 4, half_layers=(1,),
                       skip_layers=(2,))
    shapes = lambda p: [tuple(l["w"].shape) for l in p["layers"]]
    assert shapes(tp) == shapes(jp)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(single=False, norm="instance"),
    dict(render_scale=2),
    dict(affine_layer=2),
])
def test_small_unet(variant):
    """SmallUNet NHWC forward, odd frame (maxpool truncation + centre pad)."""
    init_kw = {k: variant[k] for k in ("bilinear", "single", "render_scale")
               if k in variant}
    apply_kw = dict(variant)
    jp = junet.small_unet_init(jax.random.PRNGKey(0), 8, 3, **init_kw)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 11, 14, 8)).astype(np.float32)
    if "affine_layer" in variant:
        c = {0: 8, 1: 128, 2: 256, 3: 512, 4: 256, 5: 128}[
            variant["affine_layer"]]
        g = rng.normal(size=c).astype(np.float32)
        b = rng.normal(size=c).astype(np.float32)
        apply_kw.update(gamma=g, beta=b)
        jkw = dict(apply_kw, gamma=jnp.asarray(g), beta=jnp.asarray(b))
        tkw = dict(apply_kw, gamma=torch.as_tensor(g), beta=torch.as_tensor(b))
    else:
        jkw = tkw = apply_kw
    want = junet.small_unet_apply(jp, jnp.asarray(x), **jkw)
    got = tunet.small_unet_apply(to_torch(jp, "cpu"), torch.as_tensor(x), **tkw)
    assert tuple(got.shape) == want.shape
    _close(got, want, atol=1e-5)


def test_small_unet_bilinear_raises_like_jax():
    """The reference's bilinear SmallUNet feeds 768 channels into a
    512-input conv (its SingleConv mid-channel quirk); both packages raise."""
    jp = junet.small_unet_init(jax.random.PRNGKey(0), 8, 3, bilinear=True)
    x = np.zeros((1, 8, 8, 8), np.float32)
    with pytest.raises(ValueError):
        junet.small_unet_apply(jp, jnp.asarray(x), bilinear=True)
    with pytest.raises(RuntimeError):
        tunet.small_unet_apply(to_torch(jp, "cpu"), torch.as_tensor(x), bilinear=True)


def test_upsample_bilinear_align_corners():
    x = np.random.default_rng(6).normal(size=(2, 5, 7, 3)).astype(np.float32)
    _close(tunet.upsample_bilinear_align_corners(torch.as_tensor(x)),
           junet.upsample_bilinear_align_corners(jnp.asarray(x)))


def test_unet_init_tree_matches_jax():
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(), dict(bilinear=True), dict(render_scale=2)):
        tp = tunet.small_unet_init(gen, 32, 3, **kw)
        jp = junet.small_unet_init(jax.random.PRNGKey(0), 32, 3, **kw)
        flat = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)
                          for k, v in jax.tree_util.tree_flatten_with_path(
                              jax.tree.map(np.asarray, t))[0]}
        tshapes = flat(jax.tree.map(lambda v: np.zeros(tuple(v.shape)), tp))
        assert tshapes == flat(jp)
