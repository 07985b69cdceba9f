"""The port's LPIPS(VGG16) against ``papr_tpu.model.lpips_jax.lpips_apply``
on the JAX-drawn random backbone, converted with ``from_jax_lpips_params``:
the value (fp32 rtol 1e-5) and its gradient with respect to the prediction
(fp32, relative Frobenius error <= 1e-5: thirteen convolutions sum in
another order, so single small elements differ by ~1e-4 relative). Also
the loss factory's fallbacks."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.model.lpips_jax import lpips_apply as jax_lpips
from papr_tpu.model.lpips_jax import random_lpips_params as jax_random
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_lpips_params
from papr_tpu_torch.model import lpips as tl
from papr_tpu_torch.train import losses as tloss


@pytest.fixture(scope="module")
def params():
    lp = jax_random(jax.random.PRNGKey(0))
    return lp, from_jax_lpips_params(jax.tree.map(np.asarray, lp), device="cpu")


@pytest.mark.parametrize("shape", [(1, 24, 24, 3), (2, 19, 17, 3)])
def test_lpips_value_and_grad_match_jax(params, shape):
    """19x17: odd sizes, cropped by every max pool."""
    lp, lp_t = params
    rng = np.random.default_rng(0)
    pred = rng.random(shape).astype(np.float32)
    target = rng.random(shape).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p, t: jax_lpips(lp, p, t)))(jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    tv = tl.lpips_apply(lp_t, p, torch.tensor(target))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.linalg.norm(p.grad.numpy() - jg) <= 1e-5 * np.linalg.norm(jg)


def test_random_backbone_shapes_and_fallbacks(capsys):
    lp = tl.random_lpips_params(0, device="cpu")
    again = tl.random_lpips_params(0, device="cpu")
    cin = 3
    for (cout, _), conv, conv2 in zip(tl.VGG16_CONVS, lp["convs"],
                                      again["convs"]):
        assert tuple(conv["w"].shape) == (cout, cin, 3, 3)
        assert torch.equal(conv["w"], conv2["w"])          # seeded
        assert 0.03 < float(conv["w"].std()) < 0.07       # N(0, 1) * 0.05
        cin = cout
    assert [l.shape[0] for l in lp["lins"]] == list(tl.SLICE_CHANNELS)
    assert all(0 <= float(l.min()) and float(l.max()) <= 1 for l in lp["lins"])
    real = tl.random_lpips_params(0, use_real_lins=True, device="cpu")
    assert torch.equal(real["lins"][0], tl.load_lin_params(device="cpu")[0])

    x = torch.rand(1, 16, 16, 3)
    y = torch.rand(1, 16, 16, 3)
    mse = float(((x - y) ** 2).mean())
    cfg = load_config(overrides={"tpu": {"lpips_fallback": "drop"}})
    assert abs(float(tloss.build_loss(cfg, device="cpu")(x, y)) - mse) < 1e-7
    cfg = load_config()
    fn = tloss.build_loss(cfg, device="cpu")
    assert "RANDOM VGG" in capsys.readouterr().out
    want = mse + 1e-2 * float(tl.lpips_apply(lp, x, y))
    np.testing.assert_allclose(float(fn(x, y)), want, rtol=1e-6)
    np.testing.assert_allclose(float(tloss.psnr(x, y)),
                               -10 * np.log10(mse), rtol=1e-5)
