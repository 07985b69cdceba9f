"""A training step with a shading code (FiLM live at the UNet's input) and
the eval render with the eval image's code, through both packages.

A JAX ``create_model`` converted with ``from_jax_params``; JAX runs its
Pallas kernels in interpret mode (``tpu.force_local``, ``topk_impl: cull``,
``fused_attn: streamrec``), the port its kernels' plain versions on CPU
tensors; MSE + 1e-2 LPIPS on JAX-drawn random VGG weights, converted; fp32
compute. Tolerances, as ``test_torch_train_step.py``: loss rtol 1e-5; every
gradient, ``mapping_mlp`` included, rtol 3e-4 with atol 1e-6 x the
gradient's max. After one Adam step (whose first update is lr * g / (|g| +
eps), so a gradient that rounds to the other sign moves its parameter the
other way): the parameters within 1e-4 of the update (plus two units in the
last place of the parameter) wherever |g| > 1e-3 x the leaf's max, and
nowhere more than twice the largest update of its leaf apart. The eval
step's loss and PSNR rtol 1e-4."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.config import make_eval_config as jax_eval_config
from papr_tpu.dataset import get_dataset as jget_dataset
from papr_tpu.model import papr as jpapr
from papr_tpu.model.lpips_jax import random_lpips_params
from papr_tpu.nn.activations import build_activation
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.train import loop as jloop
from papr_tpu.train import step as jstep
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config, make_eval_config
from papr_tpu_torch.convert import from_jax_lpips_params, from_jax_params
from papr_tpu_torch.dataset import get_dataset
from papr_tpu_torch.dataset.synth import make_demo_scene
from papr_tpu_torch.nn.mlp import policy_from_config
from papr_tpu_torch.train import loop as tloop
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves

H = W = 16


def _over(scene=None):
    over = {
        "use_amp": False, "max_num_pts": 320,
        "dataset": {"coord_scale": 1.0},
        "geoms": {"points": {"select_k": 6, "init_num": 300,
                             "init_scale": [0.6, 0.6, 0.6]},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 32, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "query": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 8, "n_ff_layer": 3}}},
            "renderer": {"generator": {"small_unet": {"affine_layer": 0}}}},
        "exposure_control": {
            "use": True, "shading_code_dim": 8,
            "mapping_mlp": {"num_layers": 3, "dim": 16, "out_dim": 16}},
        "eval": {"img_idx": 0, "max_height": 16, "max_width": 16,
                 "save_fig": False},
        "tpu": {"force_local": True, "topk_impl": "cull",
                "fused_attn": "streamrec", "cull_candidates": 256},
    }
    if scene:
        over["dataset"].update({"type": "synthetic", "path": scene})
        over["eval"]["dataset"] = {"name": "testset", "path": scene}
    return over


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_load(overrides=_over())
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(
        rng.normal(size=(320, 1)).astype(np.float32))
    alive = np.asarray(state["alive"]).copy()
    alive[10:40] = False
    state = {"alive": jnp.asarray(alive)}
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, 0.1, 2.5]
    rayo, rayd = get_rays_np(H, W, 20.0, 20.0, c2w[None])
    target = rng.random((1, H, W, 3)).astype(np.float32)
    code = rng.standard_normal(8).astype(np.float32)
    cfg = load_config(overrides=_over())
    lp = random_lpips_params(jax.random.PRNGKey(0))
    lp_t = from_jax_lpips_params(jax.tree.map(np.asarray, lp), device="cpu")
    return jcfg, cfg, params, state, (rayo, rayd, target, c2w), code, lp, lp_t


def _port(cfg, params, state):
    return from_jax_params(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, state), cfg, device="cpu")


def test_step_with_shading_code_matches_jax(setup):
    jcfg, cfg, params, state, batch, code, lp, lp_t = setup
    rayo, rayd, target, c2w = batch
    jloss = jget_loss(jcfg.training.losses, lpips_params=lp)
    last = build_activation(jcfg.models.last_act)

    def f(p):
        out = last(jpapr.forward(p, state, jcfg, jnp.asarray(rayo),
                                 jnp.asarray(rayd),
                                 shading_code=jnp.asarray(code)))
        return jloss(out, jnp.asarray(target))

    jl, jg = jax.jit(jax.value_and_grad(f))(params)
    tp, ts = _port(cfg, params, state)
    tl, _, tg = tstep.loss_and_grads(
        tp, ts, cfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(target), c2w,
        get_loss(cfg.training.losses, lpips_params=lp_t),
        build_group_specs(cfg), policy_from_config(cfg),
        shading_code=torch.as_tensor(code))
    assert "mapping_mlp" in tg
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in tg:
        for a, b in zip(tree_leaves(tg[key]),
                        jax.tree.leaves(jax.tree.map(np.asarray, jg[key]))):
            a = a.numpy()
            assert a.shape == b.shape, key
            np.testing.assert_allclose(
                a, b, rtol=3e-4, atol=1e-6 * max(float(np.abs(b).max()), 1e-30),
                err_msg=key)
    assert float(np.abs(np.asarray(
        jax.tree.leaves(jg["mapping_mlp"])[0])).max()) > 0

    # One step of each package's make_train_step from the same state.
    jfn, _ = jstep.make_train_step(jcfg, loss_fn=jloss, donate=False)
    jp, _, jl1, _ = jfn(params, jstep.make_opt_state(jcfg, params), state,
                        jnp.asarray(rayo), jnp.asarray(rayd),
                        jnp.asarray(target), c2w, jnp.asarray(7, jnp.int32),
                        shading_code=jnp.asarray(code))
    tfn = tstep.make_train_step(
        cfg, loss_fn=get_loss(cfg.training.losses, lpips_params=lp_t))
    before = _port(cfg, params, state)[0]
    tp, _, tl1, _ = tfn(tp, tstep.make_opt_state(cfg, tp), ts,
                        torch.as_tensor(rayo), torch.as_tensor(rayd),
                        torch.as_tensor(target), c2w, 7,
                        shading_code=torch.as_tensor(code))
    np.testing.assert_allclose(float(tl1), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl1), float(jl1), rtol=1e-5)
    for key in tg:
        for new_t, new_j, old, g in zip(
                tree_leaves(tp[key]), jax.tree.leaves(jp[key]),
                tree_leaves(before[key]), jax.tree.leaves(jg[key])):
            new_t, new_j, old = new_t.numpy(), np.asarray(new_j), old.numpy()
            dj = new_j - old
            ulp = 2 * np.spacing(np.abs(old))    # the updates' own rounding
            g = np.abs(np.asarray(g))
            firm = g > 1e-3 * g.max()
            err = np.abs(new_t - new_j)
            assert (err <= 1e-4 * np.abs(dj) + ulp)[firm].all(), key
            assert (err <= 2 * np.abs(dj).max() + ulp).all(), key
    moved = float((tp["mapping_mlp"]["layers"][0]["w"]
                   - before["mapping_mlp"]["layers"][0]["w"]).abs().max())
    assert moved > 0


def test_eval_step_with_eval_shading_code_matches_jax(setup, tmp_path):
    scene = make_demo_scene(str(tmp_path / "scene"), n_train=2, n_test=1,
                            H=H, W=W)
    _, _, params, state, _, code, _, _ = setup
    jcfg = jax_load(overrides=_over(scene))
    cfg = load_config(overrides=_over(scene))
    tp, ts = _port(cfg, params, state)
    jds = jget_dataset(jcfg.dataset, mode="train", seed=1)
    tds = get_dataset(cfg.dataset, mode="train", seed=1)
    jev = jget_dataset(jax_eval_config(jcfg).dataset, mode="test")
    tev = get_dataset(make_eval_config(cfg).dataset, mode="test")
    jloss = jget_loss({"mse": 1.0})
    tloss = get_loss({"mse": 1.0})
    out = {}
    for name, code_ in (("code", code), ("other", -code)):
        jh = {"train_losses": [0.0], "eval_losses": [], "eval_psnrs": []}
        th = {"train_losses": [0.0], "eval_losses": [], "eval_psnrs": []}
        jloop.eval_step(1, params, state, jcfg, jds, jev, None, jloss, None,
                        jh, str(tmp_path / "j"), eval_shading_code=code_)
        tloop.eval_step(1, tp, ts, cfg, tds, tev, None, tloss, None, th,
                        str(tmp_path / "t"), eval_shading_code=code_)
        np.testing.assert_allclose(th["eval_losses"], jh["eval_losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(th["eval_psnrs"], jh["eval_psnrs"],
                                   rtol=1e-4)
        out[name] = th["eval_losses"][0]
    assert out["code"] != out["other"]
