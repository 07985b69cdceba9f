"""The training slice as a whole: one step of a JAX ``create_model``
converted with ``from_jax_params``, through both packages.

JAX runs with ``tpu.force_local`` (the CPU test host has 8 virtual devices),
``topk_impl: cull`` with the default ``approx`` prefilter, and
``fused_attn`` in (``streamrec``, ``false``, ``stream``, ``streamrec`` with
``query_fold``): its Pallas kernels run in interpret mode; the port runs the same path with its kernels' plain versions
(CPU tensors). The loss is MSE + 1e-2 LPIPS on JAX-drawn random VGG weights,
converted. fp32 compute. Tolerances: equal selection indices; loss rtol
1e-5; every gradient rtol 3e-4 with atol 1e-6 x the gradient's max (Adam's
first update is lr * sign(g), so gradients are compared here and updated
parameters only in test_torch_optim.py)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.model.lpips_jax import random_lpips_params
from papr_tpu.nn.activations import build_activation
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.ops.tile_cull import select_topk_culled
from papr_tpu.train import points_host as jph
from papr_tpu.train import step as jstep
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import (from_jax_lpips_params, from_jax_opt_state,
                                    from_jax_params)
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.train import points_host as tph
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves

H = W = 16


def _over(fused_attn, query_fold=False):
    return {
        "use_amp": False, "max_num_pts": 320,
        "dataset": {"coord_scale": 1.0},
        "geoms": {"points": {"select_k": 6, "init_num": 300,
                             "init_scale": [0.6, 0.6, 0.6]},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 32, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "query": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 8, "n_ff_layer": 3}}}},
        "training": {"add_num": 20},
        "tpu": {"force_local": True, "topk_impl": "cull",
                "fused_attn": fused_attn, "cull_candidates": 256,
                "query_fold": query_fold},
    }


@pytest.fixture(scope="module")
def lpips_pair():
    lp = random_lpips_params(jax.random.PRNGKey(0))
    return lp, from_jax_lpips_params(jax.tree.map(np.asarray, lp), device="cpu")


def _setup(fused_attn, query_fold=False):
    jcfg = jax_load(overrides=_over(fused_attn, query_fold))
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
    cfg = load_config(overrides=_over(fused_attn, query_fold))
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), cfg,
                             device="cpu")
    return jcfg, cfg, params, state, tp, ts, (rayo, rayd, target, c2w)


def _jax_loss_grads(jcfg, lp):
    """Jitted value_and_grad of the JAX step's loss (step.py compute_loss)
    over (params, state, rayo, rayd, target)."""
    loss_fn = jget_loss(jcfg.training.losses, lpips_params=lp)
    last = build_activation(jcfg.models.last_act)

    def f(p, state, rayo, rayd, target):
        out = last(jpapr.forward(p, state, jcfg, rayo, rayd))
        return loss_fn(out, target)

    vg = jax.jit(jax.value_and_grad(f))
    return lambda params, state, batch: vg(
        params, state, *(jnp.asarray(a) for a in batch[:3]))


def _port_loss_grads(cfg, tp, ts, batch, lp_t):
    rayo, rayd, target, c2w = batch
    specs = build_group_specs(cfg)
    from papr_tpu_torch.nn.mlp import policy_from_config
    loss, _, grads = tstep.loss_and_grads(
        tp, ts, cfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(target), c2w,
        get_loss(cfg.training.losses, lpips_params=lp_t), specs,
        policy_from_config(cfg))
    return loss, grads


def _check(jl, jg, tl, tg):
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key in tg:
        for a, b in zip(tree_leaves(tg[key]),
                        jax.tree.leaves(jax.tree.map(np.asarray, jg[key]))):
            a = a.numpy()
            assert a.shape == b.shape, key
            np.testing.assert_allclose(
                a, b, rtol=3e-4, atol=1e-6 * max(float(np.abs(b).max()), 1e-30),
                err_msg=key)


@pytest.mark.parametrize("fused_attn,query_fold",
                         [("streamrec", False), (False, False),
                          ("stream", False), ("streamrec", True)],
                         ids=["streamrec", "False", "stream", "query_fold"])
def test_train_step_matches_jax(lpips_pair, fused_attn, query_fold):
    lp, lp_t = lpips_pair
    jcfg, cfg, params, state, tp, ts, batch = _setup(fused_attn, query_fold)
    rayo, rayd = batch[0], batch[1]

    # Same selection: the approx prefilter is exact off the TPU.
    jidx = select_topk_culled(params["points"], state["alive"],
                              jnp.asarray(rayo[0]), jnp.asarray(rayd[0]), 6,
                              M=256, block=16, eps=1e-6, interpret=True,
                              prefilter="approx")
    _, _, tidx = tpapr._attend(tp, ts, cfg, torch.as_tensor(rayo),
                               torch.as_tensor(rayd), tpapr.F32,
                               exact_select=False)
    np.testing.assert_array_equal(tidx.numpy().reshape(H * W, 6),
                                  np.asarray(jidx))

    jax_vg = _jax_loss_grads(jcfg, lp)
    jl, jg = jax_vg(params, state, batch)
    tl, tg = _port_loss_grads(cfg, tp, ts, batch, lp_t)
    assert set(tg) == {"points", "attn", "points_influ_scores", "pc_feats",
                       "renderer"}
    _check(jl, jg, tl, tg)

    # After a prune + grow event, with a fresh optimizer state: the same
    # alive mask and points, then the same loss and gradients again.
    params, state, n_pr = jph.prune_points(params, state, 0.3)
    params, state, n_add = jph.add_points(params, state, jcfg, 20,
                                          np.random.default_rng(7))
    tp, ts, t_pr = tph.prune_points(tp, ts, 0.3)
    tp, ts, t_add = tph.add_points(tp, ts, cfg, 20, np.random.default_rng(7))
    assert (t_pr, t_add) == (n_pr, n_add) and n_pr > 0 and n_add == 20
    np.testing.assert_array_equal(ts["alive"].numpy(),
                                  np.asarray(state["alive"]))
    np.testing.assert_allclose(tp["points"].numpy(),
                               np.asarray(params["points"]), rtol=1e-6)
    jl, jg = jax_vg(params, state, batch)
    tl, tg = _port_loss_grads(cfg, tp, ts, batch, lp_t)
    _check(jl, jg, tl, tg)


def test_make_train_step_and_opt_state_round_trip(lpips_pair):
    """The port's make_train_step against papr_tpu's on one step (loss and
    prediction), then the JAX optimizer state carried across exactly."""
    lp, lp_t = lpips_pair
    jcfg, cfg, params, state, tp, ts, batch = _setup("streamrec")
    rayo, rayd, target, c2w = batch
    jfn, _ = jstep.make_train_step(
        jcfg, loss_fn=jget_loss(jcfg.training.losses, lpips_params=lp),
        donate=False)
    jopt = jstep.make_opt_state(jcfg, params)
    jp, jopt, jl, jpred = jfn(params, jopt, state, jnp.asarray(rayo),
                              jnp.asarray(rayd), jnp.asarray(target), c2w,
                              jnp.asarray(1000, jnp.int32))
    tfn = tstep.make_train_step(
        cfg, loss_fn=get_loss(cfg.training.losses, lpips_params=lp_t))
    topt = tstep.make_opt_state(cfg, tp)
    tp, topt, tl, tpred = tfn(tp, topt, ts, torch.as_tensor(rayo),
                              torch.as_tensor(rayd), torch.as_tensor(target),
                              c2w, 1000)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-4,
                               atol=1e-5)
    assert all(st["t"] == 1 for st in topt.values())

    conv = from_jax_opt_state(jax.tree.map(np.asarray, jopt), tp, cfg)
    assert set(conv) == set(jopt)
    for key in conv:
        assert conv[key]["t"] == int(jopt[key]["t"]) == 1
        for name in ("m", "v"):
            for a, b in zip(tree_leaves(conv[key][name]),
                            jax.tree.leaves(jopt[key][name])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_eval_fused_false_leaves_training_alone():
    """``tpu.eval_fused`` picks the eval kernels only: training runs the
    streams with it set to false, with the same result."""
    rayo, rayd = get_rays_np(8, 8, 10.0, 10.0, np.eye(4, dtype=np.float32)[None])
    rayo, rayd = torch.as_tensor(rayo), torch.as_tensor(rayd)
    cfg = load_config(overrides=_over("streamrec"))
    tp, ts = tpapr.create_model(cfg, seed=0, device="cpu")
    want = tpapr.forward(tp, ts, cfg, rayo, rayd)
    over = _over("streamrec")
    over["tpu"]["eval_fused"] = False
    cfg = load_config(overrides=over)
    torch.testing.assert_close(tpapr.forward(tp, ts, cfg, rayo, rayd), want,
                               rtol=0, atol=0)


def test_training_knobs_not_ported_raise():
    cfg = load_config(overrides={**_over("streamrec"), "models": {"attn": {
        "embed": {"key": {"dropout_ff": 0.1}}}}})
    tp, ts = tpapr.create_model(cfg, seed=0, device="cpu")
    tp["points_influ_scores"] = torch.as_tensor(np.random.default_rng(0).normal(
        size=tp["points_influ_scores"].shape).astype(np.float32))
    rayo, rayd = get_rays_np(8, 8, 10.0, 10.0, np.eye(4, dtype=np.float32)[None])
    # Embedder dropout used to raise here; it is ported (held against the
    # JAX package in test_torch_dropout.py): without a generator the forward
    # is the one without dropout, with one it drops out.
    plain = load_config(overrides={**_over("streamrec"), "models": {"attn": {
        "embed": {"key": {"dropout_ff": 0.0}}}}})
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    want = tpapr.forward(tp, ts, plain, *args)
    torch.testing.assert_close(tpapr.forward(tp, ts, cfg, *args), want,
                               rtol=0, atol=0)
    got = tpapr.forward(tp, ts, cfg, *args, dropout_rng=tstep.dropout_generator(
        cfg, 3, "cpu"))
    assert bool(torch.isfinite(got).all()) and not torch.equal(got, want)
    # int8_train used to raise here; it is ported and trains (held against
    # the JAX package in test_torch_int8_train.py): finite, and within int8's
    # distance (5 % of scale, the JAX tests' bound) of the fp32 forward.
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    base = load_config(overrides=_over("streamrec"))
    tp, ts = tpapr.create_model(base, seed=0, device="cpu")
    tp["points_influ_scores"] = torch.as_tensor(np.random.default_rng(0).normal(
        size=(320, 1)).astype(np.float32))
    over = _over("streamrec")
    over["tpu"]["int8_train"] = True
    want = tpapr.forward(tp, ts, base, *args)
    got = tpapr.forward(tp, ts, load_config(overrides=over), *args)
    assert torch.isfinite(got).all() and not torch.equal(got, want)
    assert float((got - want).abs().max()) <= 0.05 * float(want.abs().max())
