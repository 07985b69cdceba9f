"""Embedder dropout in training (``dropout_ff > 0``), the port against the JAX
package (``papr_tpu/nn/mlp.py feedforward_apply``, the key split of
``papr_tpu/model/attention.py`` and the step's ``fold_in(PRNGKey(seed),
step)``).

The two packages draw their masks from different generators, so the port is
held to JAX with JAX's masks passed in: the port's one draw,
``nn.mlp.dropout_keep``, is replaced by one that returns the masks
``jax.random.bernoulli`` gives for the step's three keys; then the loss
(rtol 1e-5) and every gradient (rtol 3e-4, atol 1e-6 x the gradient's max)
agree, fp32. The port's own masks are held statistically: the keep share of
2^20 draws within 4 sigma of 1 - rate. A resumed run (a new step function, the
same step) draws the same masks; another step draws others.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.nn.activations import build_activation
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_params
from papr_tpu_torch.nn import mlp as tmlp
from papr_tpu_torch.nn.mlp import policy_from_config
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves, tree_map

RATES = {"key": 0.1, "query": 0.2, "value": 0.3}
STEP = 7


def _over():
    """A small fp32 model with dropout in all three embedders; MSE only."""
    emb = {n: {"d_ff": 24, "d_ff_out": 24 if n != "value" else 8,
               "n_ff_layer": 2, "dropout_ff": r} for n, r in RATES.items()}
    return {"use_amp": False, "seed": 3, "max_num_pts": 320,
            "dataset": {"coord_scale": 1.0},
            "geoms": {"points": {"select_k": 6, "init_num": 300,
                                 "init_scale": [0.6, 0.6, 0.6]},
                      "point_feats": {"dim": 8}},
            "models": {"attn": {"d_model": 32, "embed": {
                "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2], **emb}}},
            "training": {"losses": {"mse": 1.0, "lpips": 0.0}},
            "tpu": {"force_local": True, "topk_impl": "cull",
                    "cull_candidates": 256}}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_load(overrides=_over())
    tcfg = load_config(overrides=_over())
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(np.random.default_rng(0).normal(
        size=(320, 1)).astype(np.float32))
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), tcfg,
                             device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, 0.1, 2.5]
    rayo, rayd = get_rays_np(12, 12, 15.0, 15.0, c2w[None])
    target = np.random.default_rng(1).random((1, 12, 12, 3)).astype(np.float32)
    return jcfg, tcfg, params, state, tp, ts, (rayo, rayd, target, c2w)


def _jax_masks(seed, step):
    """The keep masks the JAX step draws for (seed, step): one key per
    embedder, key / query / value (attention.py splits the step's key)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step),
                            3)
    return lambda i, keep, shape: np.array(
        jax.random.bernoulli(keys[i], keep, shape))


def test_dropout_step_matches_jax_with_the_mask_passed_in(model, monkeypatch):
    jcfg, tcfg, params, state, tp, ts, (rayo, rayd, target, c2w) = model
    last = build_activation(jcfg.models.last_act)
    jloss = jget_loss(jcfg.training.losses)
    key = jax.random.fold_in(jax.random.PRNGKey(int(jcfg.seed)), STEP)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(last(jpapr.forward(p, state, jcfg, jnp.asarray(rayo),
                                           jnp.asarray(rayd),
                                           dropout_rng=key)),
                        jnp.asarray(target))))(params)

    draw, seen = _jax_masks(int(tcfg.seed), STEP), []

    def jax_keep(gen, keep, shape, device):
        assert isinstance(gen, torch.Generator)
        i = len(seen)
        seen.append((keep, tuple(shape)))
        return torch.as_tensor(draw(i, keep, tuple(shape)), device=device)

    monkeypatch.setattr(tmlp, "dropout_keep", jax_keep)
    tl, _, tg = tstep.loss_and_grads(
        tp, ts, tcfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(target), c2w, get_loss(tcfg.training.losses),
        build_group_specs(tcfg), policy_from_config(tcfg),
        dropout_rng=tstep.dropout_generator(tcfg, STEP, "cpu"))
    # one mask per embedder, key / query / value, at 1 - rate
    assert [k for k, _ in seen] == pytest.approx([0.9, 0.8, 0.7])
    assert [s[-1] for _, s in seen] == [24, 24, 8]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in tg:
        for a, b in zip(tree_leaves(tg[k]),
                        jax.tree.leaves(jax.tree.map(np.asarray, jg[k]))):
            np.testing.assert_allclose(
                a.numpy(), b, rtol=3e-4,
                atol=1e-6 * max(float(np.abs(b).max()), 1e-30), err_msg=k)
    # and the masks matter: without dropout the loss is another one
    tl0, _, _ = tstep.loss_and_grads(
        tp, ts, tcfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(target), c2w, get_loss(tcfg.training.losses),
        build_group_specs(tcfg), policy_from_config(tcfg))
    assert abs(float(tl0) - float(tl)) > 1e-6


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_within_4_sigma(rate):
    """The port's own masks: keep share within 4 sigma of 1 - rate, and the
    FeedForward's kept values scaled by 1 / (1 - rate)."""
    n = 1 << 20
    keep = tmlp.dropout_keep(torch.Generator().manual_seed(5), 1.0 - rate,
                             (n,), "cpu")
    p = 1.0 - rate
    assert abs(float(keep.float().mean()) - p) <= 4 * np.sqrt(p * (1 - p) / n)
    cfg = load_config(overrides={"models": {"attn": {"embed": {"key": {
        "norm": "none", "n_ff_layer": 1, "d_ff_out": 64, "ff_last_act": "none",
        "dropout_ff": rate}}}}})
    ff_cfg = cfg.models.attn.embed.key
    params = tmlp.feedforward_init(torch.Generator().manual_seed(6), 16, 64,
                                   ff_cfg)
    x = torch.randn(512, 16, generator=torch.Generator().manual_seed(7))
    full = tmlp.feedforward_apply(params, x, ff_cfg, 64)
    out = tmlp.feedforward_apply(params, x, ff_cfg, 64,
                                 dropout_rng=torch.Generator().manual_seed(8))
    kept = out != 0
    torch.testing.assert_close(out[kept], full[kept] / p)
    share = float(kept.float().mean())
    assert abs(share - p) <= 4 * np.sqrt(p * (1 - p) / out.numel())


def test_resume_replays_the_same_masks(model, monkeypatch):
    """Two step functions (a run and its resume) at the same step draw the
    same masks; the next step draws other ones."""
    _, tcfg, _, _, tp, ts, (rayo, rayd, target, c2w) = model
    drawn = []

    def recording(gen, keep, shape, device):
        m = torch.rand(shape, generator=gen, device=device) < keep
        drawn.append(m)
        return m

    monkeypatch.setattr(tmlp, "dropout_keep", recording)
    loss_fn = get_loss(tcfg.training.losses)
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd),
            torch.as_tensor(target), c2w)
    runs = []
    for step in (STEP, STEP, STEP + 1):
        fn = tstep.make_train_step(tcfg, loss_fn)
        p = {k: tree_map(torch.clone, v) for k, v in tp.items()}
        drawn.clear()
        opt = tstep.make_opt_state(tcfg, p)
        _, _, loss, _ = fn(p, opt, ts, *args, step)
        runs.append(([m.clone() for m in drawn], float(loss)))
    (a, la), (b, lb), (c, lc) = runs
    assert len(a) == 3 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert la == lb
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
