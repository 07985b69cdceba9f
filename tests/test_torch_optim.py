"""The port's schedules and per-group Adam against ``papr_tpu.train``.

Schedules: every type of ``training.lr`` at sample steps, rtol 1e-5. Adam:
identical gradients fed to both packages, over several steps with weight
decay, ``fix_keys`` and a rebuild that resets ``t`` while the schedule keeps
the global step; updated parameters and moments rtol 1e-5. Both packages
form the bias corrections in float32 (1 - 0.999^1 differs by ~1e-5
relative between float32 and float64)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import Config as JConfig
from papr_tpu.config import load_config as jax_load
from papr_tpu.train import optim as jopt
from papr_tpu.train.schedules import make_schedule as jax_schedule
from papr_tpu_torch.config import Config, load_config
from papr_tpu_torch.train import optim as topt
from papr_tpu_torch.train.schedules import make_schedule

STEPS = (0, 1, 7, 99, 100, 101, 2500, 9999, 10000, 10001, 123456, 249999,
         250000)


@pytest.mark.parametrize("sched", [
    {"type": "none", "base_lr": 1e-6},
    {"type": "linear", "base_lr": 3e-4, "warmup": 100},
    {"type": "cosine", "base_lr": 2e-3, "warmup": 0},
    {"type": "cosine-hlfperiod", "base_lr": 3e-4, "warmup": 10000},
    {"type": "exp", "base_lr": 1e-3, "warmup": 100, "gamma": 0.9999},
    {"type": "stop", "base_lr": 1e-3, "warmup": 100},
])
def test_schedules_match_jax(sched):
    want = jax_schedule(JConfig(sched), 250000, 0.5)
    got = make_schedule(Config(sched), 250000, 0.5)
    for s in STEPS:
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s))),
                                   rtol=1e-5, atol=1e-30, err_msg=str(s))


def _tree(rng):
    """A params tree with every group, nested like the model's."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"points": f(50, 3), "points_influ_scores": f(50, 1),
            "pc_feats": f(50, 8), "bkg_feats": f(1, 3),
            "attn": {"w_q": {"w": f(4, 6), "bias": f(4)},
                     "embed_k": {"mlp": {"layers": [{"w": f(6, 5)},
                                                    {"w": f(3, 6)}]}}},
            "renderer": {"layers": [{"w": f(3, 3)}]},
            "mapping_mlp": {"layers": [{"w": f(2, 2)}]}}


OVER = {"training": {"fix_keys": ["pc_feats"], "lr": {
    "attn": {"weight_decay": 0.01},
    "points": {"weight_decay": 1e-3}}},
    "geoms": {"background": {"learnable": True}},
    "exposure_control": {"use": True}}


def test_adam_matches_jax_with_decay_fix_keys_and_reset():
    rng = np.random.default_rng(0)
    pnp = _tree(rng)
    jcfg, cfg = jax_load(overrides=OVER), load_config(overrides=OVER)
    jspecs, tspecs = jopt.build_group_specs(jcfg), topt.build_group_specs(cfg)
    assert set(jspecs) == set(tspecs)
    assert "pc_feats" not in tspecs and "bkg_feats" in tspecs
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = topt.tree_map(lambda a: torch.tensor(a), pnp)
    js, ts = jopt.init_opt_state(jp, jspecs), topt.init_opt_state(tp, tspecs)
    step = 9998
    for i in range(6):
        if i == 3:          # prune / grow rebuild: moments and t reset
            js = jopt.init_opt_state(jp, jspecs)
            ts = topt.init_opt_state(tp, tspecs)
        g = _tree(rng)
        jp, js = jopt.apply_updates(jp, jax.tree.map(jnp.asarray, g), js,
                                    jspecs, jnp.asarray(step))
        topt.apply_updates(tp, {k: topt.tree_map(torch.tensor, g[k])
                                for k in tspecs}, ts, tspecs, step)
        step += 1
    assert all(st["t"] == 3 for st in ts.values())
    for key in pnp:
        for a, b in zip(topt.tree_leaves(tp[key]), jax.tree.leaves(jp[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7, err_msg=key)
    np.testing.assert_array_equal(tp["pc_feats"].numpy(), pnp["pc_feats"])
    for key in tspecs:
        for name in ("m", "v"):
            for a, b in zip(topt.tree_leaves(ts[key][name]),
                            jax.tree.leaves(js[key][name])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-12,
                                           err_msg=f"{key} {name}")
