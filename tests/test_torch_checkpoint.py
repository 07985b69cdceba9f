"""``papr_tpu_torch/train/checkpoint.py``: bit-equal round trip, interchange
of ``checkpoint.npz`` with ``papr_tpu.train.checkpoint`` in both directions,
a resume that restores Adam's moments and step counts, and a reference
``model.pth`` beside the native file (``tests/test_torch_model_pth.py`` holds
that format against JAX's)."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.train import checkpoint as jck
from papr_tpu.train import optim as joptim
from papr_tpu_torch.config import load_config
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.train import checkpoint as ck
from papr_tpu_torch.train.optim import (apply_updates, build_group_specs,
                                        init_opt_state, tree_leaves, tree_map)

OVER = {"use_amp": False, "max_num_pts": 60,
        "geoms": {"points": {"select_k": 4, "init_num": 50},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 16, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "query": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2}}}}}


def _port_state(steps=3):
    """A model a few Adam steps in (random gradients), so the moments and
    ``t`` are not trivial."""
    cfg = load_config(overrides=OVER)
    params, state = tpapr.create_model(cfg, seed=0, device="cpu")
    specs = build_group_specs(cfg)
    opt = init_opt_state(params, specs)
    gen = torch.Generator().manual_seed(1)
    for s in range(steps):
        grads = {k: tree_map(lambda t: torch.randn(t.shape, generator=gen),
                             params[k]) for k in opt}
        apply_updates(params, grads, opt, specs, s)
    state["alive"][5:9] = False
    return cfg, params, opt, state


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_round_trip_is_bit_equal(tmp_path):
    cfg, params, opt, state = _port_state()
    hist = {"steps": [1, 2], "train_losses": [0.5, 0.25]}
    ck.save_checkpoint(str(tmp_path), 7, params, opt, state, histories=hist,
                       keep_snapshot=True)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.npz",
                                            "checkpoint_7.npz",
                                            "histories.json"]
    step, tree = ck.load_checkpoint(str(tmp_path))
    assert step == 7 and set(tree) == {"params", "opt_state", "state"}
    fresh_p, fresh_s = tpapr.create_model(cfg, seed=9, device="cpu")
    fresh_o = init_opt_state(fresh_p, build_group_specs(cfg))
    _assert_trees_equal(ck.restore_into(fresh_p, tree["params"]), params)
    _assert_trees_equal(ck.restore_into(fresh_s, tree["state"]), state)
    got_o = ck.restore_into(fresh_o, tree["opt_state"])
    _assert_trees_equal(got_o, opt)
    assert all(got_o[k]["t"] == 3 and isinstance(got_o[k]["t"], int)
               for k in got_o)
    assert ck.load_histories(str(tmp_path)) == hist
    assert ck.load_histories(str(tmp_path / "nope")) == {}
    snap = ck.load_checkpoint(str(tmp_path / "checkpoint_7.npz"))
    assert snap[0] == 7
    with pytest.raises(KeyError, match="missing"):
        ck.restore_into({"extra": torch.zeros(1), **fresh_s}, tree["state"])


def test_save_is_atomic_and_pth_raises(tmp_path):
    cfg, params, opt, state = _port_state(1)
    ck.save_checkpoint(str(tmp_path), 1, params, opt, state)
    ck.save_checkpoint(str(tmp_path), 2, params, opt, state)
    assert os.listdir(tmp_path) == ["checkpoint.npz"]      # no temp left
    assert ck.load_checkpoint(str(tmp_path))[0] == 2
    # A reference model.pth beside it loads (through import_torch) into a
    # fresh model: the same live points and weights.
    pth = str(tmp_path / "model.pth")
    ck.export_torch(pth, params, state, cfg, step=2)
    assert ck.is_native(str(tmp_path)) and not ck.is_native(pth)
    fresh_p, fresh_s = tpapr.create_model(cfg, seed=9, device="cpu")
    step, got_p, got_s, extras = ck.import_torch(pth, fresh_p, fresh_s, cfg)
    assert step == 2 and extras == {}
    alive = state["alive"]
    assert int(got_s["alive"].sum()) == int(alive.sum())
    assert torch.equal(got_p["points"][:int(alive.sum())],
                       params["points"][alive])
    assert torch.equal(got_p["attn"]["w_k"]["w"], params["attn"]["w_k"]["w"])


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg, params, opt, state = _port_state()
    ck.save_checkpoint(str(tmp_path), 11, params, opt, state)
    jcfg = jax_load(overrides=OVER)
    jp, js = jpapr.create_model(jcfg, jax.random.PRNGKey(3))
    jo = joptim.init_opt_state(jp, joptim.build_group_specs(jcfg))
    step, tree = jck.load_checkpoint(str(tmp_path))
    assert step == 11
    jp = jck.restore_into(jp, tree["params"])
    jo = jck.restore_into(jo, tree["opt_state"])
    js = jck.restore_into(js, tree["state"])
    for got, want in ((jp, params), (js, state), (jo, opt)):
        gl = jax.tree.leaves(got)
        wl = tree_leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            np.testing.assert_array_equal(np.asarray(g), w)
    assert all(int(jo[k]["t"]) == 3 for k in jo)


def test_jax_checkpoint_loads_in_port(tmp_path):
    jcfg = jax_load(overrides=OVER)
    jp, js = jpapr.create_model(jcfg, jax.random.PRNGKey(3))
    specs = joptim.build_group_specs(jcfg)
    jo = joptim.init_opt_state(jp, specs)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.1,
                         {k: jp[k] for k in jo})
    jp, jo = joptim.apply_updates(jp, grads, jo, specs, 0)
    jck.save_checkpoint(str(tmp_path), 5, jp, jo, js)
    cfg = load_config(overrides=OVER)
    params, state = tpapr.create_model(cfg, seed=0, device="cpu")
    opt = init_opt_state(params, build_group_specs(cfg))
    step, tree = ck.load_checkpoint(str(tmp_path))
    assert step == 5
    params = ck.restore_into(params, tree["params"])
    opt = ck.restore_into(opt, tree["opt_state"])
    state = ck.restore_into(state, tree["state"])
    for got, want in ((params, jp), (state, js), (opt, jo)):
        gl, wl = tree_leaves(got), jax.tree.leaves(want)
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            np.testing.assert_array_equal(g, np.asarray(w))
    assert state["alive"].dtype == torch.bool
    assert all(opt[k]["t"] == 1 for k in opt)
    assert float(tree_leaves(opt["attn"]["m"])[0].abs().max()) > 0
