"""``papr_tpu_torch.train.loop.train_and_eval`` against
``papr_tpu.train.loop.train_and_eval`` on the same procedural scene, seed and
initial weights (a JAX ``checkpoint.npz`` that both load through
``load_path``): 8 steps with one prune and one grow event, an eval render and
a checkpoint after every step.

Both run the exact selection and the plain attention path in fp32 on the
CPU. Tolerances: the loss of each step until the first prune rtol 1e-3 (Adam
moves every weight by about lr x sign(g) per step, so rounding differences
grow from step to step), the eval PSNR of those steps within 0.05 dB; the
same number of points pruned and added."""

import os
import re

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.config import make_eval_config as jax_eval_config
from papr_tpu.model import papr as jpapr
from papr_tpu.train import checkpoint as jck
from papr_tpu.train import loop as jloop
from papr_tpu.train import optim as joptim
from papr_tpu_torch.config import load_config, make_eval_config
from papr_tpu_torch.dataset.synth import make_demo_scene
from papr_tpu_torch.train import checkpoint as ck
from papr_tpu_torch.train import loop as tloop


def _over(scene, save_dir, load_path):
    return {
        "index": "loop", "save_dir": save_dir, "load_path": load_path,
        "seed": 1, "use_amp": False, "max_num_pts": 120,
        "dataset": {"coord_scale": 1.0, "type": "synthetic", "path": scene,
                    "patches": {"height": 16, "width": 16}},
        "geoms": {"points": {"select_k": 4, "init_num": 100,
                             "init_scale": [0.8, 0.8, 0.8]},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 16, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "query": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2}}}},
        "training": {
            "steps": 8, "prune_steps": 4, "prune_start": 4, "prune_stop": 8,
            "add_steps": 6, "add_start": 6, "add_stop": 8, "add_num": 5,
            "losses": {"mse": 1.0, "lpips": 0.0, "lpips_alex": 0.0}},
        "eval": {"dataset": {"name": "testset", "path": scene}, "step": 1,
                 "img_idx": 0, "max_height": 16, "max_width": 16,
                 "save_fig": False},
        "tpu": {"ray_chunk": 512, "topk_impl": "xla", "fused_attn": False},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    scene = make_demo_scene(str(root / "scene"), n_train=4, n_test=2, H=32,
                            W=32)
    init = str(root / "init")
    jcfg0 = jax_load(overrides=_over(scene, str(root / "j"), ""))
    jp, js = jpapr.create_model(jcfg0, jax.random.PRNGKey(1))
    jo = joptim.init_opt_state(jp, joptim.build_group_specs(jcfg0))
    jck.save_checkpoint(init, 0, jp, jo, js)
    out = {}
    for name, load, evalc, loop in (
            ("jax", jax_load, jax_eval_config, jloop),
            ("port", load_config, make_eval_config, tloop)):
        cfg = load(overrides=_over(scene, str(root / name), init))
        log = []
        import builtins
        real = builtins.print
        builtins.print = lambda *a, **k: (log.append(" ".join(map(str, a))),
                                          real(*a, **k))
        try:
            if name == "port":
                os.environ["PAPR_PLATFORM"] = "cpu"
            res = loop.train_and_eval(cfg, evalc(cfg))
        finally:
            builtins.print = real
            os.environ.pop("PAPR_PLATFORM", None)
        out[name] = (cfg, res, "\n".join(log))
    return out


def test_losses_until_the_first_prune_match_jax(runs):
    jh, th = runs["jax"][1][3], runs["port"][1][3]
    assert th["steps"] == jh["steps"] == list(range(1, 9))
    np.testing.assert_allclose(th["train_losses"][:4], jh["train_losses"][:4],
                               rtol=1e-3)
    np.testing.assert_allclose(th["eval_psnrs"][:4], jh["eval_psnrs"][:4],
                               atol=0.05)
    np.testing.assert_allclose(th["pt_lrs"], jh["pt_lrs"], rtol=1e-6)
    np.testing.assert_allclose(th["attn_lrs"], jh["attn_lrs"], rtol=1e-6)
    assert all(np.isfinite(th["train_losses"])) and len(th["eval_losses"]) == 8


def test_prune_and_grow_counts_match_jax(runs):
    events = {}
    for name in ("jax", "port"):
        log = runs[name][2]
        events[name] = (re.findall(r"Step (\d+): Pruned (\d+) points", log),
                        re.findall(r"Step (\d+): Added (\d+) points", log))
        assert "Training finished!" in log
    assert events["port"] == events["jax"]
    assert [s for s, _ in events["port"][0]] == ["4"]
    assert events["port"][1] == [("6", "5")]
    alive_j = int(np.asarray(runs["jax"][1][2]["alive"]).sum())
    assert int(runs["port"][1][2]["alive"].sum()) == alive_j


def test_checkpoint_and_resume(runs):
    """The loop's last checkpoint holds the returned state; a resume at the
    final step restores parameters, moments and step counts bit for bit and
    trains no further."""
    cfg, (params, opt, state, hist), _ = runs["port"]
    log_dir = os.path.join(cfg.save_dir, cfg.index)
    step, tree = ck.load_checkpoint(log_dir)
    assert step == 8
    np.testing.assert_array_equal(tree["params"]["points"],
                                  params["points"].numpy())
    # fresh moments since the grow at step 6: two Adam steps
    assert int(tree["opt_state"]["attn"]["t"]) == opt["attn"]["t"] == 2
    os.environ["PAPR_PLATFORM"] = "cpu"
    try:
        p2, o2, s2, h2 = tloop.train_and_eval(cfg, make_eval_config(cfg),
                                              resume=1)
    finally:
        os.environ.pop("PAPR_PLATFORM", None)
    assert torch.equal(p2["points"], params["points"])
    assert torch.equal(s2["alive"], state["alive"])
    from papr_tpu_torch.train.optim import tree_leaves
    for a, b in zip(tree_leaves(o2), tree_leaves(opt)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert h2["steps"] == hist["steps"]


def test_loop_needs_a_card_unless_asked_for_the_cpu(runs):
    cfg = runs["port"][0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="PAPR_PLATFORM=cpu"):
            tloop.train_and_eval(cfg, make_eval_config(cfg))
    over = dict(cfg)
    over["tpu"] = dict(over["tpu"], mesh={"data": 2, "rays": 1})
    from papr_tpu_torch.config import Config
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tloop.train_and_eval(Config(over), make_eval_config(Config(over)))
