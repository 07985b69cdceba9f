"""The reference's ``model.pth`` format on the port
(``papr_tpu_torch/model/torch_convert.py``, ``train/checkpoint.py``
``import_torch`` / ``export_torch``) against ``papr_tpu``'s converter.

The state dicts: the same key set and bit-equal arrays, both ways, for the
UNet with and without its norm (the DoubleConv's second conv at index 2 or
3), the MLP renderer, with and without point features, and a weight-normed
mapping MLP; the imports padded, ``alive`` rebuilt, ``exclude_keys``
honoured and the shading codes returned as extras, all bit-equal. A
``.pth`` written by JAX renders through the port within
``test_torch_render.py``'s tolerance (rgb atol 1e-4, rtol 1e-4; JAX's
Pallas kernels in interpret mode, the port's plain versions); one written
by the port loads in JAX leaf for leaf. ``train_and_eval`` and the test
CLI take a ``.pth`` ``load_path``."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.model import torch_convert as jtc
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.train import checkpoint as jck
from papr_tpu.train import step as jstep
from papr_tpu_torch.config import load_config, make_eval_config
from papr_tpu_torch.convert import from_jax_params
from papr_tpu_torch.dataset.synth import make_demo_scene
from papr_tpu_torch.model import torch_convert as ttc
from papr_tpu_torch.train import checkpoint as tck
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.optim import tree_leaves

VARIANTS = {
    "unet": {},
    "unet_instance_double": {"models": {"renderer": {"generator": {
        "small_unet": {"norm": "instance", "single": False,
                       "render_scale": 2}}}}},
    "mlp_renderer": {"models": {"renderer": {"generator": {
        "type": "mlp", "mlp": {
            "num_layers": 3, "num_channels": 16, "use_wn": True,
            "skip_layers": [1], "bias": True, "half_layers": [],
            "act_type": "relu", "last_act_type": "none", "act_a": 1.0,
            "act_b": 1.0}}}}},
    "no_pc_feats": {"geoms": {"point_feats": {"use_inv": False}}},
    "wn_mapping": {"exposure_control": {"mapping_mlp": {"use_wn": True}}},
}


def _over(variant="unet", **extra):
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
            "value": {"d_ff": 16, "d_ff_out": 8, "n_ff_layer": 3}}}},
        "exposure_control": {
            "use": True, "shading_code_dim": 8,
            "mapping_mlp": {"num_layers": 3, "dim": 16, "out_dim": 16}},
        "tpu": {"force_local": True, "topk_impl": "cull",
                "fused_attn": "streamrec", "cull_candidates": 256},
    }
    from papr_tpu_torch.config import merge_config
    merge_config(over, VARIANTS[variant])
    merge_config(over, extra)
    return over


def _jax_model(variant="unet", key=0):
    jcfg = jax_load(overrides=_over(variant))
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(key))
    rng = np.random.default_rng(key)
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(
        rng.normal(size=(320, 1)).astype(np.float32))
    alive = np.asarray(state["alive"]).copy()
    alive[10:40] = False                 # holes: the export unpads
    return jcfg, params, {"alive": jnp.asarray(alive)}


def _port(cfg, params, state):
    return from_jax_params(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, state), cfg, device="cpu")


def _np(sd):
    return {k: np.asarray(torch.as_tensor(v)) for k, v in sd.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_state_dicts_match_jax_both_ways(variant):
    jcfg, params, state = _jax_model(variant)
    cfg = load_config(overrides=_over(variant))
    tp, ts = _port(cfg, params, state)
    want = jtc.to_torch_state_dict(params, state, jcfg)
    got = _np(ttc.to_torch_state_dict(tp, ts, cfg))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["points"].shape == (270, 3)
    if variant == "wn_mapping":
        assert "mapping_mlp.model.model.1.weight_v" in got
    if variant == "unet_instance_double":
        assert "renderer.up1.conv.double_conv.3.weight" in got

    # Import into a fresh model of another seed: bit-equal to JAX's import,
    # the shading codes as extras, one key excluded.
    codes = np.random.default_rng(1).standard_normal((4, 8)).astype(
        np.float32)
    sd = dict(want, train_shading_codes=codes, eval_shading_codes=codes[:1])
    excl = ("proximity_attn.attention_layer.w_q",)
    jcfg9, jp9, js9 = _jax_model(variant, key=9)
    tp9, ts9 = _port(cfg, jp9, js9)      # first: JAX's import edits jp9
    jp, js, jx = jtc.from_torch_state_dict(jp9, js9, jcfg9, sd,
                                           exclude_keys=excl)
    tsd = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
    gp, gs, gx = ttc.from_torch_state_dict(tp9, ts9, cfg, tsd,
                                           exclude_keys=excl)
    for g, w in zip(tree_leaves(gp), jax.tree.leaves(jp)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(gs["alive"].numpy(), np.asarray(js["alive"]))
    assert int(gs["alive"].sum()) == 270 and bool(gs["alive"][:270].all())
    assert float(gp["points"][300:].min()) == 1e8
    # The excluded key kept the fresh init; the template was not modified.
    np.testing.assert_array_equal(gp["attn"]["w_q"]["w"].numpy(),
                                  tp9["attn"]["w_q"]["w"].numpy())
    assert not torch.equal(gp["attn"]["w_k"]["w"], tp9["attn"]["w_k"]["w"])
    assert set(gx) == set(jx) == {"train_shading_codes", "eval_shading_codes"}
    for k in gx:
        np.testing.assert_array_equal(gx[k].numpy(), np.asarray(jx[k]))


def test_exclude_keys_from_config():
    jcfg, params, state = _jax_model()
    over = _over(training={"exclude_keys": ["mapping_mlp"]})
    cfg = load_config(overrides=over)
    tp, ts = _port(cfg, params, state)
    sd = ttc.to_torch_state_dict(tp, ts, cfg)
    fresh, fs = _port(cfg, *_jax_model(key=3)[1:])
    gp, _, gx = ttc.from_torch_state_dict(fresh, fs, cfg, sd)
    assert gx == {}
    for a, b in zip(tree_leaves(gp["mapping_mlp"]),
                    tree_leaves(fresh["mapping_mlp"])):
        assert torch.equal(a, b)
    assert torch.equal(gp["attn"]["w_k"]["w"], tp["attn"]["w_k"]["w"])


def test_pth_files_cross_packages(tmp_path):
    """JAX's export renders through the port; the port's export loads in
    JAX leaf for leaf, as JAX's own export does."""
    jcfg, params, state = _jax_model()
    cfg = load_config(overrides=_over())
    jpath, tpath = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    jck.export_torch(jpath, params, state, jcfg, step=1234)

    tp0, ts0 = _port(cfg, *_jax_model(key=5)[1:])
    step, tp, ts, extras = tck.import_torch(jpath, tp0, ts0, cfg)
    assert step == 1234 and extras == {}
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.2, 0.1, 2.5]
    rayo, rayd = get_rays_np(32, 32, 40.0, 40.0, c2w[None])
    want = jstep.render_full_image(params, state, jcfg, rayo, rayd, 16, 16)
    got = tstep.render_full_image(tp, ts, cfg, rayo, rayd, 16, 16)
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]), rtol=1e-4,
                               atol=1e-4)

    codes = {"train_shading_codes": np.ones((3, 8), np.float32),
             "eval_shading_codes": np.zeros((1, 8), np.float32)}
    tck.export_torch(tpath, tp, ts, cfg, step=77, extras=codes)
    # A fresh template each: JAX's import edits its template's nested dicts.
    s_port, jp_port, js_port, jx = jck.import_torch(
        tpath, *_jax_model(key=5)[1:], jcfg)
    s_jax, jp_jax, js_jax, _ = jck.import_torch(
        jpath, *_jax_model(key=5)[1:], jcfg)
    assert s_port == 77 and s_jax == 1234
    for a, b in zip(jax.tree.leaves(jp_port), jax.tree.leaves(jp_jax)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(js_port["alive"]),
                                  np.asarray(js_jax["alive"]))
    for k, v in codes.items():
        np.testing.assert_array_equal(np.asarray(jx[k]), v)


def test_loop_and_test_cli_take_a_pth(tmp_path, monkeypatch):
    """``train_and_eval`` starts from a ``.pth`` ``load_path`` and the test
    CLI renders from a ``.pth`` ``test.load_path``."""
    from papr_tpu_torch.cli import test as cli_test
    from papr_tpu_torch.model.papr import create_model
    from papr_tpu_torch.train.loop import train_and_eval

    monkeypatch.setenv("PAPR_PLATFORM", "cpu")
    scene = make_demo_scene(str(tmp_path / "scene"), n_train=2, n_test=1,
                            H=24, W=24)
    ds = {"name": "testset", "type": "synthetic", "path": scene}
    over = _over(
        index="pth", save_dir=str(tmp_path / "exp"),
        dataset={"type": "synthetic", "path": scene,
                 "patches": {"height": 16, "width": 16}},
        exposure_control={"use": False},
        training={"steps": 1, "prune_steps": 0, "add_steps": 0,
                  "losses": {"mse": 1.0, "lpips": 0.0, "lpips_alex": 0.0}},
        eval={"dataset": ds, "step": 1, "img_idx": 0, "max_height": 16,
              "max_width": 16, "save_fig": False},
        test={"max_height": 16, "max_width": 16, "save_fig": False,
              "datasets": [ds]})
    cfg0 = load_config(overrides=over)
    src, src_state = create_model(cfg0, seed=4, device="cpu")
    pth = str(tmp_path / "model.pth")
    tck.export_torch(pth, src, src_state, cfg0, step=9)

    cfg = load_config(overrides=dict(over, load_path=pth))
    seen = []
    real = tck.import_torch

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out[1]["points"].clone())
        return out

    monkeypatch.setattr("papr_tpu_torch.train.loop.import_torch", spy)
    train_and_eval(cfg, make_eval_config(cfg))
    assert len(seen) == 1 and torch.equal(seen[0], src["points"])

    tcfg = load_config(overrides=dict(over, test=dict(over["test"],
                                                      load_path=pth)))
    params, state, step, extras = cli_test.load_test_model(tcfg, 250000,
                                                           torch.device("cpu"))
    assert step == 9 and extras == {}
    got = ttc.to_torch_state_dict(params, state, tcfg)    # the live points
    want = ttc.to_torch_state_dict(src, src_state, cfg0)
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    means = cli_test.run_test(tcfg, "testset", "test", 250000)
    assert np.isfinite(means["psnr"])
    assert os.path.exists(os.path.join(str(tmp_path / "exp"), "pth",
                                       "checkpoint.npz"))
