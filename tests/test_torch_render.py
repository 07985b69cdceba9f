"""The render slice as a whole: a JAX ``create_model`` converted with
``from_jax_params``, rendered by both packages.

JAX runs with ``tpu.force_local`` (the CPU test host has 8 virtual devices),
``topk_impl: cull`` and ``fused_attn: streamrec``, so its Pallas kernels run
in interpret mode; the port runs the same path with its kernels' plain
versions (CPU tensors). fp32 compute; tolerance: rgb atol 1e-4 (rtol 1e-4)
for the float frames, at most 1 level for the uint8 frames."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model.papr import create_model as jax_create
from papr_tpu.model.papr import evaluate as jax_evaluate
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.train import step as jstep
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops import tile_cull as tc
from papr_tpu_torch.train import step as tstep


def _over(**tpu):
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
        "tpu": {"force_local": True, "topk_impl": "cull",
                "fused_attn": "streamrec", "cull_candidates": 256, **tpu},
    }


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load(overrides=_over())
    params, state = jax_create(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # random influence (init is 0: every score would vanish) and a few dead
    # live-range slots, so scores, masks and padding all matter
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(
        rng.normal(size=(320, 1)).astype(np.float32))
    alive = np.asarray(state["alive"]).copy()
    alive[10:40] = False
    state = {"alive": jnp.asarray(alive)}
    pnp = jax.tree.map(np.asarray, params)
    snp = jax.tree.map(np.asarray, state)
    tp, ts = from_jax_params(pnp, snp, load_config(overrides=_over()), device="cpu")
    return params, state, tp, ts


def _pose(theta=0.4, radius=2.5):
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                   np.float32)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [0, 0, radius]
    return rot @ base


@pytest.mark.parametrize("fused_attn", ["streamrec", False])
def test_render_full_image_matches_jax(models, fused_attn):
    """Odd 20x28 frame, 16x16 tiles (edge padding in both directions)."""
    params, state, tp, ts = models
    over = _over(fused_attn=fused_attn)
    jcfg, tcfg = jax_load(overrides=over), load_config(overrides=over)
    rayo, rayd = get_rays_np(20, 28, 25.0, 25.0, _pose()[None])
    want = jstep.render_full_image(params, state, jcfg, rayo, rayd, 16, 16,
                                   with_extras=True)
    calls = (tc.cull_select_plain.calls, sa.attend_eval_plain.calls)
    got = tstep.render_full_image(tp, ts, tcfg, rayo, rayd, 16, 16,
                                  with_extras=True)
    assert got["rgb"].shape == (1, 20, 28, 3)
    for name in ("rgb", "foreground", "bkg_attn", "fused", "attn"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got["selected"], want["selected"])
    assert tc.cull_select_plain.calls > calls[0]
    if fused_attn:
        assert sa.attend_eval_plain.calls > calls[1]
    # the frame is not trivial: foreground and background both present
    assert np.ptp(got["bkg_attn"]) > 0.05 and np.ptp(got["rgb"]) > 0.05


def test_render_frame_matches_jax(models):
    params, state, tp, ts = models
    jcfg, tcfg = jax_load(overrides=_over()), load_config(overrides=_over())
    c2w = _pose(1.1)
    want = jstep.render_frame(params, state, jcfg, c2w, 25.0, 25.0, 20, 28,
                              16, 16)
    got = tstep.render_frame(tp, ts, tcfg, c2w, 25.0, 25.0, 20, 28, 16, 16)
    assert got.dtype == np.uint8 and got.shape == (20, 28, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    frames = list(tstep.render_frames(tp, ts, tcfg, [c2w, _pose(0.2)], 25.0,
                                      25.0, 20, 28, 16, 16))
    np.testing.assert_array_equal(frames[0], got)
    assert len(frames) == 2 and frames[1].shape == (20, 28, 3)


def test_attention_depth_matches_jax(models):
    params, state, tp, ts = models
    rayo, rayd = get_rays_np(16, 16, 20.0, 20.0, _pose()[None])
    out = tstep.render_full_image(tp, ts, load_config(overrides=_over()),
                                  rayo, rayd, 16, 16, with_depth=True)
    want = jstep.attention_depth(rayo, out["selected"], out["attn"])
    np.testing.assert_allclose(out["depth"], want)
    assert out["depth"].shape == (1, 16, 16)


def test_create_model_tree_matches_jax():
    """The port's own init builds the JAX package's tree: same keys, same
    shapes, the same (numpy-seeded) padded points and alive mask."""
    jcfg = jax_load(overrides=_over())
    jp, js = jax_create(jcfg, jax.random.PRNGKey(0))
    tp, ts = tpapr.create_model(load_config(overrides=_over()), seed=0, device="cpu")
    flat = lambda t: {jax.tree_util.keystr(k): tuple(np.shape(v))
                      for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    as_np = lambda t: jax.tree.map(lambda v: np.asarray(v), t)
    assert flat(as_np(jax.tree.map(lambda v: v.numpy(), tp))) == flat(as_np(jp))
    np.testing.assert_array_equal(tp["points"].numpy(), np.asarray(jp["points"]))
    np.testing.assert_array_equal(ts["alive"].numpy(), np.asarray(js["alive"]))


@pytest.mark.parametrize("tpu,match", [
    pytest.param({"topk_impl": "approx"}, None, id="tpu0-approx"),
    pytest.param({"cull_prefilter_eval": "approx_min_k"}, "approx",
                 id="tpu1-approx"),
    pytest.param({"fused_attn": "stream"}, None, id="tpu2-fused_attn"),
    pytest.param({"int8_eval": True}, None, id="tpu3-int8_eval"),
    pytest.param({"query_fold": True}, None, id="tpu4-query_fold"),
    pytest.param({"mesh": {"data": 2, "rays": 1}}, None, id="tpu5-mesh"),
])
def test_unported_tpu_values_raise(models, tpu, match):
    """A value that names something not ported raises with its name. The
    values ported since (``match`` None: the exact selection for ``approx``,
    the feature streams, the folded query, the mesh, under which a single
    ``evaluate`` call is local) run instead, and agree with the
    default kernel path (fp32: attention mass atol 2e-5; the exact selection
    may swap near-tied points against the culled one, so ``approx`` compares
    no more than that). ``int8_eval`` runs the int8 one-shot attention, which
    is not the fp32 one: it is held to the JAX package's int8 kernel (exact
    integer products on both sides: fused <= 2e-3 of its scale, attention
    atol 1e-3)."""
    params, state, tp, ts = models
    cfg = load_config(overrides=_over(**tpu))
    rayo, rayd = get_rays_np(8, 8, 10.0, 10.0, _pose()[None])
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tpapr.evaluate(tp, ts, cfg, *args)
        return
    got = tpapr.evaluate(tp, ts, cfg, *args)
    want = tpapr.evaluate(tp, ts, load_config(overrides=_over()), *args)
    if "int8_eval" in tpu:
        jf, ja = jax_evaluate(params, state, jax_load(overrides=_over(**tpu)),
                              jnp.asarray(rayo), jnp.asarray(rayd))
        jf, ja = np.asarray(jf), np.asarray(ja)
        assert np.abs(got[0].numpy() - jf).max() <= 2e-3 * np.abs(jf).max()
        assert np.abs(got[1].numpy() - ja).max() <= 1e-3
        assert not torch.equal(got[1], want[1])
        return
    torch.testing.assert_close(got[1].sum(-2), want[1].sum(-2), rtol=0,
                               atol=2e-5)
    if "topk_impl" not in tpu:
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-5)


@pytest.mark.parametrize("tpu,plain", [
    ({"topk_impl": "pallas"}, "topk"),
    ({"fused_attn": "score"}, "score"),
    ({"fused_attn": "embed"}, "embed"),
    ({"fused_attn": True}, "both"),
    ({"eval_fused": False}, "streams"),
    ({"fused_attn": "stream"}, "features"),
    ({"query_fold": True}, "folded"),
])
def test_ported_tpu_values_run(models, tpu, plain):
    """The values that used to raise now run: on CPU tensors through their
    kernels' plain versions, agreeing with the default kernel path (fp32:
    fused features and attention atol 2e-5; the packed selection may swap
    near-tied points, so ``pallas`` compares attention mass only)."""
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import pallas_topk as pt
    from papr_tpu_torch.ops import stream_feat as sf
    _, _, tp, ts = models
    rayo, rayd = get_rays_np(8, 8, 10.0, 10.0, _pose()[None])
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    want = tpapr.evaluate(tp, ts, load_config(overrides=_over()), *args)
    counters = {"topk": [pt.topk_stream_plain],
                "score": [fa.fused_scores_plain],
                "embed": [fm.fused_mlp_plain],
                "both": [fa.fused_scores_plain, fm.fused_mlp_plain],
                "streams": [sa.key_stream_plain, sa.value_stream_plain],
                "features": [sf.key_stream_feat_plain,
                             sf.value_stream_feat_plain],
                "folded": [sa.key_stream_q_plain, sa.value_stream_plain]}[plain]
    before = [c.calls for c in counters]
    got = tpapr.evaluate(tp, ts, load_config(overrides=_over(**tpu)), *args)
    assert all(c.calls > b for c, b in zip(counters, before))
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    torch.testing.assert_close(got[1].sum(-2), want[1].sum(-2), rtol=0,
                               atol=2e-5)
    if plain != "topk":
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=2e-5)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=2e-5)


def test_auto_on_cpu_takes_the_plain_versions(models):
    """tpu.* auto on CPU tensors: the culled selection and the eval kernels'
    plain versions run; no kernel is launched."""
    _, _, tp, ts = models
    cfg = load_config(overrides=_over(topk_impl="auto", fused_attn="auto"))
    rayo, rayd = get_rays_np(8, 8, 10.0, 10.0, _pose()[None])
    launches = (tc.cull_select.launches, fm.fused_mlp.launches,
                sa.attend_eval_idx.launches)
    calls = (tc.cull_select_plain.calls, fm.fused_mlp_plain.calls,
             sa.attend_eval_plain.calls)
    tpapr.evaluate(tp, ts, cfg, torch.as_tensor(rayo), torch.as_tensor(rayd))
    assert (tc.cull_select.launches, fm.fused_mlp.launches,
            sa.attend_eval_idx.launches) == launches
    assert all(b == a + 1 for a, b in zip(
        calls, (tc.cull_select_plain.calls, fm.fused_mlp_plain.calls,
                sa.attend_eval_plain.calls)))
