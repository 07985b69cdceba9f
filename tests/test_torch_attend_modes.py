"""The attention modes this slice adds, as the whole model: ``forward`` (with
the gradient of every trained group) and ``evaluate`` of
``papr_tpu_torch.model.papr`` against ``papr_tpu.model.papr`` with the same
knobs: ``tpu.fused_attn`` in (true, embed, score, stream), ``tpu.topk_impl:
pallas``, ``tpu.query_fold: true`` (with ``streamrec``) and ``tpu.eval_fused:
false``.

JAX runs with ``tpu.force_local`` so its Pallas kernels run in interpret
mode; the port runs its kernels' plain versions (CPU tensors). fp32.
Tolerances: equal selection; fused features and attention atol 2e-5; loss
rtol 1e-5; gradients rtol 3e-4 with atol 1e-6 x the gradient's max."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.ops import fused_attn as fa
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import pallas_topk as pt
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops import stream_feat as sf
from papr_tpu_torch.train.optim import tree_leaves, tree_map

H = W = 16
GROUPS = ("points", "attn", "points_influ_scores", "pc_feats", "renderer")


def _over(**tpu):
    base = {"force_local": True, "topk_impl": "cull",
            "fused_attn": "streamrec", "cull_candidates": 256}
    base.update(tpu)
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
        "tpu": base,
    }


@pytest.fixture(scope="module")
def scene():
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
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state),
                             load_config(overrides=_over()), device="cpu")
    return params, state, tp, ts, rayo, rayd, target


MODES = [({"fused_attn": True}, (fa.fused_scores_plain, fm.fused_mlp_plain)),
         ({"fused_attn": "embed"}, (fm.fused_mlp_plain,)),
         ({"fused_attn": "score"}, (fa.fused_scores_plain,)),
         ({"topk_impl": "pallas"}, (pt.topk_stream_plain,)),
         ({"topk_impl": "pallas", "fused_attn": True},
          (pt.topk_stream_plain, fa.fused_scores_plain)),
         ({"fused_attn": "stream"},
          (sf.key_stream_feat_plain, sf.value_stream_feat_plain,
           fm.fused_mlp_plain)),
         ({"query_fold": True}, (sa.key_stream_q_plain,
                                 sa.value_stream_plain))]
IDS = ["true", "embed", "score", "pallas", "pallas+true", "stream",
       "query_fold"]


@pytest.mark.parametrize("tpu,plains", MODES, ids=IDS)
def test_forward_and_gradients_match_jax(scene, tpu, plains):
    params, state, tp, ts, rayo, rayd, target = scene
    jcfg = jax_load(overrides=_over(**tpu))
    cfg = load_config(overrides=_over(**tpu))

    def jloss(p):
        out = jpapr.forward(p, state, jcfg, jnp.asarray(rayo),
                            jnp.asarray(rayd))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    before = [p.calls for p in plains]
    live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            if k in GROUPS else v for k, v in tp.items()}
    out = tpapr.forward(live, ts, cfg, torch.as_tensor(rayo),
                        torch.as_tensor(rayd))
    loss = ((out - torch.as_tensor(target)) ** 2).mean()
    flat = [x for k in GROUPS for x in tree_leaves(live[k])]
    grads = torch.autograd.grad(loss, flat)
    assert all(p.calls > b for p, b in zip(plains, before))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = [np.asarray(x) for k in GROUPS for x in jax.tree.leaves(jg[k])]
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=3e-4,
            atol=1e-6 * max(float(np.abs(w).max()), 1e-30))
    assert any(float(np.abs(w).max()) > 0 for w in want)


EVAL_MODES = MODES[:4] + [({"eval_fused": False},
                           (sa.key_stream_plain, sa.value_stream_plain))
                          ] + MODES[5:]


@pytest.mark.parametrize("tpu,plains", EVAL_MODES,
                         ids=IDS[:4] + ["two-kernel"] + IDS[5:])
def test_evaluate_matches_jax(scene, tpu, plains):
    params, state, tp, ts, rayo, rayd, _ = scene
    jcfg = jax_load(overrides=_over(**tpu))
    cfg = load_config(overrides=_over(**tpu))
    jf, ja, jsel = jpapr.evaluate(params, state, jcfg, jnp.asarray(rayo),
                                  jnp.asarray(rayd), with_selected=True)
    before = [p.calls for p in plains]
    with torch.no_grad():
        tf, ta, tsel = tpapr.evaluate(tp, ts, cfg, torch.as_tensor(rayo),
                                      torch.as_tensor(rayd),
                                      with_selected=True)
    assert all(p.calls > b for p, b in zip(plains, before))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=2e-5)
    assert np.ptp(ta.numpy()[..., -1, 0]) > 0.05      # not a trivial frame


def test_knobs_that_still_raise_name_their_roadmap_items(scene):
    """The mesh still raises with its roadmap item. The two int8 knobs, which
    used to, run: ``evaluate`` under ``int8_eval`` and ``forward`` under
    ``int8_train`` agree with the JAX package's int8 kernels (exact integer
    products on both sides: fused <= 2e-3 of its scale, attention and rgb
    atol 1e-3) and differ from the fp32 path."""
    params, state, tp, ts, rayo, rayd, _ = scene
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    jargs = (jnp.asarray(rayo), jnp.asarray(rayd))
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tpapr.evaluate(tp, ts, load_config(overrides=_over(
            mesh={"data": 2, "rays": 1})), *args)
    over = _over(int8_eval=True)
    calls = sa.attend_eval_plain.calls
    tf, ta = tpapr.evaluate(tp, ts, load_config(overrides=over), *args)
    assert sa.attend_eval_plain.calls == calls + 1
    jf, ja = jpapr.evaluate(params, state, jax_load(overrides=over), *jargs)
    jf, ja = np.asarray(jf), np.asarray(ja)
    assert np.abs(tf.numpy() - jf).max() <= 2e-3 * np.abs(jf).max()
    assert np.abs(ta.numpy() - ja).max() <= 1e-3
    fp = tpapr.evaluate(tp, ts, load_config(overrides=_over()), *args)
    assert not torch.equal(fp[1], ta)
    over = _over(int8_train=True)
    with torch.no_grad():
        out = tpapr.forward(tp, ts, load_config(overrides=over), *args)
    want = jpapr.forward(params, state, jax_load(overrides=over), *jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


def test_query_fold_outside_streamrec_warns_once_and_runs_unfolded(scene):
    """``tpu.query_fold: true`` under ``fused_attn: true``: one warning (keyed
    as in the JAX package), then the unfolded result, as in JAX
    (papr.py:598-604)."""
    import warnings
    params, state, tp, ts, rayo, rayd, _ = scene
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    tpapr._warned.clear()
    folded = load_config(overrides=_over(fused_attn=True, query_fold=True))
    calls = sa.key_stream_q_plain.calls
    with pytest.warns(UserWarning, match="tpu.query_fold: true ignored"):
        got = tpapr.evaluate(tp, ts, folded, *args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")                   # no second warning
        again = tpapr.evaluate(tp, ts, folded, *args)
        want = tpapr.evaluate(
            tp, ts, load_config(overrides=_over(fused_attn=True)), *args)
    assert sa.key_stream_q_plain.calls == calls
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    jcfg = jax_load(overrides=_over(fused_attn=True, query_fold=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf, ja = jpapr.evaluate(params, state, jcfg, jnp.asarray(rayo),
                                jnp.asarray(rayd))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jf), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ja), rtol=0,
                               atol=2e-5)
    # the plain path takes no kernel at all: nothing to fold, no warning
    tpapr._warned.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpapr.evaluate(tp, ts, load_config(overrides=_over(
            fused_attn=False, query_fold=True)), *args)


def test_topk_impl_approx_selects_what_xla_selects(scene):
    """``approx`` (approx_min_k, exact off the TPU) runs the exact
    selection: the same points as ``xla``, and as the JAX package."""
    params, state, tp, ts, rayo, rayd, _ = scene
    args = (torch.as_tensor(rayo), torch.as_tensor(rayd))
    out = {}
    for impl in ("approx", "xla"):
        cfg = load_config(overrides=_over(topk_impl=impl))
        assert tpapr.resolve_topk_impl(cfg, 320) == "xla"
        with torch.no_grad():
            out[impl] = tpapr.evaluate(tp, ts, cfg, *args,
                                       with_selected=True)
    for a, b in zip(out["approx"], out["xla"]):
        assert torch.equal(a, b)
    jsel = jpapr.evaluate(params, state,
                          jax_load(overrides=_over(topk_impl="approx")),
                          jnp.asarray(rayo), jnp.asarray(rayd),
                          with_selected=True)[2]
    np.testing.assert_array_equal(out["approx"][2].numpy(), np.asarray(jsel))


def test_unfusible_config_takes_the_plain_path(scene):
    """A score activation the kernels do not cover: ``fused_attn: true``
    falls back to the plain path, as in JAX (papr.py:414-416)."""
    _, _, tp, ts, rayo, rayd, _ = scene
    over = _over(fused_attn=True)
    over["models"]["attn"]["score_act"] = "gelu"
    calls = (fa.fused_scores_plain.calls, fm.fused_mlp_plain.calls)
    out = tpapr.evaluate(tp, ts, load_config(overrides=over),
                         torch.as_tensor(rayo), torch.as_tensor(rayd))
    assert torch.isfinite(out[0]).all()
    assert (fa.fused_scores_plain.calls, fm.fused_mlp_plain.calls) == calls
