"""The fp32 form of the port's walk kernels (``use_amp: false``) on the CPU.

* The fp32 kernel layouts: ``pack_walk`` / ``pack_walk_t`` with fp32 compute
  hold the weights exactly (the bf16 packs hold their bf16 rounding), and the
  backward's stash is fp32.
* The attention path under fp32 (``model.papr._kernel_mode``, nothing
  launched): every mode resolves as under bf16, and each fp32 kernel it
  launches on the card has its entry point and launch counter.
* Caterpillar's model (``configs/t2/Caterpillar.yml`` merged onto
  ``configs/default.yml``: fp32, k = 20, ``k_L [4,4,4]``, ``q_L [4]``,
  ``v_L [4,4]``, background constant 4) cut to 300 points and 2 layers of
  width 64: one training step (MSE + 1e-2 LPIPS on JAX-drawn random VGG
  weights) and a 32x32 render through both packages. JAX runs
  ``fused_attn: streamrec`` with its Pallas kernels in interpret mode (its
  ``auto`` is the plain path off the TPU); the port runs ``auto``, its
  kernels' plain versions on CPU tensors. Tolerances as
  ``tests/test_torch_train_step.py`` / ``test_torch_render.py``: loss rtol
  1e-5, gradients rtol 3e-4 with atol 1e-6 x the gradient's max, frames
  atol 1e-4.
"""

import os

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
from papr_tpu.train import step as jstep
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_lpips_params, from_jax_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.nn.mlp import policy_from_config
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATERPILLAR = os.path.join(ROOT, "configs", "t2", "Caterpillar.yml")


# ------------------------------------------------------------- packing ----

def _odd_walk(rng):
    """A walk with widths that are not multiples of 16 (39 -> 50 -> 27)."""
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    cols = tuple((i % 3, 2.0 ** (i // 6), 1 + i % 2) for i in range(39))
    return fm.Walk((t(39, 50), t(50, 27)), (t(50), t(27)),
                   (t(39), t(39)), (t(27), t(27)), "relu", "none", cols)


def _unpack(buf, meta, pd, transposed):
    """The weights back from a packed buffer at meta's offsets."""
    n = meta[0]
    w_off = meta[7 + n + 1:7 + n + 1 + n]
    out = []
    for i in range(n):
        shape = (pd[i + 1], pd[i]) if transposed else (pd[i], pd[i + 1])
        out.append(buf[w_off[i]:w_off[i] + shape[0] * shape[1]].reshape(shape))
    return out


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["pack_walk", "pack_walk_t"])
def test_fp32_packs_hold_the_weights_exactly(transposed):
    walk = _odd_walk(np.random.default_rng(0))
    for cdt in (torch.float32, torch.bfloat16):
        meta, w_all, b_all, _, _, pd = fm.pack_walk(walk, 39, "cpu", cdt)
        buf = fm.pack_walk_t(walk, pd, "cpu", cdt) if transposed else w_all
        assert buf.dtype == cdt and pd == [48, 64, 32]
        for w, p in zip(walk.ws, _unpack(buf, meta, pd, transposed)):
            w = w.T if transposed else w
            want = w if cdt == torch.float32 else w.to(cdt)
            # exact, and the zero padding around it
            assert torch.equal(p[:w.shape[0], :w.shape[1]], want.to(cdt))
            pad = p.clone()
            pad[:w.shape[0], :w.shape[1]] = 0
            assert not bool(pad.any())
        assert b_all.dtype == torch.float32
    buf = fm.BwdBuffers(pd, 128, 2, "cpu", cdt=torch.float32)
    half = fm.BwdBuffers(pd, 128, 2, "cpu")
    assert buf.stash.dtype == torch.float32 and half.stash.dtype == torch.bfloat16
    assert buf.stash.numel() == half.stash.numel()
    assert buf.stash.element_size() == 2 * half.stash.element_size()


def test_relu_margin_is_the_distance_of_the_relu_inputs_from_zero():
    """``walk_relu_margin``: per row, min |z| / rms(z) over the relu layers'
    inputs (the last layer's activation is none here); the stream form takes
    the smallest over a ray's K tokens."""
    rng = np.random.default_rng(2)
    walk = _odd_walk(rng)
    enc = torch.as_tensor(rng.normal(size=(40, 39)).astype(np.float32))
    got = fm.walk_relu_margin(enc, walk)
    h = fm.ln_rows(enc, *walk.ln_in)
    z = h @ walk.ws[0] + walk.bs[0]
    want = (z.abs() / z.square().mean().sqrt()).amin(dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    rec = torch.as_tensor(rng.normal(size=(3, 5, 128)).astype(np.float32))
    rayo = torch.zeros(5, 3)
    rays = torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(5, 3)).astype(np.float32)), dim=-1)
    kw = fm.walk_from_params(
        {"mlp": {"layers": [{"w": w.T, "bias": b} for w, b in
                            zip(walk.ws, walk.bs)]}}, type("C", (), {
            "ff_act": "relu", "ff_last_act": "none"})(),
        sa.rec_pe_plan(True, (2, 2, 2), 1, 2.0, 1.0, 0)[:39])
    per_ray = sa.rec_relu_margin(rec, rayo, rays, kw)
    tokens = fm.walk_relu_margin(sa._rec_encoding(rec, rayo, rays, kw, 1e-6,
                                                  False), kw)
    torch.testing.assert_close(per_ray, tokens.reshape(3, 5).amin(dim=0))


# ---------------------------------------------------- modes on the card ----

def _cfg(amp=False, **tpu):
    return load_config(overrides={"use_amp": amp, "tpu": tpu})


# The fp32 entry points each mode launches on the card (training step and
# its eval path), every one a kernel of csrc/ with its plain twin.
FP32_KERNELS = {
    "auto": ("fused_mlp_f32", "attend_eval_f32", "key_stream_f32",
             "value_stream_f32", "wgrad_f32"),
    "streamrec": ("fused_mlp_f32", "attend_eval_f32", "key_stream_f32",
                  "value_stream_f32", "wgrad_f32"),
    "embed": ("fused_mlp_f32", "wgrad_f32"),
    "false": (),
    "stream": ("fused_mlp_f32", "key_stream_feat_f32", "value_stream_feat_f32",
               "wgrad_f32"),
    "true": ("fused_mlp_f32", "fused_scores_f32", "wgrad_f32"),
    "score": ("fused_scores_f32", "wgrad_f32"),
    "query_fold": ("key_stream_q_f32", "value_stream_f32", "wgrad_f32"),
}


@pytest.mark.parametrize("tpu,want", [
    ({}, ("streamrec", False)),
    ({"fused_attn": "streamrec"}, ("streamrec", False)),
    ({"fused_attn": "embed"}, ("embed", False)),
    ({"fused_attn": False}, (False, False)),
    ({"fused_attn": "stream"}, ("stream", False)),
    ({"fused_attn": True}, (True, False)),
    ({"fused_attn": "score"}, ("score", False)),
    ({"query_fold": True}, ("streamrec", True)),
], ids=["auto", "streamrec", "embed", "false", "stream", "true", "score",
        "query_fold"])
def test_kernel_mode_on_the_card_under_fp32(tpu, want, request):
    """fp32 on the card: every mode resolves as under bf16 and runs its own
    kernels' fp32 forms, each an entry point of the library with its
    launch counter; a training call with dropout takes the plain path."""
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_attn as fa
    from papr_tpu_torch.ops import stream_feat as sf

    cfg = _cfg(**tpu)
    assert tpapr._kernel_mode(cfg, 20) == want
    assert tpapr._kernel_mode(_cfg(amp=True, **tpu), 20) == want
    assert tpapr._kernel_mode(cfg, 20, dropout=True) == (False, False)
    mode = request.node.callspec.id
    for stem in FP32_KERNELS[mode]:
        wrappers = [getattr(m, n) for m in (fm, sa, sf, fa)
                    for n in (stem, stem + "_fwd", stem + "_bwd")
                    if hasattr(m, n)]
        assert wrappers and all(w.launches >= 0 for w in wrappers), stem
        assert any(n.startswith("papr_" + stem) for n in build.SIGNATURES)


def test_fp32_kernels_of_rows_7_to_10_raise_on_the_card():
    """Every walk kernel takes fp32 compute as it takes bf16 (the checks of
    rows 7-10 pass now); a compute dtype no kernel has still raises, and the
    int8 walks' fp32 epilogue has entry points of its own."""
    from papr_tpu_torch.kernels import build

    walk = _odd_walk(np.random.default_rng(1))
    for cdt in (torch.float32, torch.bfloat16):
        fm.check_walk_for_kernel(walk, cdt, "x")
    with pytest.raises(NotImplementedError, match="bf16 or fp32"):
        fm.check_walk_for_kernel(walk, torch.float16, "x")
    for name in ("papr_attend_eval_i8_f32", "papr_key_stream_i8_f32_fwd",
                 "papr_value_stream_i8_f32_fwd"):
        assert build.SIGNATURES[name] == build.SIGNATURES[
            name.replace("_f32", "")]
    assert not hasattr(sa, "_check_int8_cdt") and not hasattr(fm, "FP32_TODO")


# ------------------------------------------------- Caterpillar's model ----

def _cat_over(**tpu):
    """Caterpillar's overrides kept; cut: 300 points in 320 slots, 2 layers
    of width 64 in every embedder (value to 32), d_model 64, 16-d point
    features, MSE + 1e-2 LPIPS kept."""
    ff = {"d_ff": 64, "n_ff_layer": 2}
    return {"max_num_pts": 320,
            "geoms": {"points": {"init_num": 300}, "point_feats": {"dim": 16}},
            "models": {"attn": {"d_model": 64, "embed": {
                "key": {**ff, "d_ff_out": 64}, "query": {**ff, "d_ff_out": 64},
                "value": {**ff, "d_ff_out": 32}}}},
            "tpu": {"force_local": True, "topk_impl": "cull",
                    "cull_candidates": 256, **tpu}}


@pytest.fixture(scope="module")
def caterpillar():
    jcfg = jax_load(CATERPILLAR, overrides=_cat_over(fused_attn="streamrec"))
    tcfg = load_config(CATERPILLAR, overrides=_cat_over())
    assert not tcfg.use_amp and tcfg.geoms.points.select_k == 20
    assert tcfg.get_path("tpu.fused_attn", "auto") == "auto"
    assert float(tcfg.geoms.background.constant) == 4.0
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(np.random.default_rng(0).normal(
        size=(320, 1)).astype(np.float32))
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), tcfg,
                             device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [3.0, -2.0, 80.0]             # the 30-scaled cube in view
    return jcfg, tcfg, params, state, tp, ts, c2w


def test_caterpillar_model_step_matches_jax(caterpillar):
    jcfg, tcfg, params, state, tp, ts, c2w = caterpillar
    assert tpapr._kernel_mode(tcfg, 20)[0] == "streamrec"
    rayo, rayd = get_rays_np(16, 16, 40.0, 40.0, c2w[None])
    target = np.random.default_rng(1).random((1, 16, 16, 3)).astype(np.float32)
    lp = random_lpips_params(jax.random.PRNGKey(0))
    last = build_activation(jcfg.models.last_act)
    jloss = jget_loss(jcfg.training.losses, lpips_params=lp)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(last(jpapr.forward(p, state, jcfg, jnp.asarray(rayo),
                                           jnp.asarray(rayd))),
                        jnp.asarray(target))))(params)
    lp_t = from_jax_lpips_params(jax.tree.map(np.asarray, lp), device="cpu")
    calls = (sa.key_stream_plain.calls, sa.value_stream_plain.calls)
    tl, _, tg = tstep.loss_and_grads(
        tp, ts, tcfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(target), c2w,
        get_loss(tcfg.training.losses, lpips_params=lp_t),
        build_group_specs(tcfg), policy_from_config(tcfg))
    # auto took the record-native streams
    assert (sa.key_stream_plain.calls, sa.value_stream_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tg) == {"points", "attn", "points_influ_scores", "pc_feats",
                       "renderer"}
    for key in tg:
        for a, b in zip(tree_leaves(tg[key]),
                        jax.tree.leaves(jax.tree.map(np.asarray, jg[key]))):
            np.testing.assert_allclose(
                a.numpy(), b, rtol=3e-4,
                atol=1e-6 * max(float(np.abs(b).max()), 1e-30), err_msg=key)


def test_caterpillar_model_render_matches_jax(caterpillar):
    jcfg, tcfg, params, state, tp, ts, c2w = caterpillar
    rayo, rayd = get_rays_np(32, 32, 40.0, 40.0, c2w[None])
    want = jstep.render_full_image(params, state, jcfg, rayo, rayd, 32, 32,
                                   with_extras=True)
    calls = sa.attend_eval_plain.calls
    got = tstep.render_full_image(tp, ts, tcfg, rayo, rayd, 32, 32,
                                  with_extras=True)
    assert sa.attend_eval_plain.calls == calls + 1     # the one-shot path
    for name in ("rgb", "foreground", "bkg_attn", "fused", "attn"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got["selected"], want["selected"])
    # not trivial: the background weight and the colour vary over the frame
    assert np.ptp(got["bkg_attn"]) > 0.01 and np.ptp(got["rgb"]) > 0.05
