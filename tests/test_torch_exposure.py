"""Exposure control on the port against ``papr_tpu``: the shading codes, the
mapping MLP, the FiLM UNet (one code and a batch of N), the candidate
scores and the resample.

A JAX ``create_model`` converted with ``from_jax_params``; JAX runs its
Pallas kernels in interpret mode (``tpu.force_local``, ``topk_impl: cull``,
``fused_attn: streamrec``), the port its kernels' plain versions on CPU
tensors. Tolerances: the codes bit-equal; mapping_apply rtol 1e-6; the
decoded rgb atol 1e-4 (rtol 1e-4, as ``test_torch_render.py``) under fp32
compute and atol 2^-8 under bf16 (both packages round the last
convolution's output to bf16, and a summation order can move it by one
unit in the last place: 2^-9 below 0.5, 2^-8 below 1); a batch of N codes
bit-equal to N single decodes under bf16, and to fp32 rounding under fp32
(atol 1e-6: the CPU's fp32 convolution picks its algorithm by batch size);
the candidate scores rtol 1e-5, and the same pick unless other JAX scores
lie within that tolerance of the best (then the port's pick is one of
them)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.dataset import get_dataset as jget_dataset
from papr_tpu.model import papr as jpapr
from papr_tpu.model.lpips_jax import random_lpips_params
from papr_tpu.nn.mlp import Policy as JPolicy
from papr_tpu.train import exposure as jexp
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_lpips_params, from_jax_params
from papr_tpu_torch.dataset import get_dataset
from papr_tpu_torch.dataset.synth import make_demo_scene
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.nn.mlp import Policy
from papr_tpu_torch.train import exposure as texp
from papr_tpu_torch.train.losses import get_loss

SCORE_RTOL = 1e-5
# Channels at the FiLM site: 0 = the UNet's input (the value features), 1 =
# the first conv's output.
C_SITE = {0: 8, 1: 128}
POLICIES = {"fp32": (JPolicy(jnp.float32), Policy(torch.float32)),
            "bf16": (JPolicy(jnp.bfloat16), Policy(torch.bfloat16))}
# (atol against JAX, atol of the batch against the single decodes)
DECODE_ATOL = {"fp32": (1e-4, 1e-6), "bf16": (2.0 ** -8, 0.0)}


def _over(affine=0, select_by="psnr", lpips=0.0, scene=None):
    over = {
        "use_amp": False, "max_num_pts": 320,
        "dataset": {"coord_scale": 1.0, "patches": {"height": 16,
                                                    "width": 16}},
        "geoms": {"points": {"select_k": 6, "init_num": 300,
                             "init_scale": [0.6, 0.6, 0.6]},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 32, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "query": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 8, "n_ff_layer": 3}}},
            "renderer": {"generator": {"small_unet": {
                "affine_layer": affine}}}},
        "exposure_control": {
            "use": True, "shading_code_dim": 8, "shading_code_scale": 1.0,
            "shading_code_num_samples": 5, "shading_code_resample_size": 16,
            "shading_code_resample_select_by": select_by,
            "mapping_mlp": {"num_layers": 3, "dim": 16,
                            "out_dim": 2 * C_SITE[affine]}},
        "training": {"losses": {"mse": 1.0, "lpips": lpips,
                                "lpips_alex": 0.0}},
        "eval": {"max_height": 16, "max_width": 16},
        "tpu": {"force_local": True, "topk_impl": "cull",
                "fused_attn": "streamrec", "cull_candidates": 256},
    }
    if scene:
        over["dataset"].update({"type": "synthetic", "path": scene})
    return over


def _models(**kw):
    jcfg = jax_load(overrides=_over(**kw))
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(
        np.random.default_rng(0).normal(size=(320, 1)).astype(np.float32))
    cfg = load_config(overrides=_over(**kw))
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state), cfg,
                             device="cpu")
    return jcfg, cfg, params, state, tp, ts


def _assert_same_pick(jscores, tscores, tol=SCORE_RTOL):
    """The scores within ``tol``, and the port's pick JAX's best or, where
    other JAX scores lie within ``tol`` of the best, one of those."""
    jscores, tscores = np.asarray(jscores), np.asarray(tscores)
    np.testing.assert_allclose(tscores, jscores, rtol=tol)
    best = jscores.min()
    tied = np.flatnonzero(jscores <= best + tol * abs(best)).tolist()
    assert int(np.argmin(tscores)) in tied


def test_init_shading_codes_bit_equal():
    jcfg = jax_load(overrides=_over())
    cfg = load_config(overrides=_over())
    want = jexp.init_shading_codes(np.random.default_rng(11), 7, jcfg)
    got = texp.init_shading_codes(np.random.default_rng(11), 7, cfg)
    assert got.dtype == np.float32 and got.shape == (7, 8)
    np.testing.assert_array_equal(got, want)


def test_mapping_apply_matches_jax():
    jcfg, cfg, params, _, tp, _ = _models(affine=1)
    codes = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)
    jg, jb = jpapr.mapping_apply(params, jcfg, jnp.asarray(codes))
    tg, tb = tpapr.mapping_apply(tp, cfg, torch.as_tensor(codes))
    assert tuple(tg.shape) == (5, 128) and tuple(tb.shape) == (5, 128)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    # One code, as a host array: the same rows (a matrix-vector product
    # against a matrix product: to rounding).
    g1, b1 = tpapr.mapping_apply(tp, cfg, codes[2])
    np.testing.assert_allclose(g1.numpy(), tg[2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(b1.numpy(), tb[2].numpy(), rtol=1e-6)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("affine", [0, 1])
def test_film_unet_matches_jax(affine, policy):
    jcfg, cfg, params, _, tp, _ = _models(affine=affine)
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(2)
    fused = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    codes = rng.standard_normal((3, 8)).astype(np.float32)
    x = torch.as_tensor(fused)
    tg, tb = tpapr.mapping_apply(tp, cfg, torch.as_tensor(codes), tpol)
    singles = []
    for i, code in enumerate(codes):
        jg, jb = jpapr.mapping_apply(params, jcfg, jnp.asarray(code), jpol)
        want = jpapr.render_foreground(params, jcfg, jnp.asarray(fused), jg,
                                       jb, jpol)
        got = tpapr.render_foreground(tp, cfg, x, tg[i], tb[i], tpol)
        atol = DECODE_ATOL[policy][0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4 if policy == "fp32" else 0,
                                   atol=atol)
        singles.append(got)
    # The N codes' (gamma, beta) rows as one batch of N against the single
    # decodes.
    batch = tpapr.render_foreground(tp, cfg, x.expand(3, *x.shape[1:]), tg,
                                    tb, tpol)
    torch.testing.assert_close(batch, torch.cat(singles), rtol=0,
                               atol=DECODE_ATOL[policy][1])


@pytest.fixture(scope="module")
def lpips_pair():
    lp = random_lpips_params(jax.random.PRNGKey(0))
    return lp, from_jax_lpips_params(jax.tree.map(np.asarray, lp),
                                     device="cpu")


@pytest.mark.parametrize("select_by", ["psnr", "loss"])
def test_candidate_scores_match_jax(select_by, lpips_pair):
    lp, lp_t = lpips_pair
    jcfg, cfg, params, _, tp, _ = _models(select_by=select_by, lpips=0.1)
    rng = np.random.default_rng(3)
    fused = rng.normal(size=(1, 16, 16, 8)).astype(np.float32)
    bkg_attn = rng.random((1, 16, 16, 1, 1)).astype(np.float32)
    img = rng.random((1, 16, 16, 3)).astype(np.float32)
    codes = rng.standard_normal((6, 8)).astype(np.float32)
    jfn = jexp._candidate_scores_fn(
        jcfg, loss_fn=jget_loss(jcfg.training.losses, lpips_params=lp))
    want = np.asarray(jfn(params, jnp.asarray(fused), jnp.asarray(bkg_attn),
                          jnp.asarray(img), jnp.asarray(codes)))
    tfn = texp._candidate_scores_fn(
        cfg, loss_fn=get_loss(cfg.training.losses, lpips_params=lp_t))
    got = tfn(tp, torch.as_tensor(fused), torch.as_tensor(bkg_attn), img,
              codes)
    assert got.shape == (6,)
    _assert_same_pick(want, got)
    if select_by == "psnr":
        # MSE ranks as PSNR does: the loss branch with its LPIPS term differs.
        other = texp._candidate_scores_fn(
            load_config(overrides=_over(select_by="loss", lpips=0.1)),
            loss_fn=get_loss(cfg.training.losses, lpips_params=lp_t))
        assert not np.allclose(other(tp, torch.as_tensor(fused),
                                     torch.as_tensor(bkg_attn), img, codes),
                               got)


def test_resample_picks_jax_code(tmp_path):
    """``resample_shading_codes`` on a tiny sphere scene: the same patch,
    the same candidates from the same seed, the same scores (rtol 1e-5) and
    the same code row written, for every image."""
    scene = make_demo_scene(str(tmp_path / "scene"), n_train=3, n_test=1,
                            H=24, W=24, exposure_jitter=0.3)
    jcfg, cfg, params, state, tp, ts = _models(scene=scene)
    jds = jget_dataset(jcfg.dataset, mode="train", seed=1)
    tds = get_dataset(cfg.dataset, mode="train", seed=1)
    jcodes = jexp.init_shading_codes(np.random.default_rng(4), len(jds), jcfg)
    tcodes = texp.init_shading_codes(np.random.default_rng(4), len(tds), cfg)
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    seen = {"jax": [], "port": []}

    def recording(fn, key):
        def score(*args):
            out = np.asarray(fn(*args))
            seen[key].append(out)
            return out
        return score

    jfn = recording(jexp._candidate_scores_fn(jcfg), "jax")
    tfn = recording(texp._candidate_scores_fn(cfg), "port")
    for i in range(len(jds)):
        jexp.resample_shading_codes(jcodes, jcfg, params, state, jds, i, 0,
                                    jrng, jfn)
        texp.resample_shading_codes(tcodes, cfg, tp, ts, tds, i, 0, trng, tfn)
        _assert_same_pick(seen["jax"][-1], seen["port"][-1])
    np.testing.assert_array_equal(tcodes, jcodes)
    assert len(seen["port"]) == 3 and seen["port"][0].shape == (5,)
