"""Every ``tpu.*`` attention mode under ``use_amp: false`` against the JAX
package, on the CPU.

* Caterpillar's model (``configs/t2/Caterpillar.yml`` on
  ``configs/default.yml``, cut as ``tests/test_torch_fp32_walk.py`` cuts it:
  300 points in 320 slots, 2 x 64 embedders) under ``fused_attn: stream``,
  ``true``, ``score``, ``streamrec`` + ``query_fold`` and under
  ``int8_eval`` / ``int8_train``: one training step (MSE + 1e-2 LPIPS on
  JAX-drawn random VGG weights) and one 32 x 32 render each. The port runs
  its kernels' plain versions (CPU tensors); the plain-version counters show
  which kernel's stand-in ran, and that no other did. JAX runs its Pallas
  kernels in interpret mode (``tpu.force_local``). In fp32 the JAX
  package's modes compute one function (its own tests hold them to each
  other), so one JAX ``streamrec`` step and frame are the reference of the
  four fp32 modes; the int8 modes have JAX runs of their own, as they
  compute another function. Tolerances: loss rtol 1e-5, gradients rtol 3e-4
  with atol 1e-6 x the gradient's max, frames atol 1e-4 (the bounds of
  ``test_torch_fp32_walk.py``); the int8 modes' flips of one quantized
  activation widen the atols to 5e-3 x the max and 2e-3 of the scale (the
  int8 tests' bounds), as stated at the comparisons.
* Per module, the port's plain fp32 versions (``cdt=float32``, the argument
  that picks the ``_f32`` kernel on the card) of ``fused_scores``, the
  feature streams, the query-folded key stream and the int8 walks beside
  fp32 against the JAX functions with ``compute="float32"`` in interpret
  mode, forward and backward, each tolerance stated at its comparison.
* The wrappers' launch path for each new fp32 entry point, driven on CPU
  tensors that read as CUDA tensors against a stand-in library that checks
  each call's argument count against ``kernels/build.py SIGNATURES``: the
  wrapper picks the fp32 kernel, counts its launch, and (int8 beside fp32)
  no longer refuses.
"""

import types

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
from papr_tpu.ops import stream_attn as jsa
from papr_tpu.ops.fused_attn import fused_scores as jax_fused_scores
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.train import step as jstep
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_lpips_params
from papr_tpu_torch.kernels import build
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.nn.mlp import policy_from_config
from papr_tpu_torch.ops import fused_attn as fa
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.ops import stream_feat as sf
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
from test_stream_attn import EPS
from test_torch_fp32_walk import CATERPILLAR, _cat_over, caterpillar  # noqa: F401
from test_torch_fused_attn import _inputs as _score_inputs
from test_torch_int8_eval import K_DESC, V_DESC, _toy
from test_torch_query_fold import _case as _qfold_case
from test_torch_stream_feat import GRAD, _key, _value, flat_walk_grads

F32 = torch.float32

# (port tpu.*, JAX tpu.*, JAX reference of the step, of the frame)
MODES = {
    "stream": ({"fused_attn": "stream"}, None, "fp32", "fp32"),
    "true": ({"fused_attn": True}, None, "fp32", "fp32"),
    "score": ({"fused_attn": "score"}, None, "fp32", "fp32"),
    "query_fold": ({"fused_attn": "streamrec", "query_fold": True}, None,
                   "fp32", "fp32"),
    "int8_eval": ({"int8_eval": True}, None, "fp32", "int8_eval"),
    "int8_train": ({"int8_train": True}, None, "int8_train", "fp32"),
}
# The JAX runs: streamrec (its auto is the plain path off the TPU).
JAX_TPU = {"fp32": {"fused_attn": "streamrec"},
           "int8_eval": {"fused_attn": "streamrec", "int8_eval": True},
           "int8_train": {"fused_attn": "streamrec", "int8_train": True}}

COUNTERS = {
    "fused_mlp": fm.fused_mlp_plain, "fused_mlp_bwd": fm.fused_mlp_bwd_plain,
    "scores": fa.fused_scores_plain, "scores_bwd": fa.fused_scores_bwd_plain,
    "attend_eval": sa.attend_eval_plain, "key": sa.key_stream_plain,
    "key_bwd": sa.key_stream_bwd_plain, "value": sa.value_stream_plain,
    "value_bwd": sa.value_stream_bwd_plain, "key_q": sa.key_stream_q_plain,
    "key_q_bwd": sa.key_stream_q_bwd_plain,
    "key_feat": sf.key_stream_feat_plain,
    "key_feat_bwd": sf.key_stream_feat_bwd_plain,
    "value_feat": sf.value_stream_feat_plain,
    "value_feat_bwd": sf.value_stream_feat_bwd_plain,
    "amax": sa.walk_amax,
}
_REC = {"fused_mlp": 1, "fused_mlp_bwd": 1, "key": 1, "key_bwd": 1,
        "value": 1, "value_bwd": 1}
# What one step / one frame of each mode runs (every other counter stays).
STEP_CALLS = {
    "stream": {"fused_mlp": 1, "fused_mlp_bwd": 1, "key_feat": 1,
               "key_feat_bwd": 1, "value_feat": 1, "value_feat_bwd": 1},
    "true": {"fused_mlp": 3, "fused_mlp_bwd": 3, "scores": 1,
             "scores_bwd": 1},
    "score": {"scores": 1, "scores_bwd": 1},
    "query_fold": {"key_q": 1, "key_q_bwd": 1, "value": 1, "value_bwd": 1},
    "int8_eval": _REC,
    "int8_train": {**_REC, "amax": 2},
}
FRAME_CALLS = {
    "stream": {"fused_mlp": 1, "key_feat": 1, "value_feat": 1},
    "true": {"fused_mlp": 3, "scores": 1},
    "score": {"scores": 1},
    "query_fold": {"key_q": 1, "value": 1},
    "int8_eval": {"fused_mlp": 1, "attend_eval": 1, "amax": 2},
    "int8_train": {"fused_mlp": 1, "attend_eval": 1},
}


def _counts():
    return {k: f.calls for k, f in COUNTERS.items()}


def _ran(before, want):
    after = _counts()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert got == want


class _Refs:
    """The JAX steps and frames, each computed once for the module."""

    def __init__(self, cat):
        self.cat, self.steps, self.frames = cat, {}, {}
        self.lp = random_lpips_params(jax.random.PRNGKey(0))
        c2w = cat[6]
        self.rays16 = get_rays_np(16, 16, 40.0, 40.0, c2w[None])
        self.rays32 = get_rays_np(32, 32, 40.0, 40.0, c2w[None])
        self.target = np.random.default_rng(1).random(
            (1, 16, 16, 3)).astype(np.float32)

    def jcfg(self, kind):
        return jax_load(CATERPILLAR, overrides=_cat_over(**JAX_TPU[kind]))

    def step(self, kind):
        if kind not in self.steps:
            params, state = self.cat[2], self.cat[3]
            jcfg = self.jcfg(kind)
            rayo, rayd = map(jnp.asarray, self.rays16)
            last = build_activation(jcfg.models.last_act)
            jloss = jget_loss(jcfg.training.losses, lpips_params=self.lp)
            self.steps[kind] = jax.jit(jax.value_and_grad(
                lambda p: jloss(last(jpapr.forward(p, state, jcfg, rayo,
                                                   rayd)),
                                jnp.asarray(self.target))))(params)
        return self.steps[kind]

    def frame(self, kind):
        if kind not in self.frames:
            self.frames[kind] = jstep.render_full_image(
                self.cat[2], self.cat[3], self.jcfg(kind), *self.rays32, 32,
                32, with_extras=True)
        return self.frames[kind]


@pytest.fixture(scope="module")
def refs(caterpillar):  # noqa: F811
    return _Refs(caterpillar)


@pytest.mark.parametrize("mode", list(MODES))
def test_step_of_each_mode_matches_jax(refs, mode):
    """One training step under fp32: loss and the gradient of every trained
    group against JAX; the mode's own plain versions ran, and only they."""
    _, _, _, _, tp, ts, c2w = refs.cat
    tpu, _, step_ref, _ = MODES[mode]
    tcfg = load_config(CATERPILLAR, overrides=_cat_over(**tpu))
    assert not tcfg.use_amp
    jl, jg = refs.step(step_ref)
    lp_t = from_jax_lpips_params(jax.tree.map(np.asarray, refs.lp),
                                 device="cpu")
    rayo, rayd = refs.rays16
    before = _counts()
    tl, _, tg = tstep.loss_and_grads(
        tp, ts, tcfg, torch.as_tensor(rayo), torch.as_tensor(rayd),
        torch.as_tensor(refs.target), c2w,
        get_loss(tcfg.training.losses, lpips_params=lp_t),
        build_group_specs(tcfg), policy_from_config(tcfg))
    _ran(before, STEP_CALLS[mode])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # int8_train: the two sides' fp32 calibrations differ in the last bits
    # (their walks sum in another order), so now and then one quantized
    # activation rounds the other way and moves the raw dots the backward
    # reads by 1/127 of one term (the flips of test_torch_int8_eval.py):
    # up to 1.4e-3 of a gradient's max here, held to 5e-3 of it.
    scale = 5e-3 if mode == "int8_train" else 1e-6
    for key in tg:
        for a, b in zip(tree_leaves(tg[key]),
                        jax.tree.leaves(jax.tree.map(np.asarray, jg[key]))):
            np.testing.assert_allclose(
                a.numpy(), b, rtol=3e-4,
                atol=scale * max(float(np.abs(b).max()), 1e-30), err_msg=key)


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_of_each_mode_matches_jax(refs, mode):
    """A 32 x 32 render under fp32 against JAX within 1e-4; the same
    selection; the mode's own plain versions ran, and only they."""
    _, _, _, _, tp, ts, _ = refs.cat
    tpu, _, _, frame_ref = MODES[mode]
    tcfg = load_config(CATERPILLAR, overrides=_cat_over(**tpu))
    want = refs.frame(frame_ref)
    before = _counts()
    got = tstep.render_full_image(tp, ts, tcfg, *refs.rays32, 32, 32,
                                  with_extras=True)
    _ran(before, FRAME_CALLS[mode])
    for name in ("rgb", "foreground", "bkg_attn", "fused", "attn"):
        # int8_eval: the quantization flips of the step above (up to 2.6e-4
        # of a pixel, 2e-4 of the fused features' scale here), held to
        # test_torch_int8_eval.py's bounds, 2e-3 of the scale.
        tol = (2e-3 * max(1.0, float(np.abs(want[name]).max()))
               if mode == "int8_eval" else 1e-4)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(got["selected"], want["selected"])
    assert np.ptp(got["bkg_attn"]) > 0.01 and np.ptp(got["rgb"]) > 0.05


# ------------------------------------------------------------ per module ----

def test_fp32_fused_scores_matches_jax():
    """``fused_scores`` with fp32 compute: attn atol 1e-5, every gradient
    1e-4 of its max (``test_torch_fused_attn.py``'s fp32 bounds)."""
    T, K = 72, 6
    args = _score_inputs(3, T, K)
    cot = np.random.default_rng(4).normal(size=(T, K + 1)).astype(np.float32)

    def jfn(ek, eq, wk, bk, wq, bq, influ):
        return jax_fused_scores(ek, eq, wk, bk, wq, bq, influ,
                                jnp.asarray(args[7]), score_act="relu",
                                bkg_score=5.0, tile=32, interpret=True,
                                compute="float32")

    jin = tuple(map(jnp.asarray, args[:7]))
    want = np.asarray(jfn(*jin))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                  argnums=tuple(range(7)))(*jin)
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in args[:7]]
    before = _counts()
    out = fa.fused_scores(*leaves, torch.as_tensor(args[7]), "relu", 5.0,
                          compute=F32)
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), leaves)
    _ran(before, {"scores": 1, "scores_bwd": 1})
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-5)
    for g, w in zip(got, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_fp32_feature_streams_match_jax():
    """``key_stream_feat_*`` / ``value_stream_feat_*`` with fp32 compute:
    forward rtol 1e-5 / atol 1e-6, gradients rtol 3e-4 / atol 1e-6
    (``test_torch_stream_feat.py``'s bounds)."""
    T, K = 40, 3
    jfn, jargs, targs = _key(11, T, K, "layernorm", 4, dead_ray=3)
    attn, vjp = jax.vjp(jfn, *jargs)
    dattn = np.random.default_rng(12).normal(size=(T, K + 1)).astype(
        np.float32)
    dxk, dqq, dwalk, dwk, dbk, dinflu = vjp(jnp.asarray(dattn))
    got_attn, raw = sf.key_stream_feat_fwd(*targs, "relu", 5.0, F32)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), rtol=1e-5,
                               atol=1e-6)
    got = sf.key_stream_feat_bwd(*targs, raw, torch.as_tensor(dattn), "relu",
                                 5.0, F32)
    want = [dxk, dqq, dinflu, dwk, dbk] + flat_walk_grads(*dwalk)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"key {i}")

    _, vfn, vjargs, vtargs = _value(13, T, K, "layernorm", 4, dead_ray=2)
    fused, vvjp = jax.vjp(lambda x, a, w: vfn(x, a, w, True), *vjargs)
    dfused = np.random.default_rng(14).normal(size=fused.shape).astype(
        np.float32)
    dxv, dva, dvw = vvjp(jnp.asarray(dfused))
    xv, va, vwalk = vtargs
    np.testing.assert_allclose(
        sf.value_stream_feat_fwd(xv, va, vwalk, True, F32).numpy(),
        np.asarray(fused), rtol=1e-5, atol=1e-6)
    got = sf.value_stream_feat_bwd(xv, va, vwalk, torch.as_tensor(dfused),
                                   True, F32)
    want = [dxv, dva] + flat_walk_grads(*dvw)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"value {i}")


def test_fp32_query_folded_key_stream_matches_jax():
    """``key_stream_q_*`` with fp32 compute: attn and qq rtol 1e-5 / atol
    1e-6, every gradient rtol 3e-4 / atol 1e-6 (``test_torch_query_fold.py``'s
    bounds)."""
    T, K = 40, 3
    jfn, jargs, targs = _qfold_case(31, T, K, "layernorm", 4)
    attn, vjp = jax.vjp(jfn, *jargs)
    dattn = np.random.default_rng(32).normal(size=(T, K + 1)).astype(
        np.float32)
    drec, drayo, drays, drayd, dkw, dwk, dbk, dqw, dwq, dbq = vjp(
        jnp.asarray(dattn))
    got_attn, raw, ss, qq = sa.key_stream_q_fwd(*targs, "relu", 5.0, EPS, F32)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), rtol=1e-5,
                               atol=1e-6)
    got = sa.key_stream_q_bwd(*targs, qq, raw, ss, torch.as_tensor(dattn),
                              "relu", 5.0, EPS, F32)
    want = ([drec, drayo, drays, drayd, dwk, dbk, dwq, dbq]
            + flat_walk_grads(*dkw) + flat_walk_grads(*dqw))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=str(i))


def test_fp32_int8_walks_match_jax():
    """The three int8 forwards beside fp32 compute (self-calibrated on both
    sides; the ``w_k`` product and the value rows fp32): attend fused <= 2e-3
    of its scale and attn <= 1e-3, the streams' attn <= 1e-3 and fused <=
    2e-3 of scale (``test_torch_int8_eval.py``'s bounds: exact integer
    products, fp32 stages around them, the rare flip of one quantized
    activation). Not the fp32 walks' result: int8 moved it."""
    jargs, opts, targs = _toy(lns=True)
    fj, aj = jsa.attend_stream_eval(*jargs, **opts, int8=True)
    ft, at = sa.attend_stream_eval(*targs, "relu", 5.0, True, 1e-6, F32, True)
    fj, aj = np.asarray(fj), np.asarray(aj)
    assert np.abs(ft.numpy() - fj).max() <= 2e-3 * np.abs(fj).max()
    assert np.abs(at.numpy() - aj).max() <= 1e-3
    f32 = sa.attend_stream_eval(*targs, "relu", 5.0, True, 1e-6, F32)[0]
    assert float((ft - f32).abs().max()) > 1e-4 * float(f32.abs().max())

    rec, rayo, rays, qq, kws, kbs, kli, klo, wk, bk = jargs[:10]
    trec, trayo, trays, tqq, kwalk, twk, tbk, vwalk = targs
    attn_j = np.asarray(jsa.key_stream_scores_rec(
        rec, rayo, rays, qq, tuple(kws), tuple(kbs), kli, klo, wk, bk, K_DESC,
        "relu", "none", "relu", 5.0, 1e-6, opts["tile"], True, "float32",
        None, 0, True))
    attn_t = sa.key_stream_fwd(trec, trayo, trays, tqq, kwalk, twk, tbk,
                               "relu", 5.0, 1e-6, F32, True)[0]
    assert np.abs(attn_t.numpy() - attn_j).max() <= 1e-3
    vws, vbs, vli, vlo = jargs[10:14]
    fused_j = np.asarray(jsa.value_stream_fuse_rec(
        rec, rayo, rays, jnp.asarray(attn_j), tuple(vws), tuple(vbs), vli,
        vlo, V_DESC, "relu", "none", True, 1e-6, opts["tile"], True,
        "float32", None, 0, True))
    fused_t = sa.value_stream_fwd(trec, trayo, trays, torch.tensor(attn_j),
                                  vwalk, True, 1e-6, F32, True)
    assert np.abs(fused_t.numpy() - fused_j).max() <= \
        2e-3 * np.abs(fused_j).max()


# ---------------------------------------------------- the launch path ----

class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA tensor: a wrapper takes its kernel
    branch with it (nothing runs on a card)."""

    @property
    def is_cuda(self):
        return True


def _card(x):
    return x.as_subclass(_OnCard) if isinstance(x, torch.Tensor) else x


def _card_walk(walk):
    return fm.walk_with(walk, [_card(t) for t in fm.walk_tensors(walk)])


class _Lib:
    """Stands in for the kernel library: each call is recorded and its
    argument count checked against ``build.SIGNATURES``."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        sig = build.SIGNATURES[name]

        def launch(*args):
            assert len(args) == len(sig), (name, len(args), len(sig))
            self.calls.append(name)
            return 0
        return launch


def _launch_rec_int8(which):
    _, _, targs = _toy(lns=True)
    rec, rayo, rays, qq, kwalk, wk, bk, vwalk = map(_card, targs)
    kwalk, vwalk = _card_walk(kwalk), _card_walk(vwalk)
    if which == "attend":
        K, T, rp = rec.shape
        idx = _card(torch.arange(K * T, dtype=torch.int32).reshape(K, T).T)
        sa.attend_eval_idx(rec.reshape(K * T, rp), idx, rayo, rays, qq,
                           kwalk, wk, bk, vwalk, cdt=F32, int8=True)
    elif which == "key":
        sa.key_stream_fwd(rec, rayo, rays, qq, kwalk, wk, bk, cdt=F32,
                          int8=True)
    else:
        K, T = rec.shape[:2]
        attn = _card(torch.full((T, K + 1), 1.0 / (K + 1)))
        sa.value_stream_fwd(rec, rayo, rays, attn, vwalk, cdt=F32, int8=True)


def _launch_qfold(direction):
    _, _, targs = _qfold_case(41, 70, 4, "layernorm", 4)
    rec, rayo, rays, rayd, kwalk, wk, bk, qwalk, wq, bq = map(_card, targs)
    kwalk, qwalk = _card_walk(kwalk), _card_walk(qwalk)
    args = (rec, rayo, rays, rayd, kwalk, wk, bk, qwalk, wq, bq)
    attn, raw, ss, qq = sa.key_stream_q_fwd(*args, cdt=F32)
    if direction == "bwd":
        sa.key_stream_q_bwd(*args, qq, raw, ss, _card(attn), cdt=F32)


def _launch_key_feat(direction):
    _, _, targs = _key(42, 70, 4, "layernorm", 4)
    xk, qq, walk, wk, bk, influ, alive = map(_card, targs)
    args = (xk, qq, _card_walk(walk), wk, bk, influ, alive)
    attn, raw = sf.key_stream_feat_fwd(*args, cdt=F32)
    if direction == "bwd":
        sf.key_stream_feat_bwd(*args, raw, _card(attn), cdt=F32)


def _launch_value_feat(direction):
    _, _, _, targs = _value(43, 70, 4, "layernorm", 4)
    xv, attn, walk = map(_card, targs)
    fused = sf.value_stream_feat_fwd(xv, attn, _card_walk(walk), cdt=F32)
    if direction == "bwd":
        sf.value_stream_feat_bwd(xv, attn, _card_walk(walk), _card(fused),
                                 cdt=F32)


def _launch_scores(direction):
    args = [_card(torch.as_tensor(a)) for a in _score_inputs(44, 70, 5)]
    attn = fa.fused_scores_fwd(*args, cdt=F32)
    if direction == "bwd":
        fa.fused_scores_bwd(*args, _card(attn), cdt=F32)


# (entry point, its wrapper's module and name, how to reach it, the other
# entry points the call makes on the way)
LAUNCHES = [
    ("papr_attend_eval_i8_f32", sa, "attend_eval_i8_f32",
     lambda: _launch_rec_int8("attend"), ()),
    ("papr_key_stream_i8_f32_fwd", sa, "key_stream_i8_f32_fwd",
     lambda: _launch_rec_int8("key"), ()),
    ("papr_value_stream_i8_f32_fwd", sa, "value_stream_i8_f32_fwd",
     lambda: _launch_rec_int8("value"), ()),
    ("papr_key_stream_q_f32_fwd", sa, "key_stream_q_f32_fwd",
     lambda: _launch_qfold("fwd"), ()),
    ("papr_key_stream_q_f32_bwd", sa, "key_stream_q_f32_bwd",
     lambda: _launch_qfold("bwd"), ("papr_key_stream_q_f32_fwd",
                                    "papr_key_stream_f32_bwd")),
    ("papr_key_stream_feat_f32_fwd", sf, "key_stream_feat_f32_fwd",
     lambda: _launch_key_feat("fwd"), ()),
    ("papr_key_stream_feat_f32_bwd", sf, "key_stream_feat_f32_bwd",
     lambda: _launch_key_feat("bwd"), ("papr_key_stream_feat_f32_fwd",)),
    ("papr_value_stream_feat_f32_fwd", sf, "value_stream_feat_f32_fwd",
     lambda: _launch_value_feat("fwd"), ()),
    ("papr_value_stream_feat_f32_bwd", sf, "value_stream_feat_f32_bwd",
     lambda: _launch_value_feat("bwd"), ("papr_value_stream_feat_f32_fwd",)),
    ("papr_fused_scores_f32_fwd", fa, "fused_scores_f32_fwd",
     lambda: _launch_scores("fwd"), ()),
    ("papr_fused_scores_f32_bwd", fa, "fused_scores_f32_bwd",
     lambda: _launch_scores("bwd"), ("papr_fused_scores_f32_fwd",)),
]


@pytest.mark.parametrize("entry,module,counter,run,first", LAUNCHES,
                         ids=[c[0][5:] for c in LAUNCHES])
def test_fp32_entry_point_is_launched_by_its_wrapper(monkeypatch, entry,
                                                     module, counter, run,
                                                     first):
    """With fp32 compute (and int8 beside it) each wrapper launches its own
    fp32 entry point with the argument count of its signature, counts it,
    and launches no bf16 twin; a backward's weight gradients go through
    ``wgrad_f32``. Before the fp32 forms existed these wrappers raised
    (rows 7-10: no fp32 form; the int8 ones: "the int8 walks run beside bf16
    compute")."""
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    n = getattr(getattr(module, counter, None), "launches", 0)
    run()
    assert getattr(module, counter).launches == n + 1
    kernels = [c for c in lib.calls if c not in ("papr_colsum",
                                                 "papr_wgrad_f32")]
    assert kernels == [*first, entry]
    assert ("papr_wgrad_f32" in lib.calls) == entry.endswith("_bwd")
    assert "papr_wgrad" not in lib.calls
