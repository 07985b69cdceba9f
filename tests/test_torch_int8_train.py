"""``tpu.int8_train`` and the two int8 knobs' behaviour in the port against
the JAX package: the int8 forwards of the record-native key / value streams
with their unchanged (straight-through) backwards, the training step under
``int8_train``, and every row of the knobs' behaviour table: int8 where JAX
runs int8, one warning and the bit-equal bf16 / fp32 result where JAX warns,
silence and the bit-equal result where JAX is silent.

Inputs from numpy seeds; fp32 compute on both sides; JAX Pallas kernels in
interpret mode, the port's plain versions on CPU tensors. Forward tolerances
as in ``test_torch_int8_eval.py`` (attn max abs <= 1e-3, fused <= 2e-3 of
scale: exact integer products, fp32 stages around them, rare rounding flips
of one quantized activation); gradients rtol 3e-4, atol 1e-6 x the
gradient's max, the bound of ``test_torch_stream_train.py``."""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.ops import stream_attn as jsa
from papr_tpu.ops.geometry import get_rays_np
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.train.optim import tree_leaves, tree_map
from test_torch_int8_eval import K_DESC, V_DESC, _over, _toy

T_ = torch.as_tensor
GROUPS = ("points", "attn", "points_influ_scores", "pc_feats", "renderer")


def _close_grads(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (what, i)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=3e-4,
            atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {i}")


@pytest.mark.parametrize("lns", [False, True], ids=["no-ln", "ln"])
def test_int8_key_stream_matches_jax(lns):
    """``key_stream_scores_rec(int8=True)``: attn against the JAX int8
    kernel, then the gradients of the JAX tests' loss (record, qq, every
    walk tensor, w_k) against ``jax.grad`` of the int8 JAX function: its
    backward recomputes the walk in fp32 and reads the raw dots and scores
    the int8 forward saved, and so does the port's."""
    jargs, opts, targs = _toy(lns=lns)
    rec, rayo, rays, qq, kws, kbs, kli, klo, wk, bk = jargs[:10]

    def jfn(rec, qq, ws, bs, lns_, wk, bk):
        return jsa.key_stream_scores_rec(
            rec, rayo, rays, qq, ws, bs, lns_[0], lns_[1], wk, bk, K_DESC,
            "relu", "none", "relu", 5.0, 1e-6, opts["tile"], True, None, None,
            0, True)

    loss = lambda attn: jnp.sum(attn[:, :-1] ** 2)
    jin = (rec, qq, tuple(kws), tuple(kbs), (kli, klo), wk, bk)
    want_attn = jfn(*jin)
    jg = jax.grad(lambda *a: loss(jfn(*a)), argnums=tuple(range(7)))(*jin)

    trec, trayo, trays, tqq, kwalk, twk, tbk, _ = targs
    leaves = [t.clone().requires_grad_() for t in (trec, tqq)]
    tw = [t.clone().requires_grad_() for t in sa.walk_tensors(kwalk)]
    wkb = [t.clone().requires_grad_() for t in (twk, tbk)]
    calls = (sa.key_stream_plain.calls, sa.walk_amax.calls)
    attn = sa.key_stream_scores_rec(leaves[0], trayo, trays, leaves[1],
                                    sa.walk_with(kwalk, tw), *wkb, "relu",
                                    5.0, 1e-6, torch.float32, True)
    assert sa.key_stream_plain.calls == calls[0] + 1
    assert sa.walk_amax.calls == calls[1] + 1            # calibrated per call
    assert np.abs(attn.detach().numpy() - np.asarray(want_attn)).max() <= 1e-3
    (attn[:, :-1] ** 2).sum().backward()
    n = len(kws)
    want = ([jg[0], jg[1]] + list(jg[2]) + list(jg[3])
            + [t for ln in jg[4] if ln is not None for t in ln]
            + [jg[5], jg[6]])
    assert len(tw) == 2 * n + (4 if lns else 0)
    _close_grads([l.grad for l in leaves + tw + wkb], want, "key")
    # the forward really was int8: the fp32 forward differs
    fp = sa.key_stream_scores_rec(trec, trayo, trays, tqq, kwalk, twk, tbk)
    assert float((fp - attn.detach()).abs().max()) > 1e-6


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "plain"])
def test_int8_value_stream_matches_jax(renorm):
    """``value_stream_fuse_rec(int8=True)``: fused against the JAX int8
    kernel (<= 2e-3 of scale), gradients (record, attn, every walk tensor)
    against ``jax.grad`` of the int8 JAX function (a pure straight-through:
    the fp32 backward)."""
    jargs, opts, targs = _toy(lns=renorm)
    rec, rayo, rays = jargs[:3]
    vws, vbs, vli, vlo = jargs[10:14]
    K, T, _ = rec.shape
    rng = np.random.default_rng(7)
    attn = jax.nn.softmax(jnp.asarray(
        rng.normal(size=(T, K + 1)).astype(np.float32)), axis=-1)

    def jfn(rec, attn, ws, bs, lns_):
        return jsa.value_stream_fuse_rec(
            rec, rayo, rays, attn, ws, bs, lns_[0], lns_[1], V_DESC, "relu",
            "none", renorm, 1e-6, opts["tile"], True, None, None, 0, True)

    jin = (rec, attn, tuple(vws), tuple(vbs), (vli, vlo))
    want_f = np.asarray(jfn(*jin))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                  argnums=tuple(range(5)))(*jin)

    trec, trayo, trays, _, _, _, _, vwalk = targs
    leaves = [trec.clone().requires_grad_(),
              T_(np.asarray(attn)).clone().requires_grad_()]
    tw = [t.clone().requires_grad_() for t in sa.walk_tensors(vwalk)]
    calls = (sa.value_stream_plain.calls, sa.walk_amax.calls)
    fused = sa.value_stream_fuse_rec(leaves[0], trayo, trays, leaves[1],
                                     sa.walk_with(vwalk, tw), renorm, 1e-6,
                                     torch.float32, True)
    assert sa.value_stream_plain.calls == calls[0] + 1
    assert sa.walk_amax.calls == calls[1] + 1
    err = np.abs(fused.detach().numpy() - want_f).max()
    assert err <= 2e-3 * np.abs(want_f).max(), err
    (fused ** 2).sum().backward()
    want = ([jg[0], jg[1]] + list(jg[2]) + list(jg[3])
            + [t for ln in jg[4] if ln is not None for t in ln])
    _close_grads([l.grad for l in leaves + tw], want, "value")


def test_key_stream_backward_reads_the_saved_dots():
    """The CPU backward given the forward's saved raw dots: with the fp32
    forward's own dots nothing changes (bit-equal); with other dots the
    score and softmax backward move with them."""
    _, _, targs = _toy()
    kargs = targs[:7]
    _, raw, _ = sa.key_stream_plain(*kargs)
    dattn = T_(np.random.default_rng(0).normal(size=(64, 5))
               .astype(np.float32))
    base = sa.key_stream_bwd_plain(*kargs, dattn)
    same = sa.key_stream_bwd(*kargs, raw, None, dattn)
    for a, b in zip(base, same):
        assert torch.equal(a, b)
    moved = sa.key_stream_bwd(*kargs, raw * 1.05, None, dattn)
    assert not torch.equal(moved[3], base[3])


# ------------------------------------------------------ behaviour table ----

H = W = 12


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
    rayo, rayd = get_rays_np(H, W, 15.0, 15.0, c2w[None])
    target = rng.random((1, H, W, 3)).astype(np.float32)
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state),
                             load_config(overrides=_over()), device="cpu")
    return params, state, tp, ts, rayo, rayd, target


def _port_call(tp, ts, tpu, rayo, rayd, training):
    cfg = load_config(overrides=_over(**tpu))
    fn = tpapr.forward if training else tpapr.evaluate
    with torch.no_grad():
        out = fn(tp, ts, cfg, T_(rayo), T_(rayd))
    return out if training else torch.cat([out[0].flatten(),
                                           out[1].flatten()])


def _jax_call(params, state, tpu, rayo, rayd, training):
    cfg = jax_load(overrides=_over(**tpu))
    if training:
        return np.asarray(jpapr.forward(params, state, cfg, jnp.asarray(rayo),
                                        jnp.asarray(rayd)))
    f, a = jpapr.evaluate(params, state, cfg, jnp.asarray(rayo),
                          jnp.asarray(rayd))
    return np.concatenate([np.asarray(f).ravel(), np.asarray(a).ravel()])


# (knob, the rest of tpu.*, training call?, what the JAX package does)
TABLE = [
    ("int8_eval", {"eval_fused": False}, False, "warns"),
    ("int8_eval", {"query_fold": True}, False, "warns"),
    ("int8_eval", {"fused_attn": "stream"}, False, "warns"),
    ("int8_eval", {}, True, "silent"),
    ("int8_eval", {"fused_attn": "stream"}, True, "silent"),
    ("int8_eval", {"query_fold": True}, True, "silent"),
    ("int8_train", {"query_fold": True}, True, "warns"),
    ("int8_train", {"fused_attn": "stream"}, True, "warns"),
    ("int8_train", {}, False, "silent"),
    ("int8_train", {"eval_fused": False}, False, "silent"),
    ("int8_train", {"fused_attn": "stream"}, False, "silent"),
    ("int8_eval", {"fused_attn": True}, False, "silent"),
    ("int8_eval", {"fused_attn": "embed"}, True, "silent"),
    ("int8_eval", {"fused_attn": "score"}, False, "silent"),
    ("int8_eval", {"fused_attn": False}, False, "silent"),
    ("int8_train", {"fused_attn": True}, True, "silent"),
    ("int8_train", {"fused_attn": "score"}, True, "silent"),
    ("int8_train", {"fused_attn": False}, True, "silent"),
]


def _id(case):
    knob, rest, training, does = case
    mode = ",".join(f"{k}={v}" for k, v in rest.items()) or "streamrec"
    return f"{knob}-{mode}-{'train' if training else 'eval'}-{does}"


@pytest.mark.parametrize("case", TABLE, ids=_id)
def test_ignored_knob_is_bit_equal_and_warns_as_jax(scene, case):
    """Where the knob cannot take effect the port does what the JAX package
    does: the result is bit-equal to the same config without the knob; where
    JAX warns, one warning naming the knob on the first call and none on the
    second; where JAX is silent, no warning at all. The JAX package is run
    on the same config to show it does the same."""
    params, state, tp, ts, rayo, rayd, _ = scene
    knob, rest, training, does = case
    want = _port_call(tp, ts, rest, rayo, rayd, training)
    tpapr._warned.clear()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = _port_call(tp, ts, {**rest, knob: True}, rayo, rayd, training)
        again = _port_call(tp, ts, {**rest, knob: True}, rayo, rayd, training)
    assert torch.equal(got, want) and torch.equal(again, want)
    named = [w for w in seen if f"tpu.{knob}: true ignored" in str(w.message)]
    other = [w for w in seen if "int8" in str(w.message) and w not in named]
    assert len(named) == (1 if does == "warns" else 0) and not other
    # the JAX package on the same pair of configs
    jpapr._warned_multi.clear()
    jwant = _jax_call(params, state, rest, rayo, rayd, training)
    with warnings.catch_warnings(record=True) as jseen:
        warnings.simplefilter("always")
        jgot = _jax_call(params, state, {**rest, knob: True}, rayo, rayd,
                         training)
    np.testing.assert_array_equal(jgot, jwant)
    jnamed = [w for w in jseen
              if f"tpu.{knob}: true ignored" in str(w.message)]
    assert bool(jnamed) == (does == "warns")
    np.testing.assert_allclose(got.numpy().ravel(), jgot.ravel(), rtol=0,
                               atol=3e-5)


def test_int8_eval_runs_the_int8_kernel_at_eval_only(scene):
    """``int8_eval`` under ``streamrec`` + ``eval_fused``: the eval call
    takes the int8 one-shot attention (no warning) and agrees with JAX's
    (fused <= 2e-3 of scale, attn <= 1e-3); the training forward on the same
    config is bit-equal to the one without the knob."""
    params, state, tp, ts, rayo, rayd, _ = scene
    tpapr._warned.clear()
    n = sa.walk_amax.calls
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _port_call(tp, ts, {"int8_eval": True}, rayo, rayd, False)
    assert sa.walk_amax.calls == n + 2
    fp = _port_call(tp, ts, {}, rayo, rayd, False)
    assert not torch.equal(got, fp)
    jgot = _jax_call(params, state, {"int8_eval": True}, rayo, rayd, False)
    nf = H * W * 8
    f_err = np.abs(got.numpy()[:nf] - jgot[:nf]).max() / np.abs(jgot[:nf]).max()
    a_err = np.abs(got.numpy()[nf:] - jgot[nf:]).max()
    assert f_err <= 2e-3 and a_err <= 1e-3, (f_err, a_err)


@pytest.mark.parametrize("both", [False, True], ids=["int8_train", "both"])
def test_int8_train_step_matches_jax(scene, both):
    """The training forward and the gradient of every trained group under
    ``int8_train`` (alone, and with ``int8_eval`` beside it, which training
    never reads) against the JAX package: loss rtol 1e-5 + the int8 flips'
    1e-4; gradients to ``test_torch_train_step.py``'s bound, points
    included. Both int8 forwards ran, and calibrated once each."""
    params, state, tp, ts, rayo, rayd, target = scene
    tpu = {"int8_train": True, **({"int8_eval": True} if both else {})}
    jcfg = jax_load(overrides=_over(**tpu))
    cfg = load_config(overrides=_over(**tpu))

    def jloss(p):
        out = jpapr.forward(p, state, jcfg, jnp.asarray(rayo),
                            jnp.asarray(rayd))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
            if k in GROUPS else v for k, v in tp.items()}
    before = (sa.key_stream_plain.calls, sa.value_stream_plain.calls,
              sa.walk_amax.calls)
    tpapr._warned.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tpapr.forward(live, ts, cfg, T_(rayo), T_(rayd))
    loss = ((out - T_(target)) ** 2).mean()
    flat = [x for k in GROUPS for x in tree_leaves(live[k])]
    grads = torch.autograd.grad(loss, flat)
    assert (sa.key_stream_plain.calls, sa.value_stream_plain.calls,
            sa.walk_amax.calls) == (before[0] + 1, before[1] + 1,
                                    before[2] + 2)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    want = [np.asarray(x) for k in GROUPS for x in jax.tree.leaves(jg[k])]
    _close_grads(list(grads), want, "step")
    assert any(float(np.abs(w).max()) > 0 for w in want)
    # not the fp32 step
    fp = tpapr.forward(tp, ts, load_config(overrides=_over()), T_(rayo),
                       T_(rayd))
    assert float((fp - out.detach()).abs().max()) > 1e-7
