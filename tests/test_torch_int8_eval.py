"""``tpu.int8_eval`` in the port against the JAX package: the calibration
(``walk_amax``, ``quantize_walk``), the plain int8 walk (``walk_plain_q``),
the int8 one-shot eval attention self-calibrated and on a quantization
carried across, the frame-level calibration (``eval_quant_params``) and the
tiled int8 frame.

Inputs come from numpy seeds (the toy of ``tests/test_int8_eval.py``: K = 4,
T = 64, width 32, 3 layers). fp32 compute on both sides; the JAX Pallas
kernels run in interpret mode, the port runs its plain versions (CPU
tensors). Tolerances are stated at each comparison: the integer products are
exact on both sides, so they are those of the fp32 stages around them, plus
the rare rounding flip of one quantized activation (an fp32 value within an
ulp of k + 1/2), which moves one term of one sum by 1/127 of its scale."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.ops import fused_mlp as jfm
from papr_tpu.ops import stream_attn as jsa
from papr_tpu.train import step as jstep
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_params, from_jax_quant_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops import stream_attn as sa
from papr_tpu_torch.train import step as tstep
from test_int8_eval import _toy_attend_args

T_ = torch.as_tensor
K_DESC, V_DESC = ((2, 2, 2), 1, 2.0, 1.0, 0), ((2, 2), 1, 2.0, 1.0, 0)


def _toy(seed=0, lns=False, dead=True, **kw):
    """The JAX toy arguments, and the same as port tensors and walks."""
    args, opts = _toy_attend_args(seed=seed, **kw)
    rec, rayo, rays, qq, kws, kbs, _, _, wk, bk, vws, vbs, _, _ = args
    rng = np.random.default_rng(seed + 100)
    if dead:
        rec = np.array(rec)
        rec[..., 4] = rng.random(rec.shape[:2]) > 0.25
        rec[:, 5, 4] = 0.0                                  # an all-dead ray
        rec = jnp.asarray(rec)

    def ln(d):
        return (jnp.asarray(1 + 0.2 * rng.normal(size=d).astype(np.float32)),
                jnp.asarray(0.1 * rng.normal(size=d).astype(np.float32)))

    klns = (ln(kws[0].shape[0]), ln(kws[-1].shape[1])) if lns else (None, None)
    vlns = (ln(vws[0].shape[0]), ln(vws[-1].shape[1])) if lns else (None, None)
    jargs = (rec, rayo, rays, qq, kws, kbs, *klns, wk, bk, vws, vbs, *vlns)
    t = lambda a: T_(np.array(a))
    tln = lambda p: None if p is None else (t(p[0]), t(p[1]))
    kwalk = fm.Walk(tuple(map(t, kws)), tuple(map(t, kbs)), tln(klns[0]),
                    tln(klns[1]), "relu", "none",
                    sa.rec_pe_plan(True, K_DESC[0], 1, 2.0, 1.0, 0))
    vwalk = fm.Walk(tuple(map(t, vws)), tuple(map(t, vbs)), tln(vlns[0]),
                    tln(vlns[1]), "relu", "none",
                    sa.rec_pe_plan(False, V_DESC[0], 1, 2.0, 1.0, 0))
    targs = (t(rec), t(rayo), t(rays), t(qq), kwalk, t(wk), t(bk), vwalk)
    return jargs, opts, targs


def _jax_prep(jargs, which):
    """``_rec_prep`` of the toy's key or value walk (fp32 compute)."""
    rec = jargs[0]
    ws, bs, li, lo = jargs[4:8] if which == "k" else jargs[10:14]
    return jsa._rec_prep(rec, ws, bs, li, lo, K_DESC if which == "k" else
                         V_DESC, which == "k", "relu", "none", 32, "float32")


@pytest.mark.parametrize("which", ["k", "v"])
@pytest.mark.parametrize("lns", [False, True], ids=["no-ln", "ln"])
def test_walk_amax_matches_jax(which, lns):
    """Same (K, T, 128) record with dead rows, rays and walk: each layer's
    per-column amax to 1e-5 relative (fp32 walk on both sides; only the
    summation order of the matmuls differs)."""
    jargs, _, targs = _toy(lns=lns)
    _, dims, _, S, wsp, bsp, jl, cfg = _jax_prep(jargs, which)
    want = jsa._walk_amax(jargs[0], jargs[1], jargs[2], S, cfg, wsp, bsp, jl,
                          1e-6)
    walk = targs[4] if which == "k" else targs[7]
    calls = sa.walk_amax.calls
    got = sa.walk_amax(targs[0], targs[1], targs[2], walk, 1e-6)
    assert sa.walk_amax.calls == calls + 1 and len(got) == len(want) == 3
    for g, w, d in zip(got, want, dims):
        w = np.asarray(w).reshape(-1)
        assert g.shape == (d,) and float(g.max()) > 0
        np.testing.assert_allclose(g.numpy(), w[:d], rtol=1e-5, atol=1e-7)
        assert np.all(w[d:] == 0)                        # JAX's pad lanes


def test_walk_amax_ignores_dead_rows_and_subsamples_like_jax():
    """T = 600 rays, K = 4: 256 strided rays are sampled (stride 2); a huge
    position on a dead row or on an unsampled ray changes nothing (to 1e-6
    relative: the CPU matmul's last bit can move with its buffers' alignment
    between two calls; a position of 1e4 seen would move the amax by
    orders of magnitude)."""
    jargs, _, targs = _toy(T=600)
    rec = targs[0].clone()
    base = sa.walk_amax(rec, targs[1], targs[2], targs[4], 1e-6)
    rec[0, 1, :3] = 1e4                                    # odd ray: unsampled
    dead = int(torch.nonzero(rec[1, ::2, 4] < 0.5)[0]) * 2
    rec[1, dead, :3] = 1e4                                 # sampled, dead
    for a, b in zip(base, sa.walk_amax(rec, targs[1], targs[2], targs[4],
                                       1e-6)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    _, _, _, S, wsp, bsp, jl, cfg = _jax_prep(jargs, "k")
    want = jsa._walk_amax(jnp.asarray(rec.numpy()), jargs[1], jargs[2], S,
                          cfg, wsp, bsp, jl, 1e-6)
    for g, w in zip(base, want):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(w).reshape(-1)[:g.shape[0]],
                                   rtol=1e-5, atol=1e-7)


def test_quantize_walk_matches_jax():
    """Same fp32 weights and amax rows (one dead column): int8 weights
    EQUAL, ``inv`` / ``dq`` to 1e-6 relative."""
    rng = np.random.default_rng(1)
    dims = [45, 32, 24]
    ws = [rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
          for i in range(2)]
    amax = [rng.uniform(0.1, 8.0, size=d).astype(np.float32) for d in dims[:2]]
    amax[0][5] = 0.0
    pd = [128, 128, 128]
    jamax = [jnp.asarray(np.pad(a, (0, 128 - a.size))[None]) for a in amax]
    jwq, jinv, jdq = jsa._quantize_walk([jnp.asarray(w) for w in ws], pd,
                                        jamax)
    q = sa.quantize_walk([T_(w) for w in ws], [T_(a) for a in amax])
    for i in range(2):
        a, b = dims[i], dims[i + 1]
        assert q.wq[i].dtype == torch.int8 and q.wq[i].shape == (a, b)
        np.testing.assert_array_equal(q.wq[i].numpy(),
                                      np.asarray(jwq[i])[:a, :b])
        np.testing.assert_allclose(q.inv[i].numpy(),
                                   np.asarray(jinv[i])[0, :a], rtol=1e-6)
        np.testing.assert_allclose(q.dq[i].numpy(), np.asarray(jdq[i])[0, :b],
                                   rtol=1e-6)
    assert float(q.inv[0][5]) == 0.0 and not q.wq[0][5].any()
    assert int(q.wq[0].abs().max()) == 127


@pytest.mark.parametrize("lns", [False, True], ids=["no-ln", "ln"])
def test_walk_plain_q_matches_jax_body(lns):
    """``walk_plain_q`` against ``walk_body_fwd_q`` called on arrays, on the
    same encoding and the same quantization: 1e-5 of the output's scale."""
    jargs, _, targs = _toy(lns=lns)
    _, dims, pd, S, wsp, bsp, jl, cfg = _jax_prep(jargs, "k")
    amax = jsa._walk_amax(jargs[0], jargs[1], jargs[2], S, cfg, wsp, bsp, jl,
                          1e-6)
    jwq, jinv, jdq = jsa._quantize_walk(jargs[4], pd, amax)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(96, dims[0])).astype(np.float32)
    enc_p = jnp.asarray(np.pad(enc, ((0, 0), (0, pd[0] - dims[0]))))
    want = np.asarray(jfm.walk_body_fwd_q(cfg, enc_p, jwq, jinv, jdq, bsp,
                                          jl))[:, :dims[-1]]
    quant = from_jax_quant_params(
        jax.tree.map(np.asarray, ((jwq, jinv, jdq),)), (targs[4],),
        device="cpu")[0]
    got = fm.walk_plain_q(T_(enc), targs[4], quant).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_walk_plain_q_all_dead_sample_gives_the_biases():
    """amax == 0 everywhere (an all-dead calibration sample): inv == 0, every
    activation quantizes to 0 and each layer puts out act(b), as in JAX."""
    _, _, targs = _toy()
    walk = targs[7]
    rec = targs[0].clone()
    rec[..., 4] = 0.0
    q = sa.calibrate_walk(rec, targs[1], targs[2], walk, 1e-6)
    assert all(float(i.abs().max()) == 0 for i in q.inv)
    enc = torch.randn(7, len(walk.cols),
                      generator=torch.Generator().manual_seed(0))
    got = fm.walk_plain_q(enc, walk, q)
    assert torch.equal(got, walk.bs[-1].expand(7, -1))


@pytest.mark.parametrize("lns", [False, True], ids=["no-ln", "ln"])
@pytest.mark.parametrize("carried", [False, True],
                         ids=["self-calibrated", "quant_params"])
def test_int8_attend_matches_jax(lns, carried):
    """``attend_stream_eval(int8=True)``: self-calibrated on both sides, and
    with JAX's quantization carried across by ``from_jax_quant_params``.
    fused <= 2e-3 of its scale, attn max abs <= 1e-3 (both far inside int8's
    own distance to fp32, 5 % and 0.02 in the JAX tests), rows sum to 1. The
    all-dead ray is pure background with fused exactly 0."""
    jargs, opts, targs = _toy(lns=lns)
    qp_j = qp_t = None
    if carried:
        out = []
        for which in ("k", "v"):
            _, _, pd, S, wsp, bsp, jl, cfg = _jax_prep(jargs, which)
            amax = jsa._walk_amax(jargs[0], jargs[1], jargs[2], S, cfg, wsp,
                                  bsp, jl, 1e-6)
            ws = jargs[4] if which == "k" else jargs[10]
            out.append(jsa._quantize_walk(ws, pd, amax))
        qp_j = tuple(out)
        qp_t = from_jax_quant_params(jax.tree.map(np.asarray, qp_j),
                                     (targs[4], targs[7]), device="cpu")
    fj, aj = jsa.attend_stream_eval(*jargs, **opts, int8=True,
                                    quant_params=qp_j)
    calls = (sa.attend_eval_plain.calls, sa.walk_amax.calls)
    ft, at = sa.attend_stream_eval(*targs, "relu", 5.0, True, 1e-6,
                                   torch.float32, True, qp_t)
    assert sa.attend_eval_plain.calls == calls[0] + 1     # CPU: plain version
    assert sa.walk_amax.calls == calls[1] + (0 if carried else 2)
    fj, aj, ft, at = np.asarray(fj), np.asarray(aj), ft.numpy(), at.numpy()
    assert ft.shape == fj.shape and at.shape == aj.shape
    f_err = np.abs(ft - fj).max() / np.abs(fj).max()
    a_err = np.abs(at - aj).max()
    assert f_err <= 2e-3 and a_err <= 1e-3, (f_err, a_err)
    np.testing.assert_allclose(at.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(at[5], np.eye(5)[4], atol=1e-30)
    assert np.all(ft[5] == 0)
    # int8 is not the fp32 kernel: the flag did something
    f32 = sa.attend_stream_eval(*targs)[0].numpy()
    assert np.abs(ft - f32).max() > 1e-4 * np.abs(f32).max()


def test_int8_attend_index_form_equals_gathered_form():
    """``attend_eval_idx(int8=True)`` on a shuffled (P, 128) record + idx
    calibrates on ``record[idx[t]]``, the rows the gathered form samples."""
    _, _, targs = _toy()
    rec = targs[0]
    K, T, rp = rec.shape
    perm = torch.randperm(K * T, generator=torch.Generator().manual_seed(2))
    record = torch.empty(K * T, rp)
    record[perm] = rec.reshape(K * T, rp)
    idx = perm.reshape(K, T).T.contiguous()
    a = sa.attend_stream_eval(*targs, int8=True)
    b = sa.attend_eval_i8(record, idx, *targs[1:])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------ the model ----

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
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = dict(params)
    params["points_influ_scores"] = jnp.asarray(
        rng.normal(size=(320, 1)).astype(np.float32))
    alive = np.asarray(state["alive"]).copy()
    alive[10:40] = False
    state = {"alive": jnp.asarray(alive)}
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state),
                             load_config(overrides=_over()), device="cpu")
    return params, state, tp, ts


def _frame(seed=5, H=20, W=24):
    rng = np.random.default_rng(seed)
    rayo = np.array([[0.3, -0.2, 2.4]], np.float32)
    rayd = rng.normal(size=(1, H, W, 3)).astype(np.float32) * 0.25
    rayd[..., 2] -= 1.0
    rayd /= np.linalg.norm(rayd, axis=-1, keepdims=True)
    return rayo, rayd


def test_eval_quant_params_matches_jax(models):
    """Frame-level calibration on strided raw records and strided frame
    rays: int8 weights equal, ``inv`` / ``dq`` rows to 1e-5 relative (the
    amax behind them is a max over 320 fp32 walks)."""
    params, state, tp, ts = models
    over = _over(int8_eval=True)
    rayo, rayd = _frame()
    sample = rayd.reshape(-1, 3)[::3]
    want = jpapr.eval_quant_params(params, state, jax_load(overrides=over),
                                   jnp.asarray(rayo[0]), jnp.asarray(sample))
    calls = tpapr.eval_quant_params.calls
    tcfg = load_config(overrides=over)
    got = tpapr.eval_quant_params(tp, ts, tcfg, T_(rayo[0]), T_(sample))
    assert tpapr.eval_quant_params.calls == calls + 1
    # one frame's quantization: its kernel pack is made by the first tile
    assert isinstance(got, fm.FrameQuant) and got.packs is None
    conv = from_jax_quant_params(jax.tree.map(np.asarray, want),
                                 tpapr._record_walks(tp, tcfg,
                                                     tpapr.model_meta(tcfg)),
                                 device="cpu")
    for g, w in zip(got, conv):
        for a, b in zip(g.wq, w.wq):
            assert torch.equal(a, b)
        for a, b in zip(g.inv + g.dq, w.inv + w.dq):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    # A config whose eval does not take the one-shot kernel calibrates nothing.
    for tpu in ({"eval_fused": False}, {"fused_attn": True},
                {"query_fold": True}):
        cfg = load_config(overrides=_over(int8_eval=True, **tpu))
        assert tpapr.eval_quant_params(tp, ts, cfg, T_(rayo[0]),
                                       T_(sample)) is None
    assert tpapr.eval_quant_params.calls == calls + 1


def test_int8_frame_matches_jax_and_calibrates_once(models):
    """``render_full_image`` with ``int8_eval``, a 20 x 24 frame in 10 x 12
    tiles (4 tiles), against the JAX int8 frame: rgb and bkg_attn atol 2e-3
    (the attention bound above through the UNet, which is linear here up to
    its activations). The calibration runs ONCE per frame, not per tile, and
    no tile calibrates itself."""
    params, state, tp, ts = models
    over = _over(int8_eval=True)
    rayo, rayd = _frame()
    want = jstep.render_full_image(params, state, jax_load(overrides=over),
                                   rayo, rayd, 10, 12)
    before = (tpapr.eval_quant_params.calls, sa.walk_amax.calls,
              sa.attend_eval_plain.calls)
    got = tstep.render_full_image(tp, ts, load_config(overrides=over), rayo,
                                  rayd, 10, 12)
    assert tpapr.eval_quant_params.calls == before[0] + 1
    assert sa.walk_amax.calls == before[1] + 2           # key + value, once
    assert sa.attend_eval_plain.calls == before[2] + 4   # one per tile
    for name in ("rgb", "bkg_attn"):
        assert np.isfinite(got[name]).all()
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=2e-3,
                                   err_msg=name)
    assert np.ptp(got["bkg_attn"]) > 0.05
    fp = tstep.render_full_image(tp, ts, load_config(overrides=_over()), rayo,
                                 rayd, 10, 12)
    assert np.abs(fp["bkg_attn"] - got["bkg_attn"]).max() > 1e-5
    # the serving path takes the same hoisted calibration
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.3, -0.2, 2.4]
    n = tpapr.eval_quant_params.calls
    fr = tstep.render_frame(tp, ts, load_config(overrides=over), c2w, 25.0,
                            25.0, 20, 24, 10, 12)
    assert fr.shape == (20, 24, 3) and tpapr.eval_quant_params.calls == n + 1


def test_int8_evaluate_matches_jax_self_calibrated(models):
    """``evaluate`` alone (no frame-level calibration): the one-shot int8
    kernel calibrates on the call's own gathered records on both sides.
    fused <= 2e-3 of scale, attn <= 1e-3."""
    params, state, tp, ts = models
    over = _over(int8_eval=True)
    rayo, rayd = _frame(seed=6, H=9, W=11)
    jf, ja, jsel = jpapr.evaluate(params, state, jax_load(overrides=over),
                                  jnp.asarray(rayo), jnp.asarray(rayd),
                                  with_selected=True)
    n = sa.walk_amax.calls
    tf, ta, tsel = tpapr.evaluate(tp, ts, load_config(overrides=over),
                                  T_(rayo), T_(rayd), with_selected=True)
    assert sa.walk_amax.calls == n + 2
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    jf, ja = np.asarray(jf), np.asarray(ja)
    assert np.abs(tf.numpy() - jf).max() <= 2e-3 * np.abs(jf).max()
    assert np.abs(ta.numpy() - ja).max() <= 1e-3
