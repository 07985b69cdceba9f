"""``papr_tpu_torch/ops/fused_attn.py`` against the JAX package's
``fused_scores`` in interpret mode and ``jax.grad`` of it, on the CPU (the
port's plain versions).

Tolerances: fp32 forward atol 1e-5; fp32 gradients 1e-4 relative to each
gradient's max (the two frameworks sum in another order); bf16 2e-2
relative to the max (each side rounds its projections to bf16 at its own
places)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.ops.fused_attn import fused_scores as jax_fused_scores
from papr_tpu_torch.ops import fused_attn as fa


def _inputs(seed, T, K, Dk=48, Dq=40, dm=32, dead_frac=0.2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    alive = (rng.random((T, K)) > dead_frac).astype(np.float32)
    alive[1] = 0.0                                       # an all-dead ray
    return (f(K, T, Dk), f(T, Dq), f(dm, Dk) / np.sqrt(Dk), f(dm) * 0.1,
            f(dm, Dq) / np.sqrt(Dq), f(dm) * 0.1,
            (f(T, K) * 0.5 + 1.0), alive)


def _close(got, want, tol, name=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("T,K,tile,act,Dk", [(64, 20, 32, "relu", 48),
                                             (100, 20, 32, "relu", 48),
                                             (64, 7, 64, "relu", 128),
                                             (48, 5, 16, "none", 33)])
def test_forward_matches_jax_kernel(T, K, tile, act, Dk):
    args = _inputs(0, T, K, Dk=Dk)
    want = np.asarray(jax_fused_scores(*map(jnp.asarray, args), score_act=act,
                                       bkg_score=5.0, tile=tile,
                                       interpret=True))
    calls = fa.fused_scores_plain.calls
    got = fa.fused_scores(*map(torch.as_tensor, args), score_act=act,
                          bkg_score=5.0)
    assert fa.fused_scores_plain.calls == calls + 1
    assert got.shape == (T, K + 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, atol=1e-5)
    assert got[1, K] == 1.0 and float(got[1, :K].abs().max()) == 0.0


# A seeded few percent of dead slots (alive = 0 on single (t, k), as a
# pruned cloud leaves them) beside an all-dead ray, at the widths of the
# fp32 forward's query and key heads cut to 64 (Dk, Dq, d_model): the plain
# forward against JAX's interpret-mode kernel, fp32 within atol 1e-5 (the
# bound above), bf16 within BF16_ATTN_ABS absolute (each side rounds its
# projections to bf16 at the same points and sums in another order); every
# dead slot's attn exactly 0.
BF16_ATTN_ABS = 2e-3


@pytest.mark.parametrize("compute", [None, "bfloat16"])
def test_forward_with_dead_slots_matches_jax(compute):
    T, K = 96, 20
    args = _inputs(6, T, K, Dk=64, Dq=64, dm=64, dead_frac=0.04)
    alive = args[7]
    assert 0 < (alive[2:] == 0).sum() < 0.1 * T * K
    want = np.asarray(jax_fused_scores(*map(jnp.asarray, args),
                                       score_act="relu", bkg_score=5.0,
                                       tile=32, interpret=True,
                                       compute=compute))
    cdt = torch.bfloat16 if compute else None
    got = fa.fused_scores(*map(torch.as_tensor, args), score_act="relu",
                          bkg_score=5.0, compute=cdt).numpy()
    assert got.shape == (T, K + 1)
    err = float(np.abs(got - want).max())
    assert err <= (BF16_ATTN_ABS if compute else 1e-5), err
    assert float(np.abs(got[:, :K][alive == 0]).max()) == 0.0
    assert got[1, K] == 1.0


@pytest.mark.parametrize("act,compute,tol", [("relu", None, 1e-4),
                                             ("none", None, 1e-4),
                                             ("relu", "bfloat16", 2e-2)])
def test_gradients_match_jax_kernel(act, compute, tol):
    T, K = 72, 6
    args = _inputs(3, T, K)
    cot = np.random.default_rng(4).normal(size=(T, K + 1)).astype(np.float32)

    def jloss(ek, eq, wk, bk, wq, bq, influ):
        out = jax_fused_scores(ek, eq, wk, bk, wq, bq, influ,
                               jnp.asarray(args[7]), score_act=act,
                               bkg_score=5.0, tile=32, interpret=True,
                               compute=compute)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=tuple(range(7)))(
        *map(jnp.asarray, args[:7]))
    leaves = [torch.as_tensor(a).requires_grad_(True) for a in args[:7]]
    cdt = torch.bfloat16 if compute else None
    calls = fa.fused_scores_bwd_plain.calls
    out = fa.fused_scores(*leaves, torch.as_tensor(args[7]), score_act=act,
                          bkg_score=5.0, compute=cdt)
    got = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), leaves)
    assert fa.fused_scores_bwd_plain.calls == calls + 1
    names = ("d_embedk", "d_embedq", "dwk", "dbk", "dwq", "dbq", "d_influ")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g.numpy(), np.asarray(w), tol, name)
    assert float(got[6][1].abs().max()) == 0.0           # all-dead ray
    assert float(got[0][:, 1].abs().max()) == 0.0


def test_relu_pattern_and_wrapper_contract():
    """``relu_on`` replaces the relu's own pattern; ``score_fusible`` and
    the unknown-activation error are the JAX package's."""
    from papr_tpu.ops.fused_attn import score_fusible as jax_fusible
    from papr_tpu_torch.config import load_config
    args = list(map(torch.as_tensor, _inputs(5, 16, 4)))
    attn, raw = fa.fused_scores_plain(*args, "relu", 5.0)
    same, _ = fa.fused_scores_plain(*args, "relu", 5.0, relu_on=raw > 0)
    torch.testing.assert_close(same, attn, rtol=0, atol=0)
    flipped, _ = fa.fused_scores_plain(*args, "relu", 5.0,
                                       relu_on=torch.ones_like(raw) > 0)
    none, _ = fa.fused_scores_plain(*args, "none", 5.0)
    torch.testing.assert_close(flipped, none, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        fa.fused_scores(*args, score_act="gelu")
    for over in ({}, {"models": {"attn": {"score_act": "gelu"}}},
                 {"models": {"attn": {"kernel_type": "dot"}}}):
        cfg = load_config(overrides=over)
        assert fa.score_fusible(cfg.models.attn) == jax_fusible(cfg.models.attn)
