"""The port's plain one-shot eval attention against the JAX Pallas kernel
``attend_stream_eval(..., interpret=True)``: same gathered records, rays,
queries and walks.

Tolerances: fp32 compute rtol 1e-5, atol 1e-6 on fused and attn (same
formula; the port's two-pass softmax equals the kernel's online one up to
float rounding). bf16 compute: relative Frobenius error of fused <= 5e-3
and attn within 1e-3 absolute (bf16 activation rounding flips; see
test_torch_fused_mlp.py)."""

import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from papr_tpu.ops.stream_attn import attend_stream_eval as jax_attend
from papr_tpu_torch.ops.fused_mlp import Walk
from papr_tpu_torch.ops.stream_attn import (attend_eval_idx,
                                            attend_eval_plain,
                                            attend_stream_eval, rec_pe_plan)

K, T, DM, EXTRA = 5, 150, 32, 64
KL, VL = (2, 2, 2), (3, 3)


def _walk_params(rng, d_in, n, d_ff, d_out, norm):
    dims = [d_in] + [d_ff] * (n - 1) + [d_out]
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) / math.sqrt(dims[i]))
          .astype(np.float32) for i in range(n)]
    bs = [rng.normal(size=dims[i + 1]).astype(np.float32) * 0.1
          for i in range(n)]
    lns = ([(1 + 0.2 * rng.normal(size=d).astype(np.float32),
             0.1 * rng.normal(size=d).astype(np.float32))
            for d in (d_in, d_out)] if norm else [None, None])
    return ws, bs, lns


def _case(seed=0, dead_ray=True):
    rng = np.random.default_rng(seed)
    rec = np.zeros((K, T, 128), np.float32)
    rec[..., :3] = rng.normal(size=(K, T, 3)) * 1.5
    rec[..., 3] = rng.normal(size=(K, T))                   # influence
    rec[..., 4] = rng.random((K, T)) > 0.2                  # alive
    rec[..., 5:5 + EXTRA] = rng.normal(size=(K, T, EXTRA))
    if dead_ray:
        rec[:, 7, 4] = 0.0                                  # an all-dead ray
    rayo = np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3)).astype(np.float32)
    rays = rng.normal(size=(T, 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-6
    qq = rng.normal(size=(T, DM)).astype(np.float32)
    kcols = rec_pe_plan(True, KL, 1, 2.0, 1.0, 0)
    vcols = rec_pe_plan(False, VL, 1, 2.0, 1.0, EXTRA)
    kp = _walk_params(rng, len(kcols), 3, 24, 24, True)
    vp = _walk_params(rng, len(vcols), 3, 24, 8, False)
    wk = (rng.normal(size=(DM, 24)) / math.sqrt(24)).astype(np.float32)
    bk = rng.normal(size=DM).astype(np.float32) * 0.1
    return rec, rayo, rays, qq, kp, vp, wk, bk, kcols, vcols


def _run(seed, normalize, compute, dead_ray=True):
    rec, rayo, rays, qq, kp, vp, wk, bk, kcols, vcols = _case(seed, dead_ray)
    J = lambda a: jnp.asarray(a)
    lnj = lambda ln: tuple(map(J, ln)) if ln is not None else None
    fj, aj = jax_attend(
        J(rec), J(rayo), J(rays), J(qq), tuple(map(J, kp[0])),
        tuple(map(J, kp[1])), lnj(kp[2][0]), lnj(kp[2][1]), J(wk), J(bk),
        tuple(map(J, vp[0])), tuple(map(J, vp[1])), lnj(vp[2][0]),
        lnj(vp[2][1]), (KL, 1, 2.0, 1.0, 0), (VL, 1, 2.0, 1.0, EXTRA),
        "relu", "none", "relu", "none", "relu", 5.0, normalize, 1e-6, 256,
        True, compute)
    t = torch.as_tensor
    lnt = lambda ln: tuple(map(t, ln)) if ln is not None else None
    kwalk = Walk(tuple(map(t, kp[0])), tuple(map(t, kp[1])), lnt(kp[2][0]),
                 lnt(kp[2][1]), "relu", "none", kcols)
    vwalk = Walk(tuple(map(t, vp[0])), tuple(map(t, vp[1])), None, None,
                 "relu", "none", vcols)
    cdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    before = attend_eval_plain.calls
    ft, at = attend_stream_eval(t(rec), t(rayo), t(rays), t(qq), kwalk, t(wk),
                                t(bk), vwalk, "relu", 5.0, normalize, 1e-6,
                                cdt)
    assert attend_eval_plain.calls == before + 1       # CPU: plain version
    return ft.numpy(), at.numpy(), np.asarray(fj), np.asarray(aj), rec


@pytest.mark.parametrize("normalize", [True, False])
def test_fp32_matches_jax_kernel(normalize):
    ft, at, fj, aj, rec = _run(0, normalize, "float32")
    assert ft.shape == fj.shape == (T, 8) and at.shape == aj.shape == (T, K + 1)
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(at, aj, rtol=1e-5, atol=1e-6)
    # the all-dead ray: pure background, fused features exactly 0 when
    # renormalized (the foreground mass is 0 and divides by 1)
    np.testing.assert_allclose(at[7], np.eye(K + 1)[K], atol=1e-30)
    if normalize:
        assert np.all(ft[7] == 0)


def test_bf16_matches_jax_kernel():
    ft, at, fj, aj, _ = _run(1, True, "bfloat16", dead_ray=False)
    assert np.linalg.norm(ft - fj) / np.linalg.norm(fj) <= 5e-3
    assert np.abs(at - aj).max() <= 1e-3


def test_index_form_equals_gathered_form():
    """attend_eval_idx on a (P, 128) record + idx (T, K) equals the JAX
    layout entry point on the records gathered k-major."""
    rng = np.random.default_rng(2)
    rec, rayo, rays, qq, kp, vp, wk, bk, kcols, vcols = _case(2)
    record = rec.reshape(K * T, 128)
    perm = rng.permutation(K * T)
    record_p = np.empty_like(record)
    record_p[perm] = record
    idx = perm.reshape(K, T).T.copy()                   # (T, K)
    t = torch.as_tensor
    kwalk = Walk(tuple(map(t, kp[0])), tuple(map(t, kp[1])),
                 tuple(map(t, kp[2][0])), tuple(map(t, kp[2][1])), "relu",
                 "none", kcols)
    vwalk = Walk(tuple(map(t, vp[0])), tuple(map(t, vp[1])), None, None,
                 "relu", "none", vcols)
    a = attend_stream_eval(t(rec), t(rayo), t(rays), t(qq), kwalk, t(wk),
                           t(bk), vwalk)
    b = attend_eval_idx(t(record_p), t(idx), t(rayo), t(rays), t(qq), kwalk,
                        t(wk), t(bk), vwalk)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
