"""The streaming top-k (``papr_tpu_torch/ops/pallas_topk.py``) against the
JAX package's ``pallas_select_topk`` in interpret mode, on the CPU (the
port's plain version).

Both pack (17 distance bits | 15 index bits) and keep the k smallest keys.
The two may round ``d . v`` differently in the last place (XLA may contract
to FMAs), which can move a distance across a 17-bit boundary, so rows are
held equal wherever the port's k-th and (k+1)-th keys differ in their
distance bits and no key sits within one quantization step of another
rank's; elsewhere, and against the exact selection, overlap is demanded
(> 0.995, as the JAX test asks)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from papr_tpu.ops.pallas_topk import pallas_select_topk as jax_topk
from papr_tpu_torch.ops import pallas_topk as pt
from papr_tpu_torch.ops.topk import select_topk


def _setup(P=4096, R=300, seed=0, dead=None):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(P, 3)).astype(np.float32) * 3
    alive = np.ones(P, bool)
    if dead:
        alive[dead[0]:dead[1]] = False
    o = rng.normal(size=(3,)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pts, alive, o, d


def _both(pts, alive, o, d, k):
    want = np.asarray(jax_topk(jnp.asarray(pts), jnp.asarray(alive),
                               jnp.asarray(o), jnp.asarray(d), k,
                               interpret=True))
    t = torch.as_tensor
    got = pt.pallas_select_topk(t(pts), t(alive), t(o), t(d), k).numpy()
    return got, want


def _overlap(a, b):
    k = a.shape[1]
    return float(np.mean([len(set(a[i]) & set(b[i])) / k
                          for i in range(a.shape[0])]))


@pytest.mark.parametrize("P,R,k,dead,seed", [(4096, 300, 20, (100, 200), 0),
                                             (3000, 77, 8, None, 1)])
def test_stream_topk_matches_jax_kernel(P, R, k, dead, seed):
    pts, alive, o, d = _setup(P, R, seed, dead)
    got, want = _both(pts, alive, o, d, k)
    assert got.shape == want.shape == (R, k) and got.dtype == np.int32
    assert (got >= 0).all() and (got < P).all()
    if dead:
        assert not np.isin(got, np.arange(*dead)).any()
    # rows where the port's own keys are well separated must be equal
    t = torch.as_tensor
    rd, f, vT, v2 = pt.stream_inputs(t(pts), t(alive), t(o), t(d), 1e-6)
    tt = (rd[:, 0:1] * vT[0:1] + rd[:, 1:2] * vT[1:2]) + rd[:, 2:3] * vT[2:3]
    dist = torch.clamp_min(v2[None] - tt * tt * f[:, None], 0.0)
    top = torch.topk(dist, k + 1, dim=1, largest=False).values.numpy()
    gap = (top[:, 1:] - top[:, :-1]) / np.maximum(top[:, 1:], 1e-30)
    clear = (gap > 2.0 ** -7).all(axis=1)          # > 2 quantization steps
    assert clear.sum() >= 3
    np.testing.assert_array_equal(got[clear], want[clear])
    assert _overlap(got, want) > 0.995
    exact = select_topk(t(pts), t(alive), t(o), t(d), k, chunk=512).numpy()
    assert _overlap(got, exact) > (0.995 if k == 20 else 0.99)
    for row in got[:32]:
        assert len(set(row.tolist())) == len(row)


def test_stream_topk_fewer_than_k_alive():
    """12 alive points, k = 20: the 12 come first (nearest first), the tail
    is dead slots in index order, as in the JAX kernel."""
    pts, alive, o, d = _setup(P=2500, R=40, seed=2)
    alive[:] = False
    keep = np.random.default_rng(3).permutation(2500)[:12]
    alive[keep] = True
    got, want = _both(pts, alive, o, d, 20)
    assert set(keep.tolist()) == set(got[0, :12].tolist())
    assert all(set(r[:12].tolist()) == set(keep.tolist()) for r in got)
    np.testing.assert_array_equal(got[:, 12:], want[:, 12:])
    dead_sorted = np.nonzero(~alive)[0][:8]
    np.testing.assert_array_equal(got[0, 12:], dead_sorted)


def test_stream_topk_limits_and_counters():
    pts, alive, o, d = _setup(P=64, R=5, seed=4)
    t = torch.as_tensor
    big = torch.zeros(32769, 3)
    with pytest.raises(ValueError, match="32768"):
        pt.pallas_select_topk(big, torch.ones(32769, dtype=torch.bool),
                              t(o), t(d), 4)
    calls, launches = pt.topk_stream_plain.calls, pt.topk_stream.launches
    out = pt.pallas_select_topk(t(pts), t(alive), t(o), t(d), 4)
    assert out.shape == (5, 4)
    assert pt.topk_stream_plain.calls == calls + 1
    assert pt.topk_stream.launches == launches      # CPU: no kernel launch
