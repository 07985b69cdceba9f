"""The port's embedder backward (``fused_mlp_bwd`` and the ``FusedMLP``
autograd function; their plain versions on CPU tensors) against
``jax.grad`` through the Pallas ``fused_mlp`` in interpret mode, which runs
the TPU backward kernel ``_bwd_kernel``: dx, dW, db and dLN, with and
without LayerNorms, and a row count that overhangs the kernels' tiles.
fp32 compute; tolerance rtol 3e-4 (JAX's own gradient bound) with atol
1e-6 x the gradient's max (sums over the rows in another order)."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from papr_tpu_torch.ops import fused_mlp as fm
from papr_tpu_torch.ops.fused_mlp import Walk, posenc_plan

DIMS, LS, EXTRA = (3, 3), (3, 2), 5


def _case(norm, T, seed):
    rng = np.random.default_rng(seed)
    d_raw, cols = posenc_plan(DIMS, LS, 1, 2.0, 1.0, EXTRA)
    dims = [len(cols), 32, 32, 24]
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
          .astype(np.float32) for i in range(3)]
    bs = [rng.normal(size=dims[i + 1]).astype(np.float32) * 0.1
          for i in range(3)]
    lns = [(rng.normal(size=d).astype(np.float32) * 0.2 + 1,
            rng.normal(size=d).astype(np.float32) * 0.1)
           for d in (dims[0], dims[-1])] if norm else None
    x = rng.normal(size=(T, d_raw)).astype(np.float32) * 3
    dy = rng.normal(size=(T, dims[-1])).astype(np.float32)
    return x, dy, ws, bs, lns, cols


@pytest.mark.parametrize("norm,T", [(True, 256), (False, 300), (True, 77)])
def test_embedder_backward_matches_jax(norm, T):
    x, dy, ws, bs, lns, cols = _case(norm, T, seed=T)
    pe_desc = (DIMS, LS, 1, 2.0, 1.0, EXTRA)

    def jloss(x, ws, bs, lns):
        y = jax_fused_mlp(x, ws, bs, lns[0] if lns else None,
                          lns[1] if lns else None, "relu", "none", True, 128,
                          pe_desc, "float32")
        return jnp.sum(y * dy)

    J = lambda a: jax.tree.map(jnp.asarray, a)
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        J(x), J(tuple(ws)), J(tuple(bs)), J(tuple(map(tuple, lns))) if lns
        else None)
    want = [jg[0]] + list(jg[1]) + list(jg[2]) + (
        [t for ln in jg[3] for t in ln] if lns else [])

    t = torch.as_tensor
    walk = Walk(tuple(map(t, ws)), tuple(map(t, bs)),
                tuple(map(t, lns[0])) if lns else None,
                tuple(map(t, lns[1])) if lns else None, "relu", "none", cols)
    before = fm.fused_mlp_bwd_plain.calls
    dx, grads = fm.fused_mlp_bwd(t(x), t(dy), walk, torch.float32)
    assert fm.fused_mlp_bwd_plain.calls == before + 1    # CPU: plain version
    close = lambda a, b, msg: np.testing.assert_allclose(
        a, b, rtol=3e-4, atol=1e-6 * float(np.abs(b).max()), err_msg=msg)
    for i, (a, b) in enumerate(zip([dx] + grads, want)):
        close(a.numpy(), np.asarray(b), str(i))

    # The same gradients through autograd (FusedMLP).
    leaves = [t(x).requires_grad_()] + [p.clone().requires_grad_()
                                        for p in fm.walk_tensors(walk)]
    y = fm.fused_mlp_apply(leaves[0], fm.walk_with(walk, leaves[1:]),
                           torch.float32)
    (y * t(dy)).sum().backward()
    for i, (l, b) in enumerate(zip(leaves, want)):
        close(l.grad.numpy(), np.asarray(b), f"autograd {i}")


def test_source_segments_cover_each_raw_column():
    d_raw, cols = posenc_plan(DIMS, LS, 1, 2.0, 1.0, EXTRA)
    seg = fm.source_segments(cols, d_raw, "cpu").tolist()
    start, end = seg[:d_raw], seg[d_raw:]
    assert start[0] == 0 and end[-1] == len(cols)
    for s in range(d_raw):
        assert all(int(cols[c][0]) == s for c in range(start[s], end[s]))
    assert sum(e - s for s, e in zip(start, end)) == len(cols)
    with pytest.raises(ValueError, match="contiguous"):
        fm.source_segments(((0, 0.0, 0), (1, 0.0, 0), (0, 1.0, 1)), 2, "cpu")
