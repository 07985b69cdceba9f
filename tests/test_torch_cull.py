"""Selection: the port's plain culled selection against the JAX Pallas
kernel (interpret mode), and its exact torch.topk selection against
papr_tpu.ops.topk.

Tolerance: per-ray index SETS must be equal for at least 99.5% of rays; a
ray whose set differs must differ only by near-ties: sorted, its packed
distances (17 value bits, the pack both kernels rank by) agree with the
reference's to within one step of the pack. The squared distance is
|v|^2 - t^2 f, a difference of near-equal terms, so a last-bit difference in
|v|^2 between the frameworks' float sums can carry a distance that sits on a
pack boundary into the next step, where the index breaks the tie."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp
import torch

from papr_tpu.ops.geometry import get_rays_np
from papr_tpu.ops.tile_cull import select_topk_culled as jax_culled
from papr_tpu.ops.topk import select_topk as jax_select
from papr_tpu_torch.ops import tile_cull as tc
from papr_tpu_torch.ops.topk import VAL_MASK, select_topk


def _scene(P, H, W, seed=0, dead=None, spread=0.5):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(P, 3)).astype(np.float32) * spread
    alive = np.ones(P, bool)
    if dead:
        alive[dead[0]:dead[1]] = False
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0, 0, 2.5]
    rayo, rayd = get_rays_np(H, W, 40.0, 40.0, c2w[None])
    return pts, alive, rayo[0], rayd[0]


def _packed_dist(pts, alive, rayo, rayd, idx, eps=1e-6):
    """The 17-bit packed value of each selected point's squared distance."""
    v = pts - rayo
    vv = (v * v).sum(-1) + np.where(alive, 0.0, np.inf).astype(np.float32)
    d = rayd.reshape(-1, 3)[:, None, :]
    t = (d * v[idx]).sum(-1)
    dd = (d * d).sum(-1)
    f = (dd + 2 * eps) / (dd + eps) ** 2
    dist = np.maximum(vv[idx] - t * t * f, 0).astype(np.float32)
    return dist.view(np.int32) & VAL_MASK


def _assert_sets_equal_or_ties(got, want, pts, alive, rayo, rayd):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    same = np.all(np.sort(got, -1) == np.sort(want, -1), axis=-1)
    assert same.mean() >= 0.995, same.mean()
    if not same.all():
        bad = ~same
        qg = np.sort(_packed_dist(pts, alive, rayo, rayd, got)[bad], -1)
        qw = np.sort(_packed_dist(pts, alive, rayo, rayd, want)[bad], -1)
        step = np.abs(qg.astype(np.int64) - qw) // (1 << 15)
        assert step.max() <= 1, step.max()
    return same.mean()


def _both(pts, alive, rayo, rayd, k, **kw):
    got = tc.select_topk_culled(torch.as_tensor(pts), torch.as_tensor(alive),
                                torch.as_tensor(rayo), torch.as_tensor(rayd),
                                k, **kw).numpy()
    want = np.asarray(jax_culled(jnp.asarray(pts), jnp.asarray(alive),
                                 jnp.asarray(rayo), jnp.asarray(rayd), k,
                                 interpret=True, **kw))
    return got, want


@pytest.mark.parametrize("prefilter", ["packsort", "sort"])
def test_dense_cloud_cap_binds(prefilter):
    """A dense 2048-point cloud with M=512 candidates per 16x16 tile: the cap
    truncates (the capped selection differs from the exact one), and the
    port still matches the JAX kernel ray for ray."""
    pts, alive, rayo, rayd = _scene(2048, 32, 32, seed=7, dead=(100, 300),
                                    spread=0.35)
    k = 8
    got, want = _both(pts, alive, rayo, rayd, k, M=512, block=16,
                      prefilter=prefilter)
    _assert_sets_equal_or_ties(got, want, pts, alive, rayo, rayd)
    assert not np.isin(got, np.arange(100, 300)).any()
    exact = select_topk(torch.as_tensor(pts), torch.as_tensor(alive),
                        torch.as_tensor(rayo),
                        torch.as_tensor(rayd.reshape(-1, 3)), k).numpy()
    exact_same = np.all(np.sort(exact, -1) == np.sort(got, -1), axis=-1)
    assert exact_same.mean() < 1.0, "the candidate cap never bound"


def test_nonaligned_frame_and_tiny_cloud():
    """23x37 frame (edge-padded tiles) and M above P (pad slots at +inf)."""
    pts, alive, rayo, rayd = _scene(600, 23, 37, seed=2, dead=(0, 50))
    got, want = _both(pts, alive, rayo, rayd, 6, M=1024, block=16,
                      prefilter="packsort")
    assert got.shape == (23 * 37, 6)
    _assert_sets_equal_or_ties(got, want, pts, alive, rayo, rayd)


def test_plain_matches_early_exit_kernel():
    """M=2048 in 512-wide chunks with a sorted prefilter: the JAX kernel
    exits early, the plain stage 3 scans every chunk; same winners."""
    pts, alive, rayo, rayd = _scene(3000, 32, 32, seed=0, dead=(50, 150))
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        torch.as_tensor(pts), torch.as_tensor(alive), torch.as_tensor(rayo),
        torch.as_tensor(rayd), M=2048, block=16, prefilter="sort")
    assert ee and chunk == 512 and recs.shape[-1] == 2048
    got, want = _both(pts, alive, rayo, rayd, 8, M=2048, block=16,
                      prefilter="sort", early_exit=True)
    _assert_sets_equal_or_ties(got, want, pts, alive, rayo, rayd)


def test_approx_prefilter_matches_jax_top_k():
    """The training prefilter on the dense, capped scene: the port reads
    'approx' as the exact top-k of the lower bounds with lax.top_k's ties
    (to the lower index), so it selects as the JAX kernel does behind its
    top-k prefilter. (Off the TPU, approx_min_k returns the same set except
    among tied bounds, which this scene has many of: every point inside a
    tile's cone bounds at 0.)"""
    pts, alive, rayo, rayd = _scene(2048, 32, 32, seed=7, dead=(100, 300),
                                    spread=0.35)
    got = tc.select_topk_culled(torch.as_tensor(pts), torch.as_tensor(alive),
                                torch.as_tensor(rayo), torch.as_tensor(rayd),
                                8, M=512, prefilter="approx").numpy()
    want = np.asarray(jax_culled(jnp.asarray(pts), jnp.asarray(alive),
                                 jnp.asarray(rayo), jnp.asarray(rayd), 8,
                                 M=512, interpret=True, prefilter="sort"))
    _assert_sets_equal_or_ties(got, want, pts, alive, rayo, rayd)


def test_tile_untile_roundtrip():
    H, W = 20, 24
    ids = torch.arange(H * W, dtype=torch.float32).reshape(H, W, 1).repeat(1, 1, 3)
    tiles, meta = tc.tile_rays(ids, 16)
    assert tiles.shape == (4, 256, 3)
    back = tc.untile_indices(tiles[..., :1].to(torch.int32), meta)
    assert torch.equal(back[:, 0], torch.arange(H * W, dtype=torch.int32))


def test_exact_selection_matches_jax():
    pts, alive, rayo, rayd = _scene(1500, 16, 16, seed=4, dead=(10, 60))
    k = 8
    got = select_topk(torch.as_tensor(pts), torch.as_tensor(alive),
                      torch.as_tensor(rayo),
                      torch.as_tensor(rayd.reshape(-1, 3)), k, chunk=100)
    want = np.asarray(jax_select(jnp.asarray(pts), jnp.asarray(alive),
                                 jnp.asarray(rayo),
                                 jnp.asarray(rayd.reshape(-1, 3)), k,
                                 chunk=128))
    assert got.dtype == torch.int32
    _assert_sets_equal_or_ties(got.numpy(), want, pts, alive, rayo, rayd)


def test_cull_approx_prefilter_raises():
    """'approx' (the training prefilter) is now the exact top-k of the
    lower bounds: the same selection as the exact sort; a prefilter name the
    port does not know still raises."""
    pts, alive, rayo, rayd = _scene(100, 16, 16)
    args = (torch.as_tensor(pts), torch.as_tensor(alive),
            torch.as_tensor(rayo), torch.as_tensor(rayd), 4)
    got = tc.select_topk_culled(*args, M=64, prefilter="approx")
    want = tc.select_topk_culled(*args, M=64, prefilter="sort")
    assert torch.equal(torch.sort(got, -1).values, torch.sort(want, -1).values)
    with pytest.raises(NotImplementedError, match="approx"):
        tc.select_topk_culled(*args, prefilter="approx_min_k")
