"""``papr_tpu_torch.parallel`` in one process, against ``papr_tpu.parallel``
and the JAX loop: the ranks' coordinates and axis groups are the row-major
order of JAX's ``devices.reshape(data, rays)``, each rank's block of a batch
is the shard JAX places on that device, the render's wrap-padding index is
JAX's, and a mesh the running ranks cannot hold raises JAX's ``ValueError``
texts (the divisibility errors word for word; the device count naming the
``torchrun`` launch). The mesh (rays and data gathers, the gradient
reduction, the broadcast) is exercised across ranks in
``test_torch_mesh_spmd.py``."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from papr_tpu.parallel.mesh import make_plan as jax_make_plan
from papr_tpu.train import loop as jloop
from papr_tpu_torch.config import load_config
from papr_tpu_torch.parallel import collectives as coll
from papr_tpu_torch.parallel import mesh as pmesh
from papr_tpu_torch.train import loop as tloop
from papr_tpu_torch.train import step as tstep

SHAPES = [(2, 2), (2, 4), (1, 4), (4, 1), (1, 1)]


@pytest.mark.parametrize("data,rays", SHAPES)
def test_coordinates_and_groups_are_jax_row_major(data, rays):
    ids = np.vectorize(lambda d: d.id)(jax_make_mesh(data, rays).devices)
    along_data, along_rays = pmesh.axis_ranks(data, rays)
    assert along_rays == ids.tolist()
    assert along_data == ids.T.tolist()
    for r in range(data * rays):
        m = pmesh.Mesh(data, rays, r, None, None, None)
        assert m.size == data * rays
        assert tuple(np.argwhere(ids == r)[0]) == m.coords


@pytest.mark.parametrize("data,rays", SHAPES)
def test_blocks_are_the_shards_jax_places(data, rays):
    """rayd's block is the (data, rays) shard, the other arrays' the data
    shard, on the device of the same index."""
    x = np.arange(4 * 8 * 3 * 2, dtype=np.float32).reshape(4, 8, 3, 2)
    jplan = jax_make_plan(jax_make_mesh(data, rays))
    rays_s = {s.device.id: np.asarray(s.data) for s in
              jax.device_put(x, jplan.rays).addressable_shards}
    batch_s = {s.device.id: np.asarray(s.data) for s in
               jax.device_put(x, jplan.batch_only).addressable_shards}
    for r in range(data * rays):
        plan = pmesh.make_plan(pmesh.Mesh(data, rays, r, None, None, None))
        np.testing.assert_array_equal(plan.ray_block(x), rays_s[r])
        np.testing.assert_array_equal(plan.batch_block(x), batch_s[r])


def test_a_batch_that_does_not_split_raises():
    plan = pmesh.make_plan(pmesh.Mesh(2, 1, 1, None, None, None))
    with pytest.raises(ValueError, match="batch of 3 images does not split "
                                         "over tpu.mesh.data=2"):
        plan.batch_block(np.zeros((3, 4)))


@pytest.mark.parametrize("G,D", [(9, 4), (1, 4), (64, 2), (8, 8), (3, 2)])
def test_wrap_index_is_jax(G, D):
    """papr_tpu/train/step.py _sharded_tile_attend: Gp = ceil(G / D) * D,
    gidx = arange(Gp) % G; rank r takes the r-th of D equal slices."""
    Gp = -(-G // D) * D
    gidx = tstep.wrap_index(G, D)
    np.testing.assert_array_equal(gidx, np.arange(Gp) % G)
    assert len(gidx) % D == 0 and set(gidx.tolist()) == set(range(G))


def _cfg(load, data, rays, **over):
    return load(overrides={"dataset": {"batch_size": over.get("bs", 1),
                                       "patches": {"height": 16,
                                                   "width": 16}},
                           "tpu": {"mesh": {"data": data, "rays": rays}}})


@pytest.mark.parametrize("data,rays,bs", [(2, 1, 1), (1, 3, 2), (4, 2, 6)],
                         ids=["batch", "rows", "batch-first"])
def test_divisibility_errors_are_jax_word_for_word(data, rays, bs):
    with pytest.raises(ValueError) as want:
        jloop._mesh_plan(_cfg(jax_load, data, rays, bs=bs))
    with pytest.raises(ValueError) as got:
        tloop._mesh_plan(_cfg(load_config, data, rays, bs=bs))
    assert "must be divisible by" in str(got.value)
    assert str(got.value) == str(want.value)


def test_a_mesh_larger_than_the_ranks_names_the_launch():
    """One process, no torchrun: 1 rank runs, as JAX's make_mesh counts the
    visible devices."""
    with pytest.raises(ValueError, match=r"tpu.mesh=\(data=2, rays=2\) needs "
                                         r"4 devices but only 1 are visible"
                                         r".*torchrun --standalone "
                                         r"--nproc_per_node=4"):
        pmesh.make_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 2 devices but only 1"):
        tloop._mesh_plan(_cfg(load_config, 1, 2))


def test_renders_fall_back_to_one_rank():
    """papr_tpu/train/step.py _render_mesh: no mesh for one device, for
    ``tpu.force_local``, or when fewer ranks run than the mesh names."""
    assert tstep._render_mesh(_cfg(load_config, 1, 1)) is None
    assert tstep._render_mesh(_cfg(load_config, 2, 2)) is None
    forced = load_config(overrides={"tpu": {"mesh": {"data": 2, "rays": 1},
                                            "force_local": True}})
    assert tstep._render_mesh(forced) is None
    assert tloop._mesh_plan(_cfg(load_config, 1, 1)) is None


def test_collectives_of_a_one_device_mesh_leave_tensors_as_they_are():
    mesh = pmesh.make_mesh(1, 1)
    assert mesh.world is None and mesh.coords == (0, 0)
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = coll.gather_rows(x, mesh)
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * 3).sum(), x)
    assert torch.equal(g, torch.full_like(x, 3.0))
    assert torch.equal(coll.gather_batch(x.detach(), mesh), x.detach())
    assert torch.equal(coll.gather_world(x.detach(), mesh), x.detach())
    grads = [torch.ones(3), torch.ones(2, 2)]
    coll.reduce_gradients(grads, mesh)
    assert all(torch.equal(t, torch.ones_like(t)) for t in grads)
    coll.replicate(mesh, {"a": grads})
    coll.barrier(mesh)
