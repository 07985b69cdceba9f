"""The collectives of the (data, rays) mesh: in the JAX package XLA inserts
them from the sharding constraints and shard_map's transposes.

Every one is built from ``all_reduce`` (a sum) and ``broadcast``. gloo runs
only those two on CUDA tensors (ranks sharing a card), NCCL and gloo run
them on every device, and a sum of one block and zeros is exact: a gather
built this way returns every block bit for bit, in rank order. A group of
None (no process group: a mesh of one device) leaves every tensor as it is.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..train.optim import tree_leaves


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(x: torch.Tensor, group, index: int, size: int,
               dim: int = 0) -> torch.Tensor:
    """The equal-shaped blocks of the ``size`` ranks of ``group`` (this
    rank's is block ``index``), concatenated along ``dim`` in rank order."""
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[index] = x
    _all_reduce(buf, group)
    shape = list(x.shape)
    shape[dim] *= size
    return buf.movedim(0, dim).reshape(shape)


def reduce_scatter(g: torch.Tensor, group, index: int, size: int,
                   dim: int = 0) -> torch.Tensor:
    """Block ``index`` along ``dim`` of the sum of ``g`` over ``group``."""
    g = _all_reduce(g.contiguous().clone(), group)
    return g.chunk(size, dim)[index].contiguous()


class _GatherRows(torch.autograd.Function):
    """Forward: the rays group's row blocks gathered along dim 1. Backward:
    the sum of the cotangents over the rays group, this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather(x, mesh.rays_group, mesh.coords[1], mesh.rays, 1)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return reduce_scatter(g, m.rays_group, m.coords[1], m.rays, 1), None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, h, ...) ray-row block -> (n, h * rays, ...), the data group's
    whole patch; differentiable (its backward is a reduce-scatter)."""
    return _GatherRows.apply(x, mesh)


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """(n, ...) data shard -> (n * data, ...), the whole batch."""
    return all_gather(x, mesh.data_group, mesh.coords[0], mesh.data, 0)


def gather_world(x: torch.Tensor, mesh) -> torch.Tensor:
    """(m, ...) per rank -> (m * size, ...) over the world, rank order."""
    return all_gather(x, mesh.world, mesh.rank, mesh.size, 0)


def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over the data groups of a value each group holds."""
    return _all_reduce(x.detach().clone(), mesh.data_group) / mesh.data


def _coalesced(tensors, fn) -> None:
    """``fn`` on one flat buffer per dtype and device holding every tensor,
    whose values are then copied back (bool travels as uint8)."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, _), ts in by_kind.items():
        wire = torch.uint8 if dtype == torch.bool else dtype
        flat = torch.cat([t.reshape(-1).to(wire) for t in ts])
        fn(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view(t.shape))


def reduce_gradients(grads, mesh) -> None:
    """In place: each gradient summed over the world, divided by ``data``.
    A rank back-propagates its data group's loss / ``rays``, so the sum
    gives the replicated stages (the UNet) the mean over data groups, and
    the ray-sharded attention the sum of its blocks' partial gradients,
    over ``data``: the gradient of the global loss."""
    def fn(flat):
        _all_reduce(flat, mesh.world)
        flat.div_(mesh.data)
    _coalesced(grads, fn)


def replicate(mesh, *trees) -> None:
    """In place: every tensor of the nested dict / list ``trees`` takes rank
    0's values (the JAX package re-replicates host results over the mesh).
    A ``mesh`` of None, or one without a process group, leaves them as they
    are."""
    if mesh is not None and mesh.world is not None:
        _coalesced([x for t in trees for x in tree_leaves(t)
                    if isinstance(x, torch.Tensor)],
                   lambda flat: dist.broadcast(flat, 0, group=mesh.world))


def barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for the others (None: no group)."""
    if mesh is not None and mesh.world is not None:
        dist.barrier(group=mesh.world)
