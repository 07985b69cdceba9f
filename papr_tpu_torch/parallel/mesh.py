"""The ``('data', 'rays')`` device mesh (``papr_tpu/parallel/mesh.py``) on
``torch.distributed``: one process, a rank, per device.

* The axes are the JAX package's: batch images over ``data``, the patch's
  ray rows over ``rays``. Rank r sits at (r // rays, r % rays), the
  row-major order of JAX's ``devices.reshape(data, rays)``.
* Parameters are replicated: every rank holds the whole model and applies
  the same update; gradients are summed over the world
  (``parallel/collectives.py``).
* Ranks are launched as PyTorch launches them::

      torchrun --standalone --nproc_per_node=N -m papr_tpu_torch.cli.train --opt <yml>

  (``cli.test`` and ``cli.exposure`` alike). Each rank reads ``RANK``,
  ``WORLD_SIZE`` and ``LOCAL_RANK`` and takes the card
  ``cuda:LOCAL_RANK % device_count()``.
* The backend is NCCL when every rank has a card of its own, gloo on the CPU
  and when ranks share a card (NCCL refuses two ranks on one device). The
  collectives use only ``all_reduce`` and ``broadcast``, which gloo runs on
  CUDA tensors too.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import platform_device


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, rays) mesh. The groups are
    ``torch.distributed`` process groups, or None when no process group
    runs (a mesh of one device in one process)."""
    data: int
    rays: int
    rank: int
    world: object        # every rank of the mesh
    data_group: object   # the ranks at this rank's rays index (the data axis)
    rays_group: object   # the ranks at this rank's data index (the rays axis)

    @property
    def size(self) -> int:
        return self.data * self.rays

    @property
    def coords(self) -> tuple:
        """(data index, rays index) of this rank."""
        return divmod(self.rank, self.rays)


@dataclass(frozen=True)
class ShardingPlan:
    """What JAX's NamedShardings say, as slices of a global batch: images
    over ``data``, patch rows over ``rays``; the rest is replicated."""
    mesh: Mesh

    def batch_block(self, x):
        """This rank's images of a global (N, ...) array."""
        d, _ = self.mesh.coords
        if x.shape[0] % self.mesh.data:
            raise ValueError(f"a batch of {x.shape[0]} images does not split "
                             f"over tpu.mesh.data={self.mesh.data}")
        n = x.shape[0] // self.mesh.data
        return x[d * n:(d + 1) * n]

    def ray_block(self, x):
        """This rank's images and patch rows of a global (N, H, ...) array."""
        _, q = self.mesh.coords
        x = self.batch_block(x)
        h = x.shape[1] // self.mesh.rays
        return x[:, q * h:(q + 1) * h]


def axis_ranks(data: int, rays: int) -> tuple:
    """The ranks along each axis: (data-axis groups, one per rays index;
    rays-axis groups, one per data index)."""
    along_data = [[d * rays + q for d in range(data)] for q in range(rays)]
    along_rays = [[d * rays + q for q in range(rays)] for d in range(data)]
    return along_data, along_rays


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@contextlib.contextmanager
def quiet_unless_main():
    """Silence this process's stdout unless it is rank 0: one rank
    prints."""
    if process_rank() == 0:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


def init_ranks(init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None) -> bool:
    """Join the process group and take this rank's card -> whether a group
    runs. A group already up is kept. Otherwise ``init_method`` with
    ``rank`` and ``world_size`` (a ``file://`` path, as the tests give), or
    torchrun's environment (``env://``); in a process torchrun did not start
    and given no ``init_method``, nothing. A group that cannot start
    raises."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    backend = "gloo"
    if platform_device().type == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    if rank == 0:
        where = ("a card each" if backend == "nccl"
                 else "the CPU or shared cards")
        print(f"Process group: {backend} over {world_size} ranks ({where})",
              flush=True)
    return True


# Process groups live as long as the default group; one mesh per shape and
# default group, since every rank must create every group, in one order.
_meshes: dict = {}


def make_mesh(data: int = 1, rays: int = 1) -> Mesh:
    """The (data, rays) mesh over the running ranks, which must number
    ``data * rays``."""
    n = data * rays
    init_ranks()
    world = process_count()
    if n > world:
        raise ValueError(
            f"tpu.mesh=(data={data}, rays={rays}) needs {n} devices but only "
            f"{world} are visible (one per rank); reduce the mesh or launch "
            f"one rank per device: torchrun --standalone "
            f"--nproc_per_node={n} -m papr_tpu_torch.cli.train --opt <yml>")
    if n < world:
        raise ValueError(f"tpu.mesh=(data={data}, rays={rays}) names {n} "
                         f"devices but {world} ranks run; launch {n}")
    if not dist.is_initialized():
        return Mesh(data, rays, 0, None, None, None)
    key = (data, rays)
    mesh = _meshes.get(key)
    if mesh is None or mesh.world is not dist.group.WORLD:
        along_data, along_rays = axis_ranks(data, rays)
        data_groups = [dist.new_group(r) for r in along_data]
        rays_groups = [dist.new_group(r) for r in along_rays]
        d, q = divmod(dist.get_rank(), rays)
        mesh = Mesh(data, rays, dist.get_rank(), dist.group.WORLD,
                    data_groups[q], rays_groups[d])
        _meshes[key] = mesh
    return mesh


def make_plan(mesh: Mesh) -> ShardingPlan:
    return ShardingPlan(mesh)


def mesh_from_config(cfg) -> Mesh:
    return make_mesh(int(cfg.get_path("tpu.mesh.data", 1)),
                     int(cfg.get_path("tpu.mesh.rays", 1)))
