"""Device meshes over an initialized torch.distributed process group (port
of vins_tpu/parallel/mesh.py).

Axes:
  * `batch` — independent VIO streams, split over ranks (no collective);
  * `block` — the landmark-block partition of the distributed bundle
    adjustment, whose reduced camera system is summed with all_reduce.

Where the JAX module places shards with device_put and a NamedSharding,
every rank here runs the same program on its own slice (SPMD):
shard_leading returns this rank's slice of each leaf's leading axis.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

BATCH_AXIS = "batch"
BLOCK_AXIS = "block"


def make_mesh(batch: int = 0, block: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (batch, block) DeviceMesh over the initialized default process
    group; batch=0 means world size // block. The product must equal the
    world size. Raises RuntimeError without a process group (it never
    makes up a world of one)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process "
            "group (init_process_group with its address, world size and "
            "rank)")
    n = dist.get_world_size()
    if batch == 0:
        if n % block:
            raise ValueError(f"{n} ranks not divisible by block={block}")
        batch = n // block
    if batch * block != n:
        raise ValueError(f"mesh {batch}x{block} does not cover the {n} "
                         "ranks of the world")
    return DeviceMesh(device_type, torch.arange(n).reshape(batch, block),
                      mesh_dim_names=(BATCH_AXIS, BLOCK_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def shard_leading(tree, mesh: DeviceMesh, axis: str):
    """This rank's slice of every tensor leaf's leading axis, split evenly
    over the mesh axis `axis` (the leading size must divide by it)."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)

    def take(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(f"leading size {x.shape[0]} does not divide "
                             f"by the {n} shards of axis {axis!r}")
        c = x.shape[0] // n
        return x[i * c:(i + 1) * c]

    return tree_map(take, tree)
