"""Device mesh construction and sharding helpers.

The counterpart of :mod:`plasma_control_tpu.parallel.mesh` on
``torch.distributed``: a mesh is a ``DeviceMesh`` over the ranks of the
process group, one device per rank, with named dimensions:

* ``"rollout"``: the MPC solve's K candidates split over the ranks, each
  scoring its block; only the (K,) costs cross ranks (an all-gather);
* ``"particle"``: the particle arrays split over the ranks for large N; a
  deposit becomes a local partial density and an all-reduce of the (M,)
  vector, and the gather needs only the replicated field.

Where JAX places a global array on the mesh, a rank here holds tensors of
its own: :func:`shard_batch` takes this rank's block of a full tensor that
every rank holds alike, and :func:`replicate` makes every rank hold its
mesh's first rank's values. With no process group, :func:`make_mesh` starts
a one-process group in memory, so a mesh of one rank runs anywhere, as a
one-device JAX mesh does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_map

__all__ = ["make_mesh", "shard_batch", "replicate", "DeviceMesh"]


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("rollout",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over every rank of the process group.

    Default: all ranks along the first named dimension, size 1 along the
    others. Pass ``axis_names=("rollout", "particle")`` with ``axis_sizes``
    for a 2D mesh."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(axis_names) - 1)
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def shard_batch(tree, mesh: DeviceMesh, axis: str = "rollout"):
    """This rank's block of the leading axis of every tensor leaf, split
    evenly over ``axis``."""
    n_ranks, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)

    def block(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n_ranks:
            raise ValueError(f"leading axis of {x.shape[0]} does not divide evenly over the "
                             f"{axis!r} mesh axis ({n_ranks} ranks)")
        size = x.shape[0] // n_ranks
        return x[rank * size:(rank + 1) * size]

    return tree_map(block, tree)


def replicate(tree, mesh: DeviceMesh):
    """Copies of every tensor leaf holding the values of the mesh's first
    rank, on every rank (a broadcast along each dimension in turn)."""

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        for dim in range(mesh.ndim):
            group = mesh.get_group(dim)
            dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
        return x

    return tree_map(bcast, tree)
