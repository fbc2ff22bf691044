"""Auto-parallel annotations — counterpart of
``paddle_tpu/distributed/auto_parallel.py`` (ref: Paddle's
``distributed/auto_parallel/``: ``shard_tensor``, ``ProcessMesh``,
``Shard`` / ``Replicate`` placements).

In the reference an annotation places a global array on the mesh. Here
each rank runs its own program, so placing a global tensor gives this
rank's piece of it: ``Shard(dim)`` over a mesh dim keeps this rank's chunk
of ``dim``, ``Replicate`` keeps it whole. ``Partial`` (pending partial
sums) has no global form in either: it is treated as ``Replicate`` with a
warning, as the reference does.
"""
from __future__ import annotations

import warnings

import numpy as np

from paddle_tpu_torch.distributed.mesh import world


class ProcessMesh:
    """Ref ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"]): a grid of
    the process group's ranks."""

    def __init__(self, mesh, dim_names=None):
        self.ranks = np.asarray(mesh)
        self.dim_names = tuple(dim_names or [f"d{i}"
                                             for i in range(self.ranks.ndim)])

    @property
    def shape(self):
        return tuple(self.ranks.shape)

    def coords(self) -> tuple:
        """This rank's coordinates in the grid."""
        where = np.argwhere(self.ranks == world()[0])
        if not len(where):
            raise ValueError(f"rank {world()[0]} is not in the process mesh "
                             f"{self.ranks.tolist()}")
        return tuple(int(i) for i in where[0])


class Placement:
    pass


class Shard(Placement):
    """Shard(dim): tensor dim ``dim`` split over the corresponding mesh dim."""

    def __init__(self, dim: int):
        self.dim = dim


class Replicate(Placement):
    pass


class Partial(Placement):
    """Pending-reduction placement: treated as Replicate, with a warning."""


def _local(x, mesh: ProcessMesh, placements):
    coords = None
    for mesh_dim, placement in enumerate(placements):
        if isinstance(placement, Partial):
            warnings.warn(
                "Partial placement has no global representation; treating "
                "as Replicate. Sum the partial values over the mesh dim "
                "with distributed.all_reduce instead", stacklevel=3)
        elif isinstance(placement, Shard):
            coords = coords or mesh.coords()
            x = x.chunk(mesh.shape[mesh_dim], placement.dim)[coords[mesh_dim]]
    return x


def shard_tensor(x, mesh: ProcessMesh, placements):
    """Ref dist.shard_tensor: this rank's piece of the global ``x``."""
    return _local(x, mesh, placements)


def reshard(x, mesh: ProcessMesh, placements):
    return shard_tensor(x, mesh, placements)


def shard_op(fn, mesh: ProcessMesh, in_placements=None, out_placements=None):
    """Ref dist.shard_op: ``fn``, its (global) output placed per
    ``out_placements``."""
    def wrapped(*args):
        out = fn(*args)
        if out_placements is not None:
            out = _local(out, mesh, out_placements)
        return out
    return wrapped
