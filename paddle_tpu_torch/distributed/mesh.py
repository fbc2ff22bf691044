"""Hybrid device mesh — counterpart of ``paddle_tpu/distributed/mesh.py``.

The reference builds ONE ``jax.sharding.Mesh`` with named axes and lets XLA
insert the collectives. The port runs one process per rank, PyTorch's
idiom: the mesh is a grid of the process group's global ranks with the
reference's axis order, and each axis (or tuple of axes) stands for the
process group of the ranks that differ only along it. A collective that
names an axis runs over that group (:mod:`.collective`); an axis of size 1
needs no group and its collectives return their input.

Groups are made once per process, by their members only
(``new_group(..., use_local_synchronization=True)``), the first time a
collective needs them, so a mesh over a subset of the world's ranks runs
on those ranks alone. The backend is the process group's: ``nccl`` for
CUDA tensors and ``gloo`` for CPU tensors (:func:`.init_parallel_env`).
Without an initialized process group the world is this one process
(rank 0 of 1).
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from paddle_tpu_torch.core.device import resolve_device

AXES = ("dp", "fsdp", "pp", "tp", "sp", "ep", "cp")
# the grid's order, outermost to innermost (the reference's Mesh axes)
GRID_AXES = ("dp", "fsdp", "ep", "pp", "tp", "sp", "cp")
DATA_AXES = ("dp", "fsdp", "ep")

_GROUPS: dict = {}      # sorted global ranks -> ProcessGroup (members only)


def world() -> tuple:
    """(rank, world size) of this process: the process group's, or (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def group_of(ranks):
    """The process group over the global ``ranks`` (None for one rank),
    made the first time a member asks for it; the world group when it is
    every rank."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if len(ranks) == 1:
        return None
    rank, size = world()
    if rank not in ranks:
        raise ValueError(f"rank {rank} asked for the group {list(ranks)} "
                         f"it is not a member of")
    if ranks == tuple(range(size)):
        return dist.group.WORLD
    g = _GROUPS.get(ranks)
    if g is None:
        g = dist.new_group(list(ranks), use_local_synchronization=True)
        _GROUPS[ranks] = g
    return g


def _canon(axes) -> tuple:
    """An axis name or tuple of names (None entries dropped) in grid order."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a is not None)
    bad = [a for a in axes if a not in GRID_AXES]
    if bad:
        raise ValueError(f"unknown mesh axes {bad}; the axes are {GRID_AXES}")
    return tuple(a for a in GRID_AXES if a in axes)


class Sharding:
    """A spec over a mesh (one entry per tensor dim: None, an axis name or
    a tuple of names); calling it takes a global tensor to this rank's
    piece of it."""

    def __init__(self, mesh: "HybridMesh", spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __call__(self, x):
        return self.mesh.local(x, self.spec)

    def __repr__(self):
        return f"Sharding({self.spec})"


class HybridMesh:
    """dp × fsdp × ep × pp × tp × sp × cp over the process group's ranks.

    ``ranks`` (or ``devices``, the reference's name): the global ranks of
    the mesh's processes in increasing order, every rank of the world by
    default. ``device``: where this rank computes — the card when none is
    named (raises without one), ``"cpu"`` for the gloo tests. The batch is
    sharded over (dp, fsdp, ep), as the reference's ``batch_spec``.
    """

    def __init__(self, dp: int = 1, fsdp: int = 1, pp: int = 1, tp: int = 1,
                 sp: int = 1, ep: int = 1, cp: int = 1, devices=None,
                 ranks=None, device=None):
        self.device = resolve_device(device)
        rank, size = world()
        ranks = ranks if ranks is not None else devices
        ranks = list(range(size)) if ranks is None else [int(r)
                                                         for r in ranks]
        n = dp * fsdp * ep * pp * tp * sp * cp
        if n != len(ranks):
            raise ValueError(
                f"mesh {dp}x{fsdp}x{ep}x{pp}x{tp}x{sp}x{cp}={n} != "
                f"{len(ranks)} devices")
        if ranks != sorted(set(ranks)) or ranks[-1] >= size:
            raise ValueError(f"mesh ranks {ranks} must be distinct ranks of "
                             f"the world of {size}, in increasing order")
        self.grid = np.asarray(ranks).reshape(dp, fsdp, ep, pp, tp, sp, cp)
        self.dp, self.fsdp, self.pp, self.tp, self.sp = dp, fsdp, pp, tp, sp
        self.ep, self.cp = ep, cp
        self.rank = rank
        where = np.argwhere(self.grid == rank)
        self.coords = (dict(zip(GRID_AXES, (int(i) for i in where[0])))
                       if len(where) else None)

    # -- reference-style queries (HybridCommunicateGroup API) ---------------
    def get_data_parallel_world_size(self):
        return self.dp * self.fsdp

    def get_model_parallel_world_size(self):
        return self.tp

    def get_pipe_parallel_world_size(self):
        return self.pp

    def get_sharding_parallel_world_size(self):
        return self.fsdp

    @property
    def axis_names(self):
        return GRID_AXES

    def size(self, axis) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        return int(np.prod([self.grid.shape[GRID_AXES.index(a)]
                            for a in _canon(axis)], dtype=np.int64))

    def _coords(self):
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh "
                             f"({self.grid.ravel().tolist()})")
        return self.coords

    def index(self, axis) -> int:
        """This rank's index along an axis, row-major (grid order) over a
        tuple of axes."""
        c, i = self._coords(), 0
        for a in _canon(axis):
            i = i * self.grid.shape[GRID_AXES.index(a)] + c[a]
        return i

    def ranks_along(self, axis) -> list:
        """The global ranks that share this rank's coordinates except
        along ``axis``, in index order."""
        c = self._coords()
        sel = tuple(slice(None) if a in _canon(axis) else c[a]
                    for a in GRID_AXES)
        return [int(r) for r in np.asarray(self.grid[sel]).ravel()]

    def peer(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis``, with this rank's
        other coordinates."""
        c = dict(self._coords())
        c[axis] = index
        return int(self.grid[tuple(c[a] for a in GRID_AXES)])

    def group(self, axis):
        """The process group of ``axis`` (a name or tuple) through this
        rank, or None where the axis has size 1."""
        return group_of(self.ranks_along(axis))

    # -- sharding helpers ----------------------------------------------------
    def sharding(self, *spec) -> Sharding:
        return Sharding(self, spec)

    def batch_spec(self) -> tuple:
        return (DATA_AXES,)

    def batch_sharding(self) -> Sharding:
        """This rank's slice of the global batch over (dp, fsdp, ep)."""
        return Sharding(self, self.batch_spec())

    def replicated(self) -> Sharding:
        return Sharding(self, ())

    def local(self, x, spec):
        """This rank's piece of the global tensor ``x`` under ``spec``."""
        for dim, axes in enumerate(spec):
            n = self.size(axes)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {_canon(axes)} ({n})")
            x = x.chunk(n, dim)[self.index(axes)]
        return x

    def gather(self, x, spec):
        """The global tensor whose piece under ``spec`` is ``x`` on every
        rank (an all-gather over each sharded dim's axes)."""
        from paddle_tpu_torch.distributed.collective import gather_dim
        for dim, axes in reversed(list(enumerate(spec))):
            if self.size(axes) > 1:
                x = gather_dim(x, self.group(axes), self.size(axes), dim)
        return x

    # -- context --------------------------------------------------------------
    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.pop()
        return False

    def __repr__(self):
        shape = ", ".join(f"{a}={self.grid.shape[i]}"
                          for i, a in enumerate(GRID_AXES)
                          if self.grid.shape[i] > 1)
        return f"HybridMesh({shape or 'single'}, ranks={self.grid.size})"


_CURRENT: list = []


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


def single_device_mesh(device=None) -> HybridMesh:
    """A mesh of this one rank."""
    return HybridMesh(ranks=[world()[0]], device=device)


def make_mesh(shape: dict, devices=None, device=None) -> HybridMesh:
    """shape e.g. {"dp": 2, "tp": 4}; unspecified axes default 1."""
    kw = {a: int(shape.get(a, 1)) for a in AXES}
    return HybridMesh(**kw, devices=devices, device=device)


def forget_groups():
    """Drop the cached groups (after the world they belong to is gone)."""
    _GROUPS.clear()

