"""Collective ops — counterpart of ``paddle_tpu/distributed/collective.py``.

The reference's collectives are lax primitives bound to a mesh axis inside
``shard_map``. Here each rank runs its own program, and a collective that
names ``axis_name`` (an axis of the active :class:`~.mesh.HybridMesh`, or
of ``mesh=``, or a tuple of axes) runs over that axis's process group
through ``torch.distributed``: every member of the group must call it, in
the same order. Over an axis of size 1 a collective returns its input.

Gradients. ``all_reduce`` (sum), ``all_gather``, ``reduce_scatter``,
``all_to_all`` and ``permute`` / ``shift`` are differentiable with the
transposes of the SPMD program whose objective is the sum of the ranks'
objectives: all_reduce <-> all_reduce, all_gather <-> reduce_scatter,
all_to_all <-> the inverse all_to_all, permute <-> the inverse pattern. The tensor-parallel layers use the Megatron pair instead
(:func:`copy_to_group`: identity forward, all-reduce backward;
:func:`reduce_from_group`: all-reduce forward, identity backward), whose
backward assumes what follows is computed alike on every member; and FSDP
gathers its parameters through :func:`fsdp_gather` (all-gather forward,
reduce-scatter backward).

Every call counts itself in ``collective_ops_total`` and its payload bytes
in ``collective_bytes_total`` (labelled by op): the port runs eagerly, so
these count calls, where the reference counts traced ops.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed.mesh import current_mesh
from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.utils.faults import fault_point

_COLL_OPS = METRICS.counter(
    "collective_ops_total", "collective ops called, by op kind",
    labelnames=("op",))
_COLL_BYTES = METRICS.counter(
    "collective_bytes_total",
    "per-member payload bytes of collective ops", labelnames=("op",))


def _count(op: str, x):
    _COLL_OPS.inc(op=op)
    if isinstance(x, torch.Tensor):
        _COLL_BYTES.inc(x.numel() * x.element_size(), op=op)


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _axis(axis_name, mesh=None):
    """(mesh, process group or None, size, this rank's index) of an axis."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"collective over axis {axis_name!r}: no mesh is "
                         f"active (enter a HybridMesh or pass mesh=)")
    n = mesh.size(axis_name)
    if n == 1:
        return mesh, None, 1, 0
    return mesh, mesh.group(axis_name), n, mesh.index(axis_name)


# -- group-level primitives --------------------------------------------------

def _sum(x, group):
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _gather_list(x, group, n):
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def gather_dim(x, group, n, dim):
    """Concatenate the members' ``x`` along ``dim``, in member order (no
    gradient)."""
    if n == 1:
        return x
    return torch.cat(_gather_list(x, group, n), dim=dim)


def _scatter_sum(x, group, n, dim):
    """Sum over the members, this member's chunk of ``dim``."""
    dim = dim % x.dim()
    parts = [c.contiguous() for c in x.detach().chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return out


def _a2a(x, group, n, split, concat):
    split, concat = split % x.dim(), concat % x.dim()
    inp = torch.stack(x.detach().chunk(n, split)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return torch.cat(out.unbind(0), dim=concat)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return torch.cat(_gather_list(x, group, n), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter_sum(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (torch.cat(_gather_list(g, ctx.group, ctx.n), dim=ctx.dim),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split, concat):
        ctx.args = (group, n, split, concat)
        return _a2a(x, group, n, split, concat)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return _a2a(g, group, n, concat, split), None, None, None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """Concatenate the members' last dims; the gradient keeps this
    member's slice (what follows is computed alike on every member)."""

    @staticmethod
    def forward(ctx, x, group, n, idx):
        ctx.n, ctx.idx = n, idx
        return torch.cat(_gather_list(x, group, n), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, -1)[ctx.idx].contiguous(), None, None, None


class _SplitLast(torch.autograd.Function):
    """This member's slice of the last dim; the gradient is gathered."""

    @staticmethod
    def forward(ctx, x, group, n, idx):
        ctx.group, ctx.n = group, n
        return x.chunk(n, -1)[idx].contiguous()

    @staticmethod
    def backward(ctx, g):
        return (torch.cat(_gather_list(g, ctx.group, ctx.n), dim=-1), None,
                None, None)


def split_last(x, group, n, idx):
    if group is None:
        return x
    _count("split_last", x)
    return _SplitLast.apply(x, group, n, idx)


def copy_to_group(x, group):
    if group is None:
        return x
    _count("copy_to_group", x)
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    if group is None:
        return x
    _count("reduce_from_group", x)
    return _ReduceFromGroup.apply(x, group)


def gather_last(x, group, n, idx):
    if group is None:
        return x
    _count("gather_last", x)
    return _GatherLast.apply(x, group, n, idx)


def fsdp_gather(x, group, n, dim):
    """A parameter's FSDP shards gathered along ``dim``; the gradient is
    reduce-scattered back (summed over the members' batches)."""
    if group is None:
        return x
    _count("fsdp_gather", x)
    return _AllGather.apply(x, group, n, dim)


def all_reduce_(tensors, group, scale=None):
    """Sum a list of same-dtype tensors over ``group`` in place through one
    flat buffer, then multiply by ``scale`` (no gradient)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    if group is not None:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _count("all_reduce", flat)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    if scale is not None and scale != 1:
        torch._foreach_mul_(tensors, scale)


# -- the reference's API -----------------------------------------------------

def all_reduce(x, op: str = ReduceOp.SUM, *, axis_name, mesh=None):
    fault_point("collective.all_reduce", op=op, axis_name=axis_name)
    _count("all_reduce", x)
    _, group, n, _ = _axis(axis_name, mesh)
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN, ReduceOp.AVG,
                  ReduceOp.PROD):
        raise ValueError(op)
    if n == 1:
        return x
    if op == ReduceOp.SUM:
        return _AllReduceSum.apply(x, group)
    if op == ReduceOp.AVG:
        return _AllReduceSum.apply(x, group) / n
    if op == ReduceOp.PROD:
        return torch.exp(_AllReduceSum.apply(torch.log(x), group))
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == ReduceOp.MAX
                             else dist.ReduceOp.MIN), group=group)
    return out


def all_gather(x, *, axis_name, axis: int = 0, tiled: bool = True,
               mesh=None):
    _count("all_gather", x)
    _, group, n, _ = _axis(axis_name, mesh)
    if not tiled:
        x = x.unsqueeze(axis)
    return x if n == 1 else _AllGather.apply(x, group, n, axis)


def reduce_scatter(x, *, axis_name, axis: int = 0, mesh=None):
    _count("reduce_scatter", x)
    _, group, n, _ = _axis(axis_name, mesh)
    return x if n == 1 else _ReduceScatter.apply(x, group, n, axis)


def all_to_all(x, *, axis_name, split_axis: int, concat_axis: int,
               mesh=None):
    _count("all_to_all", x)
    _, group, n, _ = _axis(axis_name, mesh)
    return x if n == 1 else _AllToAll.apply(x, group, n, split_axis,
                                            concat_axis)


def broadcast(x, src: int = 0, *, axis_name, mesh=None):
    """Every member gets member ``src``'s value."""
    _count("broadcast", x)
    m, group, n, _ = _axis(axis_name, mesh)
    if n == 1:
        return x
    out = x.detach().clone().contiguous()
    dist.broadcast(out, src=m.ranks_along(axis_name)[src], group=group)
    return out


def _exchange(x, perm, group, ranks, me):
    """One ``batch_isend_irecv`` of the pattern ``perm`` over the members
    ``ranks`` (global ranks, in member order) of ``group``: what member
    ``me`` receives, zeros where it receives nothing."""
    out = torch.zeros_like(x)
    ops = []
    x = x.detach().contiguous()
    for src, dst in perm:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    for w in (dist.batch_isend_irecv(ops) if ops else []):
        w.wait()
    return out


class _Permute(torch.autograd.Function):
    """The exchange forward; the cotangent goes back along the inverse
    pattern (``lax.ppermute``'s transpose), so a ring's backward is the
    reverse ring."""

    @staticmethod
    def forward(ctx, x, perm, group, ranks, me):
        ctx.args = ([(d, s) for s, d in perm], group, ranks, me)
        return _exchange(x, perm, group, ranks, me)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None, None


def permute(x, perm, *, axis_name, mesh=None):
    """Point-to-point pattern ``perm = [(src, dst), ...]`` over the axis's
    member indices: member dst receives member src's value; a member that
    receives nothing gets zeros, as ``lax.ppermute`` gives. One
    ``batch_isend_irecv`` over the axis's group; differentiable, the
    gradient sent back along the inverse pattern."""
    _count("permute", x)
    perm = [tuple(int(i) for i in p) for p in perm]
    m, group, n, me = _axis(axis_name, mesh)
    if n == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, perm, group, m.ranks_along(axis_name), me)


def shift(x, offset: int = 1, *, axis_name, mesh=None):
    """Ring shift: member i's value goes to member (i + offset) % n."""
    n = _axis(axis_name, mesh)[2]
    return permute(x, [(i, (i + offset) % n) for i in range(n)],
                   axis_name=axis_name, mesh=mesh)


def axis_index(axis_name, mesh=None) -> int:
    return _axis(axis_name, mesh)[3]


def barrier(*, axis_name, mesh=None):
    """A sum of zeros over the axis: returns once every member reached it."""
    m = _axis(axis_name, mesh)[0]
    return all_reduce(torch.zeros((), dtype=torch.float32, device=m.device),
                      axis_name=axis_name, mesh=m)


def reduce(x, dst: int = 0, op: str = ReduceOp.SUM, *, axis_name,
           mesh=None):
    """The reduction on member ``dst``; the others keep their input (the
    reference's all-reduce + select)."""
    red = all_reduce(x, op, axis_name=axis_name, mesh=mesh)
    return red if axis_index(axis_name, mesh) == dst else x


def scatter(x, src: int = 0, *, axis_name, mesh=None):
    """Member ``src``'s value split over the axis: member i gets the i-th
    chunk of its leading dim."""
    full = broadcast(x, src, axis_name=axis_name, mesh=mesh)
    _, _, n, i = _axis(axis_name, mesh)
    if full.shape[0] % n != 0:
        raise ValueError(
            f"scatter: leading dim {full.shape[0]} must divide evenly over "
            f"{n} members (reference scatter requires an exact split)")
    chunk = full.shape[0] // n
    return full[i * chunk:(i + 1) * chunk]


def gather(x, dst: int = 0, *, axis_name, axis: int = 0, mesh=None):
    """Every member's value concatenated, on every member."""
    return all_gather(x, axis_name=axis_name, axis=axis, mesh=mesh)


def _p2p_edge(x, src, dst, axis_name, mesh):
    m, _, n, me = _axis(axis_name, mesh)
    if n == 1 or me not in (src, dst) or src == dst:
        return x
    _count("send_recv", x)
    peer = m.ranks_along(axis_name)[dst if me == src else src]
    if me == src:
        dist.send(x.detach().contiguous(), peer)
        return x
    out = torch.empty_like(x)
    dist.recv(out, peer)
    return out


def send(x, dst: int, *, src: int, axis_name, mesh=None):
    """Member ``dst`` receives member ``src``'s value; every other member
    keeps its input. Every member of the axis calls it with the same
    (static) endpoints, as in the reference."""
    return _p2p_edge(x, src, dst, axis_name, mesh)


def recv(x, src: int, *, dst: int, axis_name, mesh=None):
    """P2P receive — see :func:`send`."""
    return _p2p_edge(x, src, dst, axis_name, mesh)


def all_gather_object(obj, group=None):
    """Every process's picklable ``obj``, in rank order (``group``: a
    :class:`paddle_tpu_torch.distributed.Group`, the world by default).
    A single process returns ``[obj]``."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    pg = getattr(group, "pg", group)
    n = dist.get_world_size(pg) if pg is not None else dist.get_world_size()
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    return out

