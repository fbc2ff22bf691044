"""``paddle_tpu/distributed`` on ``torch.distributed`` — one process per
rank, PyTorch's idiom, where the reference runs one SPMD program.

* :mod:`.mesh` — ``HybridMesh``: the reference's named axes over the
  process group's ranks, each axis a process group.
* :mod:`.collective` — the collectives over a mesh axis, counted in the
  observability registry.
* :mod:`.sharded` — ``shard_module``: the reference's partition rule made
  real (tp slices, FSDP chunks gathered at use), global ``state_dict()``.
* :mod:`.tensor_parallel` — column / row / vocab-parallel layers and the
  vocab-parallel cross-entropy.
* :mod:`.pipeline` — the 1F1B and zero-bubble schedules with
  point-to-point send/recv.
* :mod:`.ring_attention`, :mod:`.ulysses`, :mod:`.sp` — sequence
  parallelism over the sp axis: the ring (and its zigzag layout) rotating
  KV blocks, Ulysses re-sharding sequence to heads, the models' dispatch.
* :mod:`.moe` — the MoE layer: routing over the global batch under data
  axes, expert parallelism over the ep axis (all_to_all dispatch).
* :mod:`.fleet`, :mod:`.auto_parallel`, :mod:`.launch` — the reference's
  facades.

The backend is ``nccl`` for the card and ``gloo`` for the CPU
(:func:`init_parallel_env`); ``get_backend`` names it where the
reference says ``"xla"``.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed import collective  # noqa: F401
from paddle_tpu_torch.distributed.collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    gather,
    permute,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    shift,
)
from paddle_tpu_torch.distributed.mesh import (  # noqa: F401
    AXES,
    HybridMesh,
    current_mesh,
    group_of,
    make_mesh,
    single_device_mesh,
    world,
)
from paddle_tpu_torch.distributed.sharded import (  # noqa: F401
    maybe_shard,
    opt_state_specs,
    partition_specs,
    shard_module,
    with_sharding_constraint,
)
from paddle_tpu_torch.distributed.ring_attention import (  # noqa: F401
    make_ring_attention,
    make_zigzag_ring_attention,
    ring_attention,
    zigzag_inverse_permutation,
    zigzag_permutation,
    zigzag_ring_attention,
)
from paddle_tpu_torch.distributed.ulysses import (  # noqa: F401
    make_ulysses_attention,
    ulysses_attention,
)
from paddle_tpu_torch.distributed.tensor_parallel import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    parallel_cross_entropy,
)


def _env_world():
    """(init_method, world size, rank) from the env, or None: the
    reference's COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, else
    torchrun's WORLD_SIZE / RANK (MASTER_ADDR / MASTER_PORT)."""
    env = os.environ
    if "NUM_PROCESSES" in env or "COORDINATOR_ADDRESS" in env:
        coord = env.get("COORDINATOR_ADDRESS")
        if coord is None:
            raise RuntimeError("NUM_PROCESSES is set without "
                               "COORDINATOR_ADDRESS")
        method = coord if "://" in coord else f"tcp://{coord}"
        return (method, int(env.get("NUM_PROCESSES", "1")),
                int(env.get("PROCESS_ID", "0")))
    if "WORLD_SIZE" in env and "RANK" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def init_parallel_env(backend=None, init_method=None, world_size=None,
                      rank=None, device=None, timeout=None):
    """Join the process group (ref ``paddle.distributed.init_parallel_env``).

    ``device``: this rank's device, the card when none is named (raises
    without one; bound to ``cuda:LOCAL_RANK``), ``"cpu"`` for gloo. The
    world comes from the arguments (``init_method`` e.g.
    ``"file:///tmp/store"``, ``world_size``, ``rank``) or the env (see
    :mod:`.launch`); with neither, one process needs no group and this
    returns False. A failed rendezvous raises. Returns True once the group
    is up (at once when it already was)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return True
    if init_method is None:
        found = _env_world()
        if found is None:
            return False
        init_method, env_world, env_rank = found
        world_size = env_world if world_size is None else world_size
        rank = env_rank if rank is None else rank
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    kw = {}
    if timeout is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                        else "gloo"),
                            init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    return True


def get_world_size():
    return world()[1]


def get_rank():
    return world()[0]


def recompute(fn, *args, **kwargs):
    """Ref ``fleet.utils.recompute``: ``fn``'s activations recomputed in
    the backward (non-reentrant ``torch.utils.checkpoint``)."""
    from torch.utils.checkpoint import checkpoint
    preserve = kwargs.pop("preserve_rng_state", True)
    return checkpoint(lambda *a: fn(*a, **kwargs), *args,
                      use_reentrant=False, preserve_rng_state=preserve)


# -- the reference's communication API ----------------------------------------

from paddle_tpu_torch.distributed import fleet, launch  # noqa: E402,F401

alltoall = all_to_all


def alltoall_single(x, *, axis_name, mesh=None):
    """Equal splits of the leading dim exchanged over the axis."""
    return all_to_all(x, axis_name=axis_name, split_axis=0, concat_axis=0,
                      mesh=mesh)


# the reference's isend / irecv are its static-edge send / recv
isend = send
irecv = recv


def wait(tensor, group=None, use_calc_stream=True):
    """Ref communication/wait: synchronise the tensor's stream (a CUDA
    tensor's current stream; nothing to wait for on the CPU)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class Group:
    """Process-group handle (ref collective.Group): its global ``ranks``,
    the ``axis_name`` it stands for, and ``pg``, the torch process group
    (None on a non-member, or for one rank)."""

    def __init__(self, ranks, axis_name=None, id=0, pg=None):
        self.ranks = list(ranks)
        self.axis_name = axis_name
        self.id = id
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    def __repr__(self):
        return f"Group(ranks={self.ranks}, axis_name={self.axis_name!r})"


_groups: dict = {}
_next_group_id = [0]


def new_group(ranks=None, backend=None, axis_name=None):
    """Ref new_group: a group over ``ranks`` (every rank by default). Its
    members make the process group (the others need not call)."""
    rank, size = world()
    ranks = list(range(size)) if ranks is None else list(ranks)
    bad = [r for r in ranks if not 0 <= r < size]
    if bad and dist.is_initialized():
        raise ValueError(f"ranks {bad} are outside the world of {size}")
    pg = (group_of(ranks) if dist.is_initialized() and rank in ranks
          else None)
    g = Group(ranks, axis_name=axis_name or "dp", id=_next_group_id[0],
              pg=pg)
    _next_group_id[0] += 1
    _groups[g.id] = g
    return g


def get_group(gid=0):
    return _groups.get(gid)


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_backend(group=None):
    """The real backend, "nccl" or "gloo" (None with no process group)."""
    if not is_initialized():
        return None
    pg = getattr(group, "pg", group)
    return dist.get_backend(pg) if pg is not None else dist.get_backend()


def destroy_process_group(group=None):
    """Forget ``group``'s handle (every handle when None). The process
    groups themselves stay cached for reuse while the world lives."""
    if group is None:
        _groups.clear()
    else:
        _groups.pop(getattr(group, "id", group), None)


class ParallelEnv:
    """Ref parallel.ParallelEnv: this process's place in the world."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        return torch.cuda.current_device() if torch.cuda.is_available() else 0

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return int(os.environ.get("LOCAL_RANK", self.rank))


class DataParallel:
    """Ref ``paddle.DataParallel``: forwards to the module and its
    attributes. The gradient average over the data axes is the mesh train
    step's (``train.make_train_step(..., mesh=HybridMesh(dp=N))``)."""

    def __init__(self, layers, **kwargs):
        self._layers = layers

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        if name == "_layers":
            raise AttributeError(name)
        return getattr(self._layers, name)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)


_split_layers: dict = {}


def split(x, size, operation="linear", axis=0, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Ref ``paddle.distributed.split``: build a tensor-parallel linear
    (``axis=1`` column-, else row-parallel) or embedding on ``x``'s device,
    sharded over the active mesh's tp, and apply it. ``name=`` keeps the
    layer for later calls (:func:`get_split_layer`)."""
    layer = _split_layers.get(name) if name is not None else None
    if layer is None:
        mesh = current_mesh()
        kw = dict(device=x.device, mesh=mesh)
        if operation == "linear":
            layer = (ColumnParallelLinear(size[0], size[1],
                                          gather_output=gather_out, **kw)
                     if axis == 1 else RowParallelLinear(
                         size[0], size[1], input_is_parallel=False, **kw))
        elif operation == "embedding":
            layer = VocabParallelEmbedding(size[0], size[1], **kw)
        else:
            raise ValueError(f"unsupported split operation {operation!r}")
        if name is not None:
            _split_layers[name] = layer
    return layer(x)


def get_split_layer(name_or_key):
    return _split_layers.get(name_or_key)


def _spawn_entry(i, nprocs, init_method, func, args):
    os.environ.update(COORDINATOR_ADDRESS=init_method,
                      NUM_PROCESSES=str(nprocs), PROCESS_ID=str(i),
                      LOCAL_RANK=str(i))
    func(*args)


def spawn(func, args=(), nprocs=1, init_method=None, timeout=None,
          **kwargs):
    """Ref ``paddle.distributed.spawn``: run ``func(*args)`` in ``nprocs``
    new processes (``torch.multiprocessing``, start method spawn), each
    with the env of one rank of a world that rendezvouses through a
    FileStore (``init_method``, a fresh temporary file by default), so
    ``init_parallel_env()`` in ``func`` joins it. One process runs ``func``
    here. A failing process fails the call; past ``timeout`` seconds every
    process is killed and TimeoutError raised."""
    if nprocs == 1:
        return func(*args)
    import tempfile
    import time

    import torch.multiprocessing as mp
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="pt_spawn_")
        init_method = f"file://{os.path.join(tmp, 'store')}"
    ctx = mp.start_processes(_spawn_entry, args=(nprocs, init_method, func,
                                                 tuple(args)),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=None if deadline is None else
                           max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"spawn: {nprocs} processes still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        if tmp is not None:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
