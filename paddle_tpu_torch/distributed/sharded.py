"""Parameter sharding, ZeRO-3 / FSDP and tensor parallelism — counterpart
of ``paddle_tpu/distributed/sharded.py``.

The reference assigns every leaf a PartitionSpec and lets XLA keep it
sharded. The port applies the same rule (:func:`partition_specs`: a
layer's explicit tp spec first, then fsdp on the largest divisible dim
of a leaf of at least ``min_size`` elements) and makes it real in each
rank's process (:func:`shard_module`):

* a **tp** dim keeps this rank's slice. Where the owning layer fuses
  projections that a contiguous slice would split wrongly (Llama's
  ``[Q|K|V]`` and ``[gate|up]`` columns), the layer's ``tp_perm``
  interleaves the columns first, so every rank holds ``[q_i|k_i|v_i]`` /
  ``[g_i|u_i]``. The owner is marked (``_pt_tp``: group, size, index) and
  its forward runs the Megatron collectives around its local products.
* an **fsdp** dim (stage 3) keeps this rank's chunk as the parameter; a
  parametrization all-gathers it at every use and reduce-scatters its
  gradient (:func:`~.collective.fsdp_gather`).

``state_dict()`` of a sharded model gives the global arrays under the
reference's names and ``[in, out]`` layout (each leaf gathered, the tp
interleave undone), so checkpoints and ``models/convert.py`` see one
layout. Load weights before sharding. Inside :func:`data_parallel` a
loss's masked mean counts the labels of the global batch, and
:func:`sync_grads` averages the gradients over the data axes after a
backward (the train step's all-reduce); :func:`sharded_leaves` tells the
optimizer's global norm which gradients are pieces of a larger one.

Stages 1 and 2 shard no parameter; their optimizer slots stay whole on
each rank (the reference shards the slots: no ZeRO-1/2 memory saving
here yet). ``with_sharding_constraint`` and ``maybe_shard`` return their
input: a rank's tensors already are its shards.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn.utils import parametrize

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.mesh import DATA_AXES, HybridMesh
from paddle_tpu_torch.nn.functional import MEAN_DENOMINATOR


class TpInfo(NamedTuple):
    """What a tensor-parallel layer needs: its group, size and index."""
    group: object
    size: int
    index: int


class ShardInfo(NamedTuple):
    """How a local parameter relates to its global array."""
    spec: tuple                 # per dim: None, "tp" or "fsdp"
    perm: Optional[torch.Tensor]  # the tp interleave of the tp dim
    fsdp_dim: Optional[int]     # the dim an FSDP parametrization gathers


def set_pspec(module: nn.Module, name: str, spec):
    """Declare the reference's PartitionSpec of ``module.<name>``."""
    module.__dict__.setdefault("_pt_pspecs", {})[name] = tuple(spec)


def pspec(module: nn.Module, name: str):
    return module.__dict__.get("_pt_pspecs", {}).get(name)


def _leaves(module: nn.Module):
    """(canonical dotted name, owner module, leaf name, local parameter)
    of every parameter, through FSDP parametrizations."""
    out = []
    for mname, m in module.named_modules():
        if isinstance(m, parametrize.ParametrizationList):
            continue
        local = dict(m.named_parameters(recurse=False))
        plist = getattr(m, "parametrizations", None)
        if plist is not None:
            for leaf, pl in plist.items():
                local[leaf] = pl.original
        for leaf, p in local.items():
            name = f"{mname}.{leaf}" if mname else leaf
            out.append((name, m, leaf, p))
    return out


def _pspec_of_leaf(owner, leaf: str, shape, min_size: int,
                   fsdp_size: int) -> tuple:
    """Honour the owner's explicit tp spec, then shard the largest
    divisible dim over fsdp (the reference's rule)."""
    explicit = pspec(owner, leaf)
    spec = list(explicit) if explicit is not None else [None] * len(shape)
    while len(spec) < len(shape):
        spec.append(None)
    used = {a for s in spec for a in (s if isinstance(s, tuple) else (s,))
            if a is not None}
    numel = 1
    for d in shape:
        numel *= d
    if numel >= min_size and "fsdp" not in used:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % max(fsdp_size, 1) == 0:
                spec[i] = "fsdp"
                break
    return tuple(spec)


def partition_specs(module: nn.Module, stage: int = 3,
                    min_size: int = 2 ** 16, fsdp_size: int = 1) -> dict:
    """{parameter name: spec} (params get fsdp + tp specs at stage 3,
    their explicit tp specs alone below)."""
    specs = {}
    for name, owner, leaf, p in _leaves(module):
        if stage >= 3:
            specs[name] = _pspec_of_leaf(owner, leaf, tuple(p.shape),
                                         min_size, fsdp_size)
        else:
            specs[name] = pspec(owner, leaf) or ()
    return specs


def opt_state_specs(opt_state: dict, param_specs: dict) -> dict:
    """Optimizer slots mirror the parameters' specs; scalars replicated."""
    out = {}
    for k, v in opt_state.items():
        if isinstance(v, dict):
            out[k] = {n: (param_specs.get(n) if t is not None else None)
                      for n, t in v.items()}
        else:
            out[k] = ()
    return out


class _FsdpGather(nn.Module):
    """Parametrization: the local FSDP chunk -> the gathered parameter."""

    def __init__(self, group, n: int, dim: int):
        super().__init__()
        self.group, self.n, self.dim = group, n, dim

    def forward(self, x):
        return C.fsdp_gather(x, self.group, self.n, self.dim)


def shard_module(module: nn.Module, mesh: HybridMesh, stage: int = 3,
                 min_size: int = 2 ** 16) -> nn.Module:
    """Replace every parameter by this rank's piece of it under the
    stage-3 rule (ZeRO-3 resident layout), in place. Call once, after the
    weights are loaded."""
    if getattr(module, "_pt_mesh", None) is not None:
        raise ValueError("shard_module: the module is already sharded")
    specs = partition_specs(module, stage=stage, min_size=min_size,
                            fsdp_size=mesh.fsdp)
    tp = mesh.size("tp")
    for m in module.modules():
        if hasattr(m, "shard_check"):
            m.shard_check(mesh)
    owners = {id(o): o for _, o, leaf, _ in _leaves(module)
              if "tp" in (pspec(o, leaf) or ())}
    for name, owner, leaf, p in _leaves(module):
        spec = specs[name]
        x, perm, fsdp_dim = p.detach(), None, None
        for dim, ax in enumerate(spec):
            if ax == "tp" and tp > 1:
                if x.shape[dim] % tp:
                    raise ValueError(f"{name}: dim {dim} of "
                                     f"{tuple(x.shape)} does not divide "
                                     f"over tp={tp}")
                if hasattr(owner, "tp_perm"):
                    perm = owner.tp_perm(leaf, tp)
                if perm is not None:
                    perm = torch.as_tensor(perm, device=x.device)
                    x = x.index_select(dim, perm)
                x = x.chunk(tp, dim)[mesh.index("tp")]
            elif ax == "fsdp" and mesh.fsdp > 1 and stage >= 3:
                x = x.chunk(mesh.fsdp, dim)[mesh.index("fsdp")]
                fsdp_dim = dim
        new = nn.Parameter(x.clone(), requires_grad=p.requires_grad)
        setattr(owner, leaf, new)
        if fsdp_dim is not None:
            parametrize.register_parametrization(
                owner, leaf, _FsdpGather(mesh.group("fsdp"), mesh.fsdp,
                                         fsdp_dim), unsafe=True)
            new = owner.parametrizations[leaf].original
        new._pt_shard = ShardInfo(spec, perm, fsdp_dim)
        axes = tuple(a for a in spec if a is not None and mesh.size(a) > 1
                     and (a != "fsdp" or fsdp_dim is not None))
        if axes:
            new._pt_norm = (axes, mesh.group(axes))
    if tp > 1:
        for o in owners.values():
            o._pt_tp = TpInfo(mesh.group("tp"), tp, mesh.index("tp"))
    module._pt_mesh = mesh
    module._register_state_dict_hook(_global_state_dict)
    return module


def _global(x, info: Optional[ShardInfo], mesh: HybridMesh) -> torch.Tensor:
    """The global array of a local piece ``x`` (a parameter or its
    gradient) sharded as ``info`` says."""
    x = x.detach()
    if info is None:
        return x
    if info.fsdp_dim is not None:
        x = C.gather_dim(x, mesh.group("fsdp"), mesh.fsdp, info.fsdp_dim)
    for dim, ax in enumerate(info.spec):
        if ax == "tp" and mesh.size("tp") > 1:
            x = C.gather_dim(x, mesh.group("tp"), mesh.size("tp"), dim)
            if info.perm is not None:
                x = x.index_select(dim, torch.argsort(info.perm))
    return x


def _global_state_dict(module, state_dict, prefix, local_metadata):
    """state_dict hook: the global arrays under the canonical names."""
    mesh = module._pt_mesh
    leaves = {prefix + name: p for name, _, _, p in _leaves(module)}
    out = type(state_dict)()
    for key, v in state_dict.items():
        name = key.replace(".parametrizations.", ".").replace(
            "parametrizations.", "")
        if name.endswith(".original"):
            name = name[:-len(".original")]
        p = leaves.get(name)
        out[name] = (_global(p, getattr(p, "_pt_shard", None), mesh)
                     if p is not None else v)
    return out


def global_grads(module: nn.Module) -> dict:
    """{name: the global gradient} of a module :func:`shard_module`
    sharded, as its ``state_dict()`` gives the global parameters (a
    collective over the shard axes: every rank calls it)."""
    mesh = module._pt_mesh
    return {name: _global(p.grad, getattr(p, "_pt_shard", None), mesh)
            for name, _, _, p in _leaves(module) if p.grad is not None}


def sharded_leaves(params: dict) -> dict:
    """{name: (axes, group)} of the parameters that are pieces of a larger
    array: their squares sum over ``group`` for a global norm."""
    return {n: p._pt_norm for n, p in params.items()
            if getattr(p, "_pt_norm", None) is not None}


def sync_grads(module: nn.Module, mesh: HybridMesh, grads=None):
    """Average the gradients over the data axes (dp, fsdp, ep) after a
    backward, in place: the parameters' ``.grad``s, or ``grads`` ({name of
    ``module.named_parameters()``: tensor}). One flat all-reduce a group
    and dtype. An FSDP chunk's gradient already holds the sum over fsdp
    (its gather's reduce-scatter), so it is summed over dp and ep only."""
    n = mesh.size(DATA_AXES)
    if n == 1:
        return
    params = dict(module.named_parameters())
    pairs = ([(p, p.grad) for p in params.values()] if grads is None
             else [(params[k], g) for k, g in grads.items()])
    buckets: dict = {}
    for p, g in pairs:
        if g is None:
            continue
        info = getattr(p, "_pt_shard", None)
        axes = (("dp", "ep") if info is not None and info.fsdp_dim is not None
                else DATA_AXES)
        buckets.setdefault((axes, g.dtype), []).append(g)
    for (axes, _), gs in sorted(buckets.items(),
                                key=lambda kv: (kv[0][0], str(kv[0][1]))):
        group = mesh.group(axes) if mesh.size(axes) > 1 else None
        C.all_reduce_(gs, group, 1.0 / n)


@contextlib.contextmanager
def data_parallel(mesh: HybridMesh):
    """Inside, ``nn.functional.masked_mean`` (every model's loss) divides by
    this rank's share of the count over the data axes: the count summed
    over dp, fsdp and ep (one all-reduce), at least 1, over their number of
    ranks. The ranks' mean of their losses (:func:`data_mean`) and of their
    gradients (:func:`sync_grads`) then is the masked mean of the global
    batch and its gradient, as in the reference's one program over the
    global batch, also where the ranks' rows mask different numbers of
    labels (padding, prompt-masked batches). A no-op on one data rank."""
    n = mesh.size(DATA_AXES)
    if n == 1:
        yield
        return
    group = mesh.group(DATA_AXES)

    def share(count):
        total = count.detach().clone()
        C.all_reduce_([total], group)
        return torch.clamp(total, min=1.0) / n

    token = MEAN_DENOMINATOR.set(share)
    try:
        yield
    finally:
        MEAN_DENOMINATOR.reset(token)


def data_mean(x: torch.Tensor, mesh: HybridMesh) -> torch.Tensor:
    """``x`` (a detached loss) averaged over the data axes."""
    n = mesh.size(DATA_AXES)
    if n == 1:
        return x
    x = x.detach().clone()
    C.all_reduce_([x], mesh.group(DATA_AXES), 1.0 / n)
    return x


def with_sharding_constraint(x, *spec):
    return x


def maybe_shard(x, *spec):
    """A no-op: each rank's activations already are its shards."""
    return x
