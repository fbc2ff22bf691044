"""Fleet facade — counterpart of ``paddle_tpu/distributed/fleet.py`` (ref:
Paddle's ``fleet.init(is_collective=True, strategy=DistributedStrategy())``
and its hybrid-parallel config dict).

Maps the reference's strategy knobs onto a :class:`~.mesh.HybridMesh` over
the process group's ranks and the sharding of :mod:`.sharded`, so
reference training scripts translate line for line::

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 4,
                               "pp_degree": 2, "sharding_degree": 2}
    mesh = fleet.init(is_collective=True, strategy=strategy)

The knobs: ``amp`` (pure: the parameters cast by ``amp.decorate`` O2 and
``multi_precision`` fp32 master weights; ``use_pure_fp16`` casts to
float16, which the card's kernels take, the others to bfloat16),
``recompute`` (the model's ``remat`` flag), ``sharding`` (the ZeRO stage
of ``distributed_model``) and ``gradient_merge``
(``optimizer.GradientMerge``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Optional

import torch

from paddle_tpu_torch.distributed.mesh import HybridMesh, world


@dataclass
class DistributedStrategy:
    hybrid_configs: dict = field(default_factory=dict)
    amp: bool = False
    amp_configs: dict = field(default_factory=dict)
    recompute: bool = False
    sharding: bool = False
    sharding_configs: dict = field(default_factory=dict)
    gradient_merge: bool = False
    gradient_merge_configs: dict = field(default_factory=dict)

    def _amp_pure(self) -> bool:
        c = self.amp_configs or {}
        return bool(c.get("use_pure_fp16") or c.get("use_pure_bf16")
                    or str(c.get("level", "O1")).upper() == "O2")

    def _amp_dtype(self):
        c = self.amp_configs or {}
        return torch.float16 if c.get("use_pure_fp16") else torch.bfloat16


_STATE: dict = {"mesh": None, "strategy": None}


def init(is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, devices=None,
         device=None) -> HybridMesh:
    """Build the mesh from the strategy's hybrid_configs (ref fleet.init);
    ``dp_degree`` 0 or absent takes the ranks the others leave."""
    strategy = strategy or DistributedStrategy()
    hc = strategy.hybrid_configs
    n = len(devices) if devices is not None else world()[1]
    dp = int(hc.get("dp_degree", 0)) or 0
    tp = int(hc.get("mp_degree", 1))
    pp = int(hc.get("pp_degree", 1))
    sd = int(hc.get("sharding_degree", 1))
    sep = int(hc.get("sep_degree", 1))
    if dp == 0:
        denom = tp * pp * sd * sep
        if n % denom:
            raise ValueError(f"{n} ranks do not divide over the hybrid "
                             f"configs {hc}")
        dp = n // denom
    mesh = HybridMesh(dp=dp, fsdp=sd, pp=pp, tp=tp, sp=sep, devices=devices,
                      device=device)
    _STATE["mesh"] = mesh
    _STATE["strategy"] = strategy
    return mesh


def get_hybrid_communicate_group() -> Optional[HybridMesh]:
    return _STATE["mesh"]


def distributed_model(model, min_size: int = 2 ** 16):
    """Ref fleet.distributed_model: the strategy's ``recompute`` (the
    model's remat flag, else a warning that the knob is ignored) and pure
    ``amp`` (``amp.decorate`` O2) applied, then the parameters sharded
    over the mesh (the ZeRO stage from ``sharding_configs``, 3 by
    default; tp specs honoured)."""
    from paddle_tpu_torch.distributed.sharded import shard_module
    strategy = _STATE["strategy"]
    if strategy is not None:
        if strategy.recompute:
            cfg = getattr(model, "cfg", None)
            if cfg is not None and hasattr(cfg, "remat"):
                cfg.remat = True
            else:
                warnings.warn(
                    "DistributedStrategy.recompute: this model has no remat "
                    "flag; the knob is IGNORED — wrap the forward with "
                    "fleet.utils.recompute / paddle_tpu_torch.distributed."
                    "recompute (torch.utils.checkpoint) instead",
                    stacklevel=2)
        if strategy.amp and strategy._amp_pure():
            from paddle_tpu_torch import amp as _amp
            model = _amp.decorate(model, level="O2",
                                  dtype=strategy._amp_dtype())
    mesh = _STATE["mesh"]
    if mesh is None:
        return model
    stage = 3
    if strategy and strategy.sharding_configs:
        stage = int(strategy.sharding_configs.get("stage", 3))
    return shard_module(model, mesh, stage=stage, min_size=min_size)


def worker_index() -> int:
    return world()[0]


def worker_num() -> int:
    return world()[1]


def distributed_optimizer(optimizer, strategy=None):
    """Ref fleet.distributed_optimizer: the optimizer's slots follow the
    sharded parameters (``train.init_state(model, optimizer, mesh)``), so
    it needs no wrapping for distribution; the strategy's knobs act here:
    pure ``amp`` sets ``multi_precision`` on the optimizer that applies
    the updates, and ``gradient_merge`` wraps it in ``GradientMerge``
    (``k_steps`` / ``avg`` from gradient_merge_configs)."""
    strategy = strategy or _STATE["strategy"]
    if strategy is None:
        return optimizer
    if strategy.amp and strategy._amp_pure():
        target = optimizer
        while hasattr(target, "inner"):
            target = target.inner
        if hasattr(target, "multi_precision"):
            target.multi_precision = True
        else:
            warnings.warn(
                "DistributedStrategy.amp (pure): optimizer has no "
                "multi_precision attribute; the knob is IGNORED for it",
                stacklevel=2)
    if strategy.gradient_merge:
        from paddle_tpu_torch.optimizer import GradientMerge, Optimizer
        cfgs = strategy.gradient_merge_configs or {}
        k_steps = int(cfgs.get("k_steps", 1))
        if isinstance(optimizer, GradientMerge):
            pass  # idempotent: nested wrapping would compound k/avg
        elif isinstance(optimizer, Optimizer):
            if k_steps > 1:
                optimizer = GradientMerge(optimizer, k_steps=k_steps,
                                          avg=bool(cfgs.get("avg", True)))
        else:
            warnings.warn(
                "DistributedStrategy.gradient_merge: not a paddle_tpu_torch "
                "Optimizer; the knob is IGNORED — wrap it in "
                "paddle_tpu_torch.optimizer.GradientMerge yourself",
                stacklevel=2)
    return optimizer


class _FleetUtils:
    """Ref fleet.utils namespace."""

    @staticmethod
    def recompute(fn, *args, **kwargs):
        from paddle_tpu_torch.distributed import recompute as _rc
        return _rc(fn, *args, **kwargs)


utils = _FleetUtils()
