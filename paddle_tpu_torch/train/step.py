"""The training step — counterpart of ``paddle_tpu/train/step.py``.

The reference jits one donated XLA program (grads, optimizer update, LR
schedule). PyTorch runs eagerly: the step zeroes the gradients, runs the
loss forward and ``backward()`` (the kernels' backward passes on the
card), and hands the gradients to the optimizer, which updates the
parameters in place — the port's counterpart of donation, so ``donate``
has no counterpart here.

With a ``mesh`` (``distributed.HybridMesh``) every rank runs the step on
its slice of the global batch over the data axes (dp, fsdp, ep; the
reference's ``batch_sharding``), and over an sp axis on its block of each
row's sequence (the batch's integer tensors — token ids, labels, position
ids — are cut along dim 1; bool and float tensors, the attention masks,
keep their sequence dims whole and the model takes its query rows of
them; labels come shifted by the caller, so the loss is token-local).
The loss's masked mean counts the labels of the whole global batch
(``distributed.sharded.data_parallel``), so the ranks' losses and
gradients, averaged over those axes before the update, are the
reference's loss and gradients of the global batch, also where the
ranks' tokens mask different numbers of labels. A cp axis (the serving
axis of context parallelism) is refused. ``init_state(model,
optimizer, mesh)`` shards the model first (``shard_module``: tp slices,
FSDP chunks), so the optimizer's slots are made on the local pieces.
Each rank passes the same global batch. :func:`loss_and_grads` is this
policy, for this step and for ``Trainer``'s microbatches.
"""
from __future__ import annotations

from typing import Callable

import torch

from paddle_tpu_torch.core.random import generator


class TrainState:
    """(model, opt_state, rng): the model (updated in place), the
    optimizer's state dict and a ``torch.Generator`` in place of the
    reference's PRNG key."""

    def __init__(self, model, opt_state, rng=None):
        self.model = model
        self.opt_state = opt_state
        self.rng = rng

    @property
    def step(self):
        return self.opt_state["step"]


def _refuse_sequence_axes(mesh):
    if mesh.size("cp") > 1:
        raise NotImplementedError(
            "a train step over a cp mesh axis: cp is the serving axis of "
            "context parallelism (LLMEngine(cp=N)); split a train step's "
            "sequence over sp")


def _shard_batch(mesh, x):
    """This rank's piece of one batch tensor: its rows over the data axes
    and, for an integer tensor (ids, labels, position ids), its block of
    dim 1 over sp."""
    x = mesh.batch_sharding()(x)
    if mesh.size("sp") > 1 and x.dim() >= 2 and not (
            x.is_floating_point() or x.dtype == torch.bool):
        x = mesh.local(x, (None, "sp"))
    return x


def _refuse_without_sp_attention(model, mesh):
    """Under sp > 1 the model must split its attention over sp: a model
    whose attention has no ``sequence_parallel`` mode would attend within
    each rank's block only."""
    if mesh.size("sp") > 1 and not any(
            getattr(m, "sequence_parallel", None) in ("ring", "ulysses")
            for m in model.modules()):
        raise ValueError(
            f"a train step over sp={mesh.size('sp')} needs a model whose "
            f"attention runs sequence_parallel='ring' or 'ulysses' "
            f"({type(model).__name__} has none)")


def loss_and_grads(model, loss_fn: Callable, micro, mesh=None):
    """(loss, grads) of one step's microbatches ``micro`` (batch tuples,
    ``loss_fn(model, *batch)``): for one microbatch the raw ``.grad``s
    (``grads`` None: the optimizer reads them), else their fp32 sum over
    the microbatches divided by the count, as the reference accumulates.
    Under a ``mesh`` each rank takes its rows of every batch over the data
    axes and its sequence block over sp (:func:`_shard_batch`), the
    loss's masked means count the global batch's labels, and the
    gradients and the loss are averaged over those axes."""
    model.zero_grad(set_to_none=True)
    if mesh is None:
        return _accumulate(model, loss_fn, micro)
    from paddle_tpu_torch.distributed.sharded import (data_mean,
                                                      data_parallel,
                                                      sync_grads)
    _refuse_without_sp_attention(model, mesh)
    micro = [tuple(_shard_batch(mesh, x) if isinstance(x, torch.Tensor)
                   else x for x in b) for b in micro]
    # the layers that read the active mesh (sp attention, MoE routing and
    # expert parallelism) see this one
    with mesh, data_parallel(mesh):
        loss, grads = _accumulate(model, loss_fn, micro)
    sync_grads(model, mesh, grads)
    return data_mean(loss, mesh), grads


def _accumulate(model, loss_fn, micro):
    if len(micro) == 1:
        loss = loss_fn(model, *micro[0])
        loss.backward()
        return loss.detach(), None
    params = [(n, p) for n, p in model.named_parameters()
              if p.is_floating_point()]
    acc = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params}
    loss = torch.zeros((), dtype=torch.float32, device=params[0][1].device)
    for b in micro:
        lb = loss_fn(model, *b)
        lb.backward()
        loss = loss + lb.detach().float()
        for n, p in params:
            if p.grad is not None:
                acc[n].add_(p.grad.float())
                p.grad = None
    k = len(micro)
    return loss / k, {n: a / k for n, a in acc.items()}


def make_train_step(loss_fn: Callable, optimizer, mesh=None,
                    with_rng: bool = False):
    """loss_fn(model, *batch[, rng]) -> scalar tensor. Returns
    step(state, *batch) -> (state, loss), ``loss`` detached."""
    if mesh is not None:
        _refuse_sequence_axes(mesh)

    def step(state: TrainState, *batch):
        if with_rng:
            batch = batch + (state.rng,)
        loss, _ = loss_and_grads(state.model, loss_fn, [batch], mesh)
        model, opt_state = optimizer.step(state.model, None, state.opt_state)
        return TrainState(model, opt_state, state.rng), loss

    return step


def init_state(model, optimizer, mesh=None, seed: int = 0) -> TrainState:
    """The model (sharded over ``mesh`` first, where one is given), the
    optimizer's state on its parameters and a seeded generator."""
    if mesh is not None:
        from paddle_tpu_torch.distributed.sharded import shard_module
        _refuse_sequence_axes(mesh)
        if getattr(model, "_pt_mesh", None) is None:
            model = shard_module(model, mesh)
    return TrainState(model, optimizer.init(model),
                      generator(seed, next(model.parameters()).device))
