"""The training step — counterpart of ``paddle_tpu/train/step.py``.

The reference jits one donated XLA program (grads, optimizer update, LR
schedule). PyTorch runs eagerly: the step zeroes the gradients, runs the
loss forward and ``backward()`` (the kernels' backward passes on the
card), and hands the gradients to the optimizer, which updates the
parameters in place — the port's counterpart of donation, so ``donate``
has no counterpart here. The single-device path only: a ``mesh`` raises
until ``distributed/`` is ported (ROADMAP.md queue 1 item 7).
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


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step (mesh) is not ported yet (ROADMAP.md "
            "queue 1 item 7, distributed)")


def make_train_step(loss_fn: Callable, optimizer, mesh=None,
                    with_rng: bool = False):
    """loss_fn(model, *batch[, rng]) -> scalar tensor. Returns
    step(state, *batch) -> (state, loss), ``loss`` detached."""
    _no_mesh(mesh)

    def step(state: TrainState, *batch):
        model = state.model
        model.zero_grad(set_to_none=True)
        if with_rng:
            loss = loss_fn(model, *batch, state.rng)
        else:
            loss = loss_fn(model, *batch)
        loss.backward()
        model, opt_state = optimizer.step(model, None, state.opt_state)
        return TrainState(model, opt_state, state.rng), loss.detach()

    return step


def init_state(model, optimizer, mesh=None, seed: int = 0) -> TrainState:
    _no_mesh(mesh)
    return TrainState(model, optimizer.init(model),
                      generator(seed, next(model.parameters()).device))
