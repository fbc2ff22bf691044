"""Mixed precision — counterpart of ``paddle_tpu/amp/__init__.py`` (ref:
``python/paddle/amp/`` — auto_cast, decorate, GradScaler).

  * O1: float32 parameters, bfloat16 compute — a :class:`Policy` that
    casts values at module boundaries.
  * O2 ("pure"): parameters held in bfloat16, fp32 master weights in the
    optimizer (``multi_precision=True``).
  * :class:`GradScaler`: the full dynamic loss-scaling state machine,
    its state kept as device tensors so that no method reads the host;
    with ``enable=False`` every method is the identity.

:meth:`Policy.cast_to_param` and ``decorate(level="O2")`` return a cast
copy and leave the caller's module alone, as the reference's functional
cast does. :func:`auto_cast` sets torch's default dtype for the block, as
the reference's ``default_dtype`` does — it is not ``torch.autocast``.

The card's kernels take float32, bfloat16 and float16 (``ops/cuda/_build.py``
``dtype_code``): a float16 model runs each kernel's float16 instantiation
(fp32 accumulators and softmax statistics, as at bf16), so O1, O2 and
``auto_cast(dtype="float16")`` run float16 on the card and the CPU alike.
"""
from __future__ import annotations

import contextlib
import copy

import torch

from paddle_tpu_torch.amp import debugging  # noqa: F401
from paddle_tpu_torch.core.device import resolve_device

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16}


def _dtype(d) -> torch.dtype:
    return _DTYPES[d] if isinstance(d, str) else d


def _cast_floats(tree, dtype):
    """A copy of ``tree`` (a tensor, a module, or dicts / lists / tuples
    of them) with every floating tensor cast to ``dtype``; other leaves
    pass through. A module is deep-copied, then cast."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(dtype)
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


class Policy:
    """Dtype policy: parameter / compute / output dtypes (jmp-style, the
    reference's O-levels)."""

    def __init__(self, param_dtype=torch.float32,
                 compute_dtype=torch.bfloat16, output_dtype=None):
        self.param_dtype = _dtype(param_dtype)
        self.compute_dtype = _dtype(compute_dtype)
        self.output_dtype = (_dtype(output_dtype) if output_dtype
                             else self.compute_dtype)

    def cast_to_compute(self, tree):
        return _cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return _cast_floats(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return _cast_floats(tree, self.output_dtype)


def O1(dtype=torch.bfloat16) -> Policy:
    return Policy(param_dtype=torch.float32, compute_dtype=dtype)


def O2(dtype=torch.bfloat16) -> Policy:
    return Policy(param_dtype=dtype, compute_dtype=dtype)


def decorate(model, level: str = "O1", dtype=torch.bfloat16):
    """Ref ``paddle.amp.decorate``: O2 returns a copy of ``model`` with its
    floating parameters and buffers cast to ``dtype``; O1 returns
    ``model`` itself."""
    if level == "O2":
        return _cast_floats(model, _dtype(dtype))
    return model


@contextlib.contextmanager
def auto_cast(enable=True, level="O1", dtype="bfloat16"):
    """The reference's context manager: torch's default dtype is
    ``dtype`` for the block under O2 and float32 under O1 (restored on
    exit), so tensors the block creates without a dtype take it."""
    if not enable:
        yield
        return
    prev = torch.get_default_dtype()
    torch.set_default_dtype(_dtype(dtype) if level == "O2"
                            else torch.float32)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _float_items(grads):
    if isinstance(grads, dict):
        return grads.items()
    return enumerate(grads)


class GradScaler:
    """Dynamic loss scaling (ref ``python/paddle/amp/grad_scaler.py``),
    functional as the reference's: carry :meth:`init`'s state through the
    step. The state is three 0-d device tensors; :meth:`scale`,
    :meth:`unscale`, :meth:`found_inf`, :meth:`update` and
    :meth:`step_or_skip` are device operations only (no ``.item()``, no
    ``bool()``), so a step that uses them never waits on the card."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5,
                 incr_every_n_steps=2000, decr_every_n_nan_or_inf=1):
        self.enable = enable
        self.init_scale = init_loss_scaling
        self.incr_ratio, self.decr_ratio = incr_ratio, decr_ratio
        self.incr_every = incr_every_n_steps
        self.decr_every = decr_every_n_nan_or_inf

    def init(self, device=None):
        """The state on ``device`` (the card when None)."""
        dev = resolve_device(device)
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=dev),
                "good_steps": torch.zeros((), dtype=torch.int32, device=dev),
                "bad_steps": torch.zeros((), dtype=torch.int32, device=dev)}

    def scale(self, loss, state):
        if not self.enable:
            return loss
        return loss * state["scale"]

    def unscale(self, grads, state):
        """``grads`` ({name: grad} or a list) times 1 / scale."""
        if not self.enable:
            return grads
        inv = 1.0 / state["scale"]
        out = {k: (g * inv if isinstance(g, torch.Tensor)
                   and g.is_floating_point() else g)
               for k, g in _float_items(grads)}
        return out if isinstance(grads, dict) else [out[i] for i in
                                                    range(len(grads))]

    def found_inf(self, grads):
        """A 0-d bool device tensor: whether any float gradient holds a
        NaN or an inf."""
        leaves = [g for _, g in _float_items(grads)
                  if isinstance(g, torch.Tensor) and g.is_floating_point()]
        if not leaves:
            return torch.zeros((), dtype=torch.bool)
        return torch.stack([~torch.isfinite(g).all() for g in leaves]).any()

    def update(self, state, found_inf):
        """The new scaler state (pure, device-only)."""
        if not self.enable:
            return state
        good = torch.where(found_inf, 0, state["good_steps"] + 1)
        bad = torch.where(found_inf, state["bad_steps"] + 1, 0)
        scale = state["scale"]
        shrink = bad >= self.decr_every
        scale = torch.where(shrink, scale * self.decr_ratio, scale)
        bad = torch.where(shrink, 0, bad)
        grow = good >= self.incr_every
        scale = torch.where(grow, scale * self.incr_ratio, scale)
        good = torch.where(grow, 0, good)
        return {"scale": scale, "good_steps": good.to(torch.int32),
                "bad_steps": bad.to(torch.int32)}

    def step_or_skip(self, params, new_params, found_inf):
        """The old values where the gradients overflowed, else the new
        ones ({name: tensor} dicts; ref ``scaler.step`` skipping)."""
        if not self.enable:
            return new_params
        return {k: (torch.where(found_inf, old, new_params[k])
                    if isinstance(old, torch.Tensor) else old)
                for k, old in params.items()}


def is_bfloat16_supported(device=None):
    """bfloat16 runs on the card's kernels and on the CPU's plain path."""
    return True


def is_float16_supported(device=None):
    """float16 runs on the card's kernels (each has a float16
    instantiation) and on the CPU's plain path."""
    return True
