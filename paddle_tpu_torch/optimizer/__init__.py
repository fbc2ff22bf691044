"""Optimizers — the slice of ``paddle_tpu/optimizer/__init__.py`` that the
Llama train step and the QAT API need: ``ClipGradByGlobalNorm``,
``global_norm``, the ``Optimizer`` base with ``multi_precision`` fp32
master weights, ``SGD``, ``Adam`` and ``AdamW``. The other optimizers
are ROADMAP.md queue 1 item 8.

The reference is functional: ``step`` returns new params and a new state,
and its jitted train step donates the old buffers. The port's counterpart
of donation is an in-place update: :meth:`Optimizer.step` writes the new
values into the model's parameters, master weights and moments under
``no_grad`` and returns ``(model, new_state)``. The state is a dict keyed
by parameter name (``model.named_parameters()``); the learning rate,
the step count and the bias corrections are Python numbers, so a step
makes no device-to-host sync. ``torch.optim.AdamW`` is not used: its order
of decay and update differs from the reference's and it keeps no master
weights.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.lr import (  # noqa: F401
    CosineAnnealingDecay,
    CyclicLR,
    ExponentialDecay,
    InverseTimeDecay,
    LambdaDecay,
    LinearWarmup,
    LRScheduler,
    MultiStepDecay,
    NaturalExpDecay,
    NoamDecay,
    OneCycleLR,
    PiecewiseDecay,
    PolynomialDecay,
    ReduceOnPlateau,
    StepDecay,
)

_REDUCED = (torch.float16, torch.bfloat16)


def _float_grads(grads):
    return {n: g for n, g in grads.items()
            if g is not None and g.is_floating_point()}


def _named(model):
    """(name, tensor) pairs of a module's parameters, or of a {name:
    tensor} dict (the adapter-only LoRA step's A/B leaves)."""
    if isinstance(model, dict):
        return list(model.items())
    return list(model.named_parameters())


# -- grad clipping (ref python/paddle/nn/clip.py) ---------------------------

def global_norm(grads):
    """sqrt of the sum of squares of every float gradient, in fp32 (a
    0-d tensor on the gradients' device)."""
    leaves = list(_float_grads(grads).values())
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, grads):
        """{name: grad} -> {name: grad * min(1, clip / max(norm, 1e-12))}
        over the float gradients, scaled in fp32 and cast back to each
        gradient's type."""
        grads = _float_grads(grads)
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}


# -- base -------------------------------------------------------------------

class Optimizer:
    """State layout: ``{"step": int, "lr": float (unless the lr is a
    scheduler), "master": {name: fp32 copy or None} (multi_precision),
    <slots>: {name: tensor}}``."""

    def __init__(self, learning_rate=0.001, grad_clip=None, weight_decay=0.0,
                 multi_precision=False, apply_decay_param_fun=None):
        self.learning_rate = learning_rate
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.multi_precision = multi_precision
        # ref: AdamW(apply_decay_param_fun=...) — name-based decay masking
        self.apply_decay_param_fun = apply_decay_param_fun

    # -- state --------------------------------------------------------------
    def init(self, model) -> dict:
        params = {n: p for n, p in _named(model) if p.is_floating_point()}
        state = {"step": 0}
        if not isinstance(self.learning_rate, LRScheduler):
            state["lr"] = float(self.learning_rate)
        if self.multi_precision:
            # master copies ONLY for reduced-precision params: an fp32
            # param is its own master
            state["master"] = {n: p.detach().float().clone()
                               if p.dtype in _REDUCED else None
                               for n, p in params.items()}
        state.update(self._init_slots(params))
        return state

    def _init_slots(self, params) -> dict:
        return {}

    # -- lr -----------------------------------------------------------------
    def _lr(self, state):
        lr = self.learning_rate
        if isinstance(lr, LRScheduler):
            return float(lr.value_at(state["step"]))
        if "lr" in state:
            return float(state["lr"])
        return float(lr)

    def set_lr(self, value, state=None):
        """Ref Optimizer.set_lr — override the current learning rate (only
        valid with a float lr). With ``state`` returns the updated copy:
        ``state = opt.set_lr(3e-5, state)``."""
        if isinstance(self.learning_rate, LRScheduler):
            raise RuntimeError(
                "set_lr is not allowed when the lr is an LRScheduler "
                "(reference behavior); mutate the scheduler instead")
        self.learning_rate = float(value)
        if state is not None:
            return {**state, "lr": float(value)}
        return None

    def get_lr(self, state=None):
        if isinstance(self.learning_rate, LRScheduler):
            if state is not None:
                return float(self.learning_rate.value_at(state["step"]))
            return self.learning_rate.get_lr()
        if state is not None and "lr" in state:
            return float(state["lr"])
        return self.learning_rate

    def _decays(self, name):
        return (self.apply_decay_param_fun is None
                or bool(self.apply_decay_param_fun(name)))

    # -- update -------------------------------------------------------------
    @torch.no_grad()
    def step(self, model, grads, state, ok=None, lr=None, t=None):
        """Update ``model``'s parameters (or a {name: tensor} dict's
        tensors) in place from ``grads`` ({name: grad}; ``None`` reads
        each parameter's ``.grad``) and return ``(model, new_state)``. A
        parameter without a gradient keeps its value and its slots.

        The device-side skip (``Trainer``'s NaN guard): ``ok`` a 0-d bool
        device tensor, ``lr`` and ``t`` 0-d device tensors standing for
        the learning rate and the 1-based step count of the bias
        corrections. Every parameter, master copy and slot then ends
        bit-identical to before where ``ok`` is False, with no host read,
        and ``step`` is left as it was (the caller advances it)."""
        params = dict(_named(model))
        if grads is None:
            grads = {n: p.grad for n, p in params.items()}
        grads = _float_grads(grads)
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        names = list(grads)
        master = state.get("master") if self.multi_precision else None
        # the fp32 values the update works on: the master copy, the fp32
        # param itself, or an fp32 copy of a reduced param (written back)
        compute = [master[n] if master is not None and master[n] is not None
                   else params[n].float() for n in names]
        kept = self._kept(names, params, state) if ok is not None else []
        old = [x.clone() for x in kept]
        self._update(names, compute, [grads[n] for n in names], state,
                     self._lr(state) if lr is None else lr,
                     float(state["step"]) + 1.0 if t is None else t)
        for n, c in zip(names, compute):
            if c is not params[n]:
                params[n].copy_(c)
        for x, o in zip(kept, old):
            torch.where(ok, x, o, out=x)
        new_state = dict(state)
        new_state["step"] = state["step"] + (1 if ok is None else 0)
        return model, new_state

    @staticmethod
    def _kept(names, params, state):
        """The tensors an update writes that must survive a skipped step:
        the parameters, their master copies and every slot."""
        kept = [params[n] for n in names]
        for k, v in state.items():
            if isinstance(v, dict):
                kept += [v[n] for n in names if v.get(n) is not None]
        return kept

    def _update(self, names, params32, grads, state, lr, t):
        raise NotImplementedError


# -- SGD (ref sgd.py) -------------------------------------------------------

class SGD(Optimizer):
    def _update(self, names, params32, grads, state, lr, t):
        """``p - lr * (g + wd * p)`` in the reference's order: the product
        rounded before the subtraction."""
        for p, g in zip(params32, grads):
            u = g.to(p.dtype)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(lr * u)


# -- Adam family (ref adam.py / adamw.py) -----------------------------------

class Adam(Optimizer):
    decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, params):
        return {"moment1": {n: torch.zeros_like(p, dtype=torch.float32)
                            for n, p in params.items()},
                "moment2": {n: torch.zeros_like(p, dtype=torch.float32)
                            for n, p in params.items()}}

    def _update(self, names, params32, grads, state, lr, t):
        """The reference's update on fp32 values, in place: moments from
        the fp32 gradient, bias correction from ``t`` = step + 1 (fp32 in
        the reference, here in Python floats, or float64 device tensors
        on the device-side skip's path), eps added after the sqrt, the
        decoupled decay (AdamW) added to the update."""
        b1, b2, eps, wd = (self.beta1, self.beta2, self.epsilon,
                           self.weight_decay)
        if isinstance(t, torch.Tensor):
            # computed in float64, handed to the fp32 foreach kernels as
            # fp32 0-d tensors (what a Python float becomes inside them)
            t = t.double()
            bc1 = (1.0 - torch.pow(b1, t)).float()
            bc2 = (1.0 - torch.pow(b2, t)).float()
        else:
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        g32 = [g.float() for g in grads]
        if wd and not self.decoupled_wd:
            g32 = torch._foreach_add(g32, params32, alpha=wd)
        m = [state["moment1"][n] for n in names]
        v = [state["moment2"][n] for n in names]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g32, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
        del g32
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        update = torch._foreach_div(m, bc1)
        torch._foreach_div_(update, denom)
        del denom
        if self.decoupled_wd and wd:
            decay = [i for i, n in enumerate(names) if self._decays(n)]
            torch._foreach_add_([update[i] for i in decay],
                                [params32[i] for i in decay], alpha=wd)
        if isinstance(lr, torch.Tensor):
            torch._foreach_mul_(update, (-lr).float())
            torch._foreach_add_(params32, update)
        else:
            torch._foreach_add_(params32, update, alpha=-lr)


class AdamW(Adam):
    """Decoupled weight decay (ref adamw.py). Default wd 0.01."""
    decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         weight_decay=weight_decay, **kw)
