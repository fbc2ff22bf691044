"""LR schedulers — copy of ``paddle_tpu/optimizer/lr.py`` in plain Python.

Two usage modes, as in the reference:
  * ``sched.value_at(step)`` — a pure function of the step counter kept in
    the optimizer state (what ``Optimizer._lr`` reads). The reference
    computes it in jnp so that it traces into the jitted step; here the
    step runs eagerly, so it is a Python float and costs no device work.
  * reference-style stateful: ``sched.step()`` / ``sched.get_lr()``.
"""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.step()

    # stateful API -----------------------------------------------------------
    def step(self, metrics=None):
        self.last_epoch += 1
        self.last_lr = float(self.value_at(self.last_epoch))

    def get_lr(self):
        return self.last_lr

    # pure API ---------------------------------------------------------------
    def value_at(self, step):
        raise NotImplementedError


class NoamDecay(LRScheduler):
    """lr = d^{-0.5} * min(t^{-0.5}, t * warmup^{-1.5}) (ref lr.py NoamDecay)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, last_epoch=-1):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        t = max(float(step), 1.0)
        return (self.base_lr * self.d_model ** -0.5 *
                min(t ** -0.5, t * self.warmup_steps ** -1.5))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * self.gamma ** float(step)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * math.exp(-self.gamma * float(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr / (1.0 + self.gamma * float(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1):
        self.decay_steps, self.end_lr, self.power, self.cycle = decay_steps, end_lr, power, cycle
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        t = float(step)
        if self.cycle:
            div = max(math.ceil(t / self.decay_steps), 1.0)
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            t = min(t, decay_steps)
        frac = (1.0 - t / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch)

    def value_at(self, step):
        t = float(step)
        out = self.values[-1]
        for b, v in zip(reversed(self.boundaries), reversed(self.values[:-1])):
            out = v if t < b else out
        return out


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0.0, last_epoch=-1):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        t = float(step)
        cos = math.cos(math.pi * min(t, self.T_max) / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class LinearWarmup(LRScheduler):
    """Linear warmup wrapping an inner schedule or constant (ref lr.py)."""

    def __init__(self, learning_rate, warmup_steps, start_lr=0.0, end_lr=None,
                 last_epoch=-1):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr if end_lr is not None else (
            self.inner.base_lr if self.inner else float(learning_rate))
        base = self.inner.base_lr if self.inner else float(learning_rate)
        super().__init__(base, last_epoch)

    def value_at(self, step):
        t = float(step)
        if t < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * min(
                t / max(self.warmup_steps, 1), 1.0)
        if self.inner is not None:
            return self.inner.value_at(max(step - self.warmup_steps, 0))
        return self.end_lr


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * self.gamma ** float(step // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        k = sum(1.0 for m in self.milestones if float(step) >= m)
        return self.base_lr * self.gamma ** k


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch)

    def value_at(self, step):
        return self.base_lr * self.lr_lambda(step)


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3, last_epoch=-1):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.min_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(max_learning_rate, last_epoch)

    def value_at(self, step):
        t = min(float(step), self.total_steps)
        up_steps = self.phase_pct * self.total_steps
        down_steps = self.total_steps - up_steps

        def cos_anneal(lo, hi, frac):
            return lo + (hi - lo) * (1 + math.cos(math.pi * frac)) / 2

        if t < up_steps:
            return cos_anneal(self.max_lr, self.initial_lr,
                              t / max(up_steps, 1))
        return cos_anneal(self.min_lr, self.max_lr,
                          (t - up_steps) / max(down_steps, 1))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, last_epoch=-1):
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        super().__init__(base_learning_rate, last_epoch)

    def value_at(self, step):
        pos = math.fmod(float(step), self.up + self.down)
        frac = (pos / self.up if pos < self.up
                else 1.0 - (pos - self.up) / self.down)
        return self.base_lr + (self.max_lr - self.base_lr) * frac


class ReduceOnPlateau(LRScheduler):
    """Metric-driven: inherently host-side (ref lr.py ReduceOnPlateau).
    Use the stateful API; value_at returns the current lr."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0, cooldown=0):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.min_lr, self.cooldown = threshold, min_lr, cooldown
        self.best = None
        self.num_bad = 0
        self.cooldown_left = 0
        self.current = learning_rate
        self.base_lr = learning_rate
        self.last_epoch = -1
        self.last_lr = learning_rate

    def step(self, metrics=None):
        self.last_epoch += 1
        if metrics is None:
            return
        m = float(metrics)
        better = (self.best is None or
                  (m < self.best - self.threshold if self.mode == "min"
                   else m > self.best + self.threshold))
        if better:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current = max(self.current * self.factor, self.min_lr)
                self.num_bad = 0
                self.cooldown_left = self.cooldown
        self.last_lr = self.current

    def value_at(self, step):
        return float(self.current)
