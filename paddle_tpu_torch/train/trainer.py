"""Trainer — counterpart of ``paddle_tpu/train/trainer.py`` (ref:
PaddleNLP ``Trainer`` / the reference's Fleet training loop).

One eager step (forward, ``backward()`` through the kernels' backward
passes, the in-place optimizer update), gradient accumulation in fp32
(each microbatch's gradients added into fp32 buffers, divided by the
count on the boundary), the NaN guard with backoff and a watchdog trip,
MFU logging, checkpoint/resume, hooks and history.

The NaN guard skips on the device. The reference wraps the update in
``jnp.where(isfinite(loss), new, old)`` over the model and the optimizer
state, so a skipped update does not advance ``opt_state["step"]`` nor the
LR schedule. Here the step hands the optimizer ``ok = isfinite(loss)``
(a device bool), the bias-correction count and a scheduler's learning
rate read from a DEVICE step counter that advances by ``ok`` (a float
learning rate comes from the state, as a ``set_lr`` during the fit left it):
every parameter, master copy and slot keeps its bits where ``ok`` is
False (``Optimizer.step``'s masked update), and the next step reads the
same learning rate again — with no host read. The host's
``opt_state["step"]`` is a mirror, advanced when the loop reads a loss:
every step in the synchronous loop (which reads the loss anyway: one
sync a step, the guard adds none), on the drain side of the window in
the pipelined loop (``pipeline_depth`` K: one sync per drained step,
K steps late). Both loops run the same device path, so they are
bit-identical.

Host/device overlap (``pipeline_depth=K > 0``): PyTorch launches CUDA
work asynchronously, so the loop keeps K dispatched-but-unfetched steps
in flight and fetches each loss on the drain side of the window with
its own (<= K lagged) step attribution; log / eval / checkpoint
boundaries drain the window first, so they see exactly the state the
synchronous loop sees. ``device_double_buffer`` fetches step N+1's
microbatches and starts their host->device copies (from pinned memory,
``non_blocking``) while step N runs.

MFU: ``peak_flops`` defaults to ``chip_peak_flops(device)`` — the card's
row (989e12 on the H100), 0.0 on the CPU, where no MFU is reported.
With ``flops_per_token`` unset the trainer reports no MFU: the
reference's fallback reads XLA's cost analysis of the compiled step,
which an eager step has not got.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.observability import METRICS, span as _span
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.flops import (chip_peak_flops,
                                                  record_throughput)
from paddle_tpu_torch.optimizer.lr import LRScheduler
from paddle_tpu_torch.train.checkpoint import CheckpointManager
from paddle_tpu_torch.train.step import (TrainState, init_state,
                                         loss_and_grads)
from paddle_tpu_torch.utils.faults import fault_point, fault_value
from paddle_tpu_torch.utils.watchdog import WatchdogTrip

_STEPS = METRICS.counter("train_steps_total", "optimizer steps completed")
_STEP_S = METRICS.histogram(
    "train_step_seconds", "wall time per training step (host-observed)")
_NAN_SKIPS = METRICS.counter(
    "train_nan_skips_total", "steps skipped on non-finite loss")
_NAN_BACKOFF = METRICS.counter(
    "train_nan_backoff_total", "backoff sleeps taken during NaN streaks")
_LOSS = METRICS.gauge("train_loss", "most recent host-fetched loss")


@dataclass
class TrainerArgs:
    max_steps: int = 1000
    log_every: int = 10
    ckpt_every: int = 0                   # 0 = disabled
    ckpt_dir: str = "checkpoints"
    grad_accum_steps: int = 1
    flops_per_token: float = 0.0          # for MFU logging
    peak_flops: Optional[float] = None    # None: the device's table row
    nan_guard: bool = True                # skip update & count on non-finite loss
    max_bad_steps: int = 25               # trip watchdog after this many
    # backoff after a skipped step: nan_backoff_s, doubling per
    # consecutive bad step up to nan_backoff_cap_s; 0 disables
    nan_backoff_s: float = 0.0
    nan_backoff_cap_s: float = 30.0
    resume_reskip: bool = False           # fast-forward a FRESH stream on resume
    pipeline_depth: int = 0               # dispatched steps kept in flight
    async_ckpt: bool = False              # CheckpointManager(async_save=True)
    device_double_buffer: bool = False    # stage step N+1's batches early


class Trainer:
    """``device``: None means the card (raises without one); the model is
    moved there. Tests pass ``device="cpu"``."""

    def __init__(self, model, optimizer, loss_fn: Callable,
                 args: TrainerArgs = None, mesh=None, hooks=None,
                 device=None):
        self.args = args or TrainerArgs()
        self.device = resolve_device(device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.state = init_state(model.to(self.device), optimizer, mesh)
        self.hooks = hooks or []
        self.history: list[dict] = []
        self._bad_steps = 0
        self.watchdog = None           # StallWatchdog, poked every step
        self.stats = {"nan_skips": 0, "bad_streak_max": 0}
        self.peak_flops = (chip_peak_flops(self.device)
                           if self.args.peak_flops is None
                           else self.args.peak_flops)
        # seconds the host spent blocked on loss fetches, and in fit
        self.host_wait_s = 0.0
        self.fit_s = 0.0
        self._dstep = None             # device step counter (nan_guard)
        self._tables = None
        self._mgr = None               # the running fit's CheckpointManager

    # ------------------------------------------------------------ the step
    def _schedule_tables(self, start: int):
        """The device step counter and, for an ``LRScheduler``, its learning
        rate at every host step of this fit as a float64 device table (the
        counter indexes it). A float lr is read from the state each step,
        so a ``set_lr`` made during the fit applies, as the reference's."""
        st = self.state.opt_state
        self._tables = None
        if isinstance(self.optimizer.learning_rate, LRScheduler):
            lrs = [float(self.optimizer._lr({**st, "step": s}))
                   for s in range(start, self.args.max_steps + 1)]
            self._tables = (start, torch.tensor(lrs, dtype=torch.float64,
                                                device=self.device))
        self._dstep = torch.full((), start, dtype=torch.int64,
                                 device=self.device)

    def _grads(self, micro):
        """(loss, grads) of one step's microbatches, over the mesh's data
        axes where there is one (``train.step.loss_and_grads``)."""
        return loss_and_grads(self.state.model, self.loss_fn, micro,
                              self.mesh)

    def _step_fn(self, micro):
        loss, grads = self._grads(micro)
        self._apply(loss, grads)
        return loss

    def _apply(self, loss, grads):
        """The optimizer update of one step, guarded on the device when
        ``nan_guard`` (no host read)."""
        st, model = self.state.opt_state, self.state.model
        if not self.args.nan_guard:
            _, st = self.optimizer.step(model, grads, st)
        else:
            ok = torch.isfinite(loss)
            if self._tables is None:
                lr = self.optimizer._lr(st)     # a host float: no sync
            else:
                start, lrs = self._tables
                lr = torch.index_select(lrs, 0,
                                        (self._dstep - start).view(1))[0]
            _, st = self.optimizer.step(model, grads, st, ok=ok, lr=lr,
                                        t=self._dstep + 1)
            self._dstep += ok
        self.state = TrainState(model, st, self.state.rng)

    def _advance_host_step(self, raw: float):
        """The host mirror of the device counter after reading a loss."""
        if self.args.nan_guard and np.isfinite(raw):
            self.state.opt_state["step"] += 1

    def _fetch(self, loss) -> float:
        t0 = time.monotonic()
        raw = float(loss)          # blocks until the step executed
        self.host_wait_s += time.monotonic() - t0
        return raw

    def resume(self):
        mgr = CheckpointManager(self.args.ckpt_dir)
        restored = mgr.restore(self.state)
        if restored is not None:
            self.state = restored
        return self

    def fit(self, data_iter, eval_fn: Optional[Callable] = None):
        t0 = time.monotonic()
        try:
            if self.args.pipeline_depth > 0 or self.args.device_double_buffer:
                return self._fit_pipelined(data_iter, eval_fn)
            return self._fit_sync(data_iter, eval_fn)
        except BaseException as e:
            # a background save still writing finishes before the failure
            # leaves fit, so a restart restores what the run saved; the
            # run's own failure is what surfaces
            mgr, self._mgr = self._mgr, None
            if mgr is not None:
                try:
                    mgr.wait()
                except BaseException:
                    pass
            # last event of a dead run (no step read here: FLIGHT tracks it)
            FLIGHT.record("train.crash", error=f"{type(e).__name__}: {e}")
            FLIGHT.dump(reason=f"train.crash:{type(e).__name__}")
            raise
        finally:
            self.fit_s += time.monotonic() - t0

    def _flops_per_token(self) -> float:
        """The analytic FLOPs model when configured, else 0 (no MFU)."""
        return self.args.flops_per_token or 0.0

    def _on_loss(self, loss_val: float, step_no: int):
        """NaN accounting of one fetched loss: count, back off, trip."""
        args = self.args
        if not args.nan_guard:
            return
        if np.isfinite(loss_val):
            self._bad_steps = 0
            return
        self._bad_steps += 1
        self.stats["nan_skips"] += 1
        _NAN_SKIPS.inc()
        FLIGHT.record("train.nan_skip", step=step_no, streak=self._bad_steps)
        self.stats["bad_streak_max"] = max(self.stats["bad_streak_max"],
                                           self._bad_steps)
        if self._bad_steps >= args.max_bad_steps:
            FLIGHT.record("train.giveup", step=step_no,
                          streak=self._bad_steps)
            raise WatchdogTrip(
                f"{self._bad_steps} consecutive non-finite losses")
        if args.nan_backoff_s > 0:
            _NAN_BACKOFF.inc()
            FLIGHT.record("train.nan_backoff", step=step_no,
                          streak=self._bad_steps)
            time.sleep(min(args.nan_backoff_s * 2 ** (self._bad_steps - 1),
                           args.nan_backoff_cap_s))

    def _log(self, step_no, loss_val, dt, tokens, hidden_host_s=None):
        args = self.args
        rec = {"step": step_no, "loss": loss_val,
               "steps_per_sec": args.log_every / dt if dt > 0 else 0.0,
               "lr": self.optimizer.get_lr(self.state.opt_state)}
        fpt = self._flops_per_token()
        if fpt and tokens and dt > 0:
            rec["tokens_per_sec"] = tokens / dt
            kw = ({} if hidden_host_s is None
                  else dict(hidden_host_s=hidden_host_s, window_s=dt))
            m = record_throughput(tokens / dt, fpt, self.peak_flops, **kw)
            if self.peak_flops:       # no peak row (the CPU): no MFU
                rec["mfu"] = m
        self.history.append(rec)
        for h in self.hooks:
            h(rec)

    @staticmethod
    def _tokens(micro) -> int:
        return sum(int(b[0].shape[0] * b[0].shape[1]) for b in micro
                   if isinstance(b[0], torch.Tensor) and b[0].ndim >= 2)

    def _start(self, data_iter):
        """(start step, iterator) of a fit, or None when already done."""
        args = self.args
        start_step = int(self.state.step)
        if start_step >= args.max_steps:
            return None
        if args.nan_guard:
            self._schedule_tables(start_step)
        it = iter(data_iter)
        if start_step and args.resume_reskip:
            # align a FRESH stream with the restored step counter
            for _ in range(start_step * args.grad_accum_steps):
                next(it)
        return start_step, it

    def _fit_sync(self, data_iter, eval_fn: Optional[Callable] = None):
        args = self.args
        mgr = self._mgr = (
            CheckpointManager(args.ckpt_dir, async_save=args.async_ckpt)
            if args.ckpt_every else None)
        accum = args.grad_accum_steps
        begun = self._start(data_iter)
        if begun is None:
            return self.state       # already done — consume nothing
        start_step, it = begun
        t_last = time.perf_counter()
        tokens_since = 0
        for _ in range(start_step, args.max_steps):
            # chaos hooks: train.step may raise (-> elastic restart) or
            # stall (-> StallWatchdog trip); train.loss overrides the loss
            fault_point("train.step", step=int(self.state.step),
                        trainer=self)
            t_step = time.monotonic()
            with _span("train.step", step=int(self.state.step)):
                micro = [self._to_batch(next(it)) for _ in range(accum)]
                loss = self._step_fn(micro)
                if self.watchdog is not None:
                    self.watchdog.poke()   # raises WatchdogTrip if stalled
                raw = self._fetch(loss)
                self._advance_host_step(raw)
                step_no = int(self.state.step)
                loss_val = fault_value("train.loss", raw, step=step_no)
            _STEP_S.observe(time.monotonic() - t_step)
            _STEPS.inc()
            _LOSS.set(loss_val)
            FLIGHT.record("train.step", step=step_no, loss=loss_val)
            self._on_loss(loss_val, step_no)
            tokens_since += self._tokens(micro)
            if args.log_every and step_no % args.log_every == 0:
                now = time.perf_counter()
                self._log(step_no, loss_val, now - t_last, tokens_since)
                t_last, tokens_since = now, 0
            if mgr and step_no % args.ckpt_every == 0:
                mgr.save(step_no, self.state)
            if eval_fn and args.log_every and step_no % (args.log_every * 10) == 0:
                eval_fn(self.state.model)
        if mgr is not None:
            mgr.wait()     # async mode: "fit returned" implies durable
        return self.state

    # ------------------------------------------------- pipelined fit path
    def _fit_pipelined(self, data_iter, eval_fn: Optional[Callable] = None):
        """The deferred-sync loop: the same dispatch sequence as the
        synchronous loop (so bit-identical losses and parameters); every
        host decision that needs a loss happens at drain time, attributed
        to the step that produced it; log / ckpt / eval fire only with the
        window empty."""
        args = self.args
        depth = args.pipeline_depth
        mgr = self._mgr = (
            CheckpointManager(args.ckpt_dir, async_save=args.async_ckpt)
            if args.ckpt_every else None)
        accum = args.grad_accum_steps
        begun = self._start(data_iter)
        if begun is None:
            return self.state
        start_step, it = begun

        window: deque = deque()   # (loss, t_dispatch, n_tokens)
        drained = start_step      # host mirror of the device step counter
        last_loss = float("nan")
        t_last = time.perf_counter()
        tokens_since = 0
        # host input/dispatch seconds hidden behind in-flight device steps
        hidden_host_s = 0.0
        boundary_done = start_step

        def is_boundary(s: int) -> bool:
            if s <= boundary_done:
                return False
            return bool((args.log_every and s % args.log_every == 0)
                        or (mgr and s % args.ckpt_every == 0)
                        or (eval_fn is not None and args.log_every
                            and s % (args.log_every * 10) == 0))

        def drain_one():
            nonlocal drained, last_loss, tokens_since
            loss, t_disp, ntok = window.popleft()
            with _span("train.drain", step=drained + 1,
                       inflight=len(window) + 1):
                raw = self._fetch(loss)
            if self.watchdog is not None:
                self.watchdog.poke()
            # a guarded non-finite step did not move the device counter
            if (not args.nan_guard) or np.isfinite(raw):
                drained += 1
            if args.nan_guard:
                self.state.opt_state["step"] = drained
            step_no = drained
            loss_val = fault_value("train.loss", raw, step=step_no)
            _STEP_S.observe(time.monotonic() - t_disp)
            _STEPS.inc()
            _LOSS.set(loss_val)
            FLIGHT.record("train.step", step=step_no, loss=loss_val)
            last_loss = loss_val
            tokens_since += ntok
            self._on_loss(loss_val, step_no)

        def run_boundaries():
            nonlocal t_last, tokens_since, hidden_host_s, boundary_done
            step_no = drained
            if step_no <= boundary_done:
                return
            boundary_done = step_no
            if args.log_every and step_no % args.log_every == 0:
                now = time.perf_counter()
                self._log(step_no, last_loss, now - t_last, tokens_since,
                          hidden_host_s)
                t_last, tokens_since, hidden_host_s = now, 0, 0.0
            if mgr and step_no % args.ckpt_every == 0:
                mgr.save(step_no, self.state)
            if (eval_fn and args.log_every
                    and step_no % (args.log_every * 10) == 0):
                eval_fn(self.state.model)

        dbuf = args.device_double_buffer
        staged_next = None      # step i+1's microbatches, already copying
        for i in range(start_step, args.max_steps):
            fault_point("train.step", step=drained + len(window),
                        trainer=self)
            in_flight_before = len(window)
            t_disp = time.monotonic()
            with _span("train.step", step=drained + len(window)):
                if staged_next is not None:
                    micro, staged_next = staged_next, None
                else:
                    micro = [self._to_batch(next(it)) for _ in range(accum)]
                loss = self._step_fn(micro)
            if in_flight_before > 0:
                hidden_host_s += time.monotonic() - t_disp
            window.append((loss, t_disp, self._tokens(micro)))
            if dbuf and i + 1 < args.max_steps:
                t_pf = time.monotonic()
                staged_next = [self._to_batch(next(it), stage=True)
                               for _ in range(accum)]
                hidden_host_s += time.monotonic() - t_pf
            while len(window) > depth:
                drain_one()
            if is_boundary(drained + len(window)) or is_boundary(drained):
                while window:
                    drain_one()
                run_boundaries()
        while window:
            drain_one()
        run_boundaries()
        if mgr is not None:
            mgr.wait()
        return self.state

    def _to_batch(self, b, stage: bool = False):
        """A batch (a tensor / array, or a tuple of them) as a tuple of
        tensors on the trainer's device. ``stage``: host arrays go through
        pinned memory with a non-blocking copy (the double buffer)."""
        items = b if isinstance(b, (tuple, list)) else (b,)
        out = []
        for x in items:
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x))
            if t.device != self.device:
                if stage and self.device.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=stage)
            out.append(t)
        return tuple(out)
