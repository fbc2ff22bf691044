"""Degradation ladder — a copy of ``paddle_tpu/serving/degrade.py`` (it
never imported JAX).

The cluster can *sense* trouble (HealthEvaluator verdicts, the
goodput/waste ledger, KV stall counters) and *inject* it (the chaos
sites in ``utils/faults.py``), but until this module it could not
*react*. :class:`DegradationController` is the missing control loop: a
small host-side state machine, polled from the engine's gauge sweep,
that maps live pressure signals onto ordered, **reversible**
rungs of reduced service:

    =====  ==========================================================
    rung   effect (each rung includes the ones below it)
    =====  ==========================================================
    L0     full service — bit-identical to a build without the ladder
    L1     speculative decoding disabled (verify FLOPs back to decode)
    L2     chunked-prefill token budget shrunk (shorter head-of-line
           stalls, admission slows down)
    L3     best-effort tenants shed at admission (deferred, not
           dropped — composes with the deficit fair scheduler)
    L4     new sessions rejected with explicit backpressure
           (:class:`~paddle_tpu_torch.serving.types.OverloadError`)
    =====  ==========================================================

Signals are **windowed**: each poll diffs counter totals and histogram
bucket counts against the previous poll's snapshot, so the ladder reads
"goodput ratio over the last window", not lifetime averages — a cluster
that thrashed an hour ago but is healthy now must come back to L0. An
empty window (no traffic) reads as healthy for the same reason.

Hysteresis is asymmetric by design: the ladder climbs to the worst
signal's target after ``up_patience`` consecutive polls (default 1 —
react fast), but descends ONE rung at a time after ``down_patience``
consecutive polls of calm (default 3 — recover slowly, so an
oscillating signal cannot flap service levels). Every transition sets
``serving_degrade_level``, increments
``serving_degrade_transitions_total{direction,to}``, and drops a
``serving.degrade`` flight-recorder event naming the signal that drove
it.

``PT_DEGRADE=0`` is the kill switch: checked on every poll *and* every
effect query, so flipping the env var mid-flight pins behaviour to L0
immediately. With the switch off — or simply at L0 — every effect
method returns the permissive answer and the serving path is
bit-identical to a build without the controller.

Feedback-loop note: the stock health rule ``serving_degrade_level``
(``observability/health.py``) reads the gauge this controller writes. Do
NOT hand that same evaluator to the controller's ``health=`` signal —
the rung would feed its own input and latch. The default is
``health=None`` for exactly this reason; pass a dedicated evaluator
with non-ladder rules if you want verdict-driven climbing.

Its :class:`SessionSnapshot` is the dataclass of the reference's session
durability: a host-side capture of one in-flight session (prompt,
generated ids, sampler and adapter/grammar references). Taking and
restoring snapshots belongs to the router (ROADMAP.md queue 1 item
5(j)); the dataclass is here so a snapshot means the same thing in both
packages.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.windows import WindowedReads
from paddle_tpu_torch.serving.telemetry import (_DEGRADE_LEVEL,
                                                _DEGRADE_TRANSITIONS)

__all__ = ["DegradationController", "SessionSnapshot", "default_signals"]


# --------------------------------------------------------------- snapshots
@dataclass
class SessionSnapshot:
    """Host-side durability capture of one in-flight session. Small by
    construction — token ids and scalars only, never KV blocks: restore
    replays prefill (radix-cache hits make the replay cheap) rather
    than shipping cache state."""
    req_id: int
    prompt: object                    # 1-D int32 prompt ids (shared ref)
    tokens: Tuple[int, ...]           # generated ids at capture time
    session_id: object = None
    tenant_id: object = None
    adapter_id: object = None
    grammar: object = None            # automaton ref; state replays from ids
    rng: object = None                # engine PRNG key at capture (advisory)
    gen: int = 0                      # len(tokens) at capture
    captured_t: float = 0.0           # engine clock at capture

    def resume_ids(self) -> np.ndarray:
        """prompt + generated ids — the replay prefill input."""
        if not self.tokens:
            return np.asarray(self.prompt, np.int32)
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])


# ----------------------------------------------------------- default signals
def default_signals(*, goodput_warn: float = 0.5, goodput_crit: float = 0.25,
                    goodput_min_tokens: int = 64,
                    queue_warn_s: float = 1.0, queue_crit_s: float = 5.0,
                    kv_util_floor: float = 0.97,
                    slo_burn: bool = False,
                    slo_burn_crit: float = 14.4) -> List[tuple]:
    """The stock signal set. Each signal is ``(name, fn)`` where ``fn``
    receives the controller and returns a target rung 0–4; the ladder
    steers toward the max over all signals. All reads are windowed
    through the controller's snapshot helpers, so targets describe the
    last poll interval, not process lifetime.

    ``slo_burn=True`` adds an OFF-BY-DEFAULT signal that targets L3
    (shed best-effort tenants) when any tenant's short-window
    ``serving_slo_burn_rate`` reaches ``slo_burn_crit`` (the tracker's
    fast-burn threshold). Caveat — this closes a feedback loop: the
    ladder's own mitigations (rejections at L4, shed tenants at L3)
    count against availability SLOs, so an aggressive threshold can
    latch the ladder high on the very errors it causes. That is why it
    ships disabled; enable it only with an availability objective whose
    budget tolerates the ladder's remedial rejections."""

    def health_sig(c) -> int:
        if c.health is None:
            return 0
        status = c.health.evaluate()["status"]
        return {"OK": 0, "WARN": 1, "CRIT": 3}.get(status, 0)

    def goodput_sig(c) -> int:
        ratio, volume = c.window_goodput()
        if volume < goodput_min_tokens or math.isnan(ratio):
            return 0
        if ratio < goodput_crit:
            return 3
        if ratio < goodput_warn:
            return 2
        return 0

    def queue_wait_sig(c) -> int:
        p95 = c.window_quantile("serving_queue_wait_seconds", 0.95)
        if math.isnan(p95):
            return 0
        if p95 >= queue_crit_s:
            return 4
        if p95 >= queue_warn_s:
            return 2
        return 0

    def kv_pressure_sig(c) -> int:
        util = c.gauge("serving_kv_block_utilization")
        stalls = c.window_counter("serving_kv_stall_total")
        return 2 if (util >= kv_util_floor and stalls > 0) else 0

    def slo_burn_sig(c) -> int:
        # max over tenant/objective series, not the sum — one tenant
        # burning hot should not be diluted by compliant neighbours
        inst = c.registry.get("serving_slo_burn_rate")
        if inst is None or not inst._series:
            return 0
        worst = max(cell[0] for cell in inst._series.values())
        return 3 if worst >= slo_burn_crit else 0

    sigs = [("health", health_sig), ("goodput", goodput_sig),
            ("queue_wait", queue_wait_sig), ("kv_pressure", kv_pressure_sig)]
    if slo_burn:
        sigs.append(("slo_burn", slo_burn_sig))
    return sigs


# ------------------------------------------------------------- controller
class DegradationController:
    """The ladder state machine. Construct one and hand it to an engine
    (``LLMEngine(..., degrade=ctrl)`` — polled from its gauge sweep).
    Effect queries (:meth:`spec_enabled`, :meth:`prefill_budget`,
    :meth:`shed_best_effort`, :meth:`accepting_sessions`) are cheap and
    safe to call every tick."""

    MAX_LEVEL = 4

    def __init__(self, *, health=None, registry=None,
                 signals: Optional[Sequence[tuple]] = None,
                 up_patience: int = 1, down_patience: int = 3,
                 chunk_shrink: int = 4, clock: Callable[[], float] = None):
        if up_patience < 1 or down_patience < 1:
            raise ValueError("patience values must be >= 1")
        if chunk_shrink < 1:
            raise ValueError(f"chunk_shrink must be >= 1, got {chunk_shrink}")
        self.registry = registry if registry is not None else METRICS
        self.health = health
        self.signals = list(default_signals() if signals is None else signals)
        self.up_patience = up_patience
        self.down_patience = down_patience
        self.chunk_shrink = chunk_shrink
        self.clock = clock or time.monotonic
        self.level = 0
        self.peak_level = 0
        self.transitions: List[dict] = []     # host-side audit trail
        self.last_targets: dict = {}          # signal name -> last target
        # who polls: None = the owning engine's gauge sweep; a router
        # claims the controller (owner=router) so N replica engines
        # sharing it don't each advance the hysteresis clocks per tick
        self.owner: object = None
        self._up_streak = 0
        self._down_streak = 0
        # windowed-read machinery (observability/windows.py, shared
        # with the SLO tracker); this controller's
        # reader owns its own snapshot dict, so a co-resident SLOTracker
        # polling the same registry never steals the ladder's deltas
        self.windows = WindowedReads(self.registry)
        self._snap = self.windows._snap       # windowed-read snapshots
        _DEGRADE_LEVEL.set(0.0)

    # ------------------------------------------------------------ switches
    @staticmethod
    def enabled() -> bool:
        """``PT_DEGRADE=0`` kill switch, read per call so a mid-flight
        flip takes effect on the very next poll/effect query."""
        return os.environ.get("PT_DEGRADE", "1") != "0"

    @property
    def active_level(self) -> int:
        """The rung that actually governs behaviour (0 when killed)."""
        return self.level if self.enabled() else 0

    # ------------------------------------------------------------- effects
    def spec_enabled(self) -> bool:
        """L1+: speculative decoding off."""
        return self.active_level < 1

    def prefill_budget(self, full: int) -> int:
        """L2+: the chunked-prefill token budget, shrunk by
        ``chunk_shrink`` (never below one token)."""
        if self.active_level < 2:
            return full
        return max(1, int(full) // self.chunk_shrink)

    def shed_best_effort(self) -> bool:
        """L3+: skip best-effort tenants at admission (they stay
        queued; nothing is cancelled)."""
        return self.active_level >= 3

    def accepting_sessions(self) -> bool:
        """L4: reject new sessions with OverloadError backpressure."""
        return self.active_level < 4

    # ------------------------------------------------------ windowed reads
    # thin delegations to the shared WindowedReads machinery — kept as
    # controller methods because custom signals receive the controller
    # and call these directly (see default_signals and the bench legs)
    def window_counter(self, name: str) -> float:
        """Counter delta (summed over label series) since the previous
        poll. The first read of a name baselines it at the current
        total, so pre-existing counts never trigger the ladder."""
        return self.windows.window_counter(name)

    def gauge(self, name: str) -> float:
        """Instantaneous gauge read (summed over label series)."""
        return self.windows.gauge(name)

    def window_goodput(self) -> Tuple[float, float]:
        """(goodput ratio, token volume) over the window — NaN ratio on
        an empty window, so no-traffic polls read as healthy."""
        return self.windows.window_goodput()

    def window_quantile(self, name: str, q: float) -> float:
        """Histogram quantile over THIS window's observations: per-
        bucket count deltas vs the previous poll, interpolated exactly
        like ``Histogram.quantile``. NaN when the window saw nothing."""
        return self.windows.window_quantile(name, q)

    # -------------------------------------------------------------- polling
    def poll(self) -> int:
        """One control-loop iteration: evaluate every signal, apply
        hysteresis, maybe transition. Returns the (configured) level."""
        if not self.enabled():
            if self.level:
                self._transition(0, why="kill_switch")
            self._up_streak = self._down_streak = 0
            _DEGRADE_LEVEL.set(0.0)
            return 0
        targets = {}
        for name, fn in self.signals:
            try:
                t = int(fn(self))
            except Exception:
                t = 0              # a broken signal must not wedge service
            targets[name] = max(0, min(self.MAX_LEVEL, t))
        self.last_targets = targets
        target = max(targets.values(), default=0)
        why = max(targets, key=targets.get) if targets else "manual"
        if target > self.level:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= self.up_patience:
                self._transition(target, why=why)
                self._up_streak = 0
        elif target < self.level:
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= self.down_patience:
                # descend ONE rung per patience window: recovery is
                # deliberately slower than escalation
                self._transition(self.level - 1, why="recovery")
                self._down_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        _DEGRADE_LEVEL.set(float(self.level))
        return self.level

    def force_level(self, level: int, why: str = "manual"):
        """Operational override (and the test hook): jump straight to a
        rung, clearing the hysteresis streaks. The signal loop keeps
        running — the next poll may move the rung again."""
        level = max(0, min(self.MAX_LEVEL, int(level)))
        if level != self.level:
            self._transition(level, why=why)
        self._up_streak = self._down_streak = 0

    def _transition(self, to: int, *, why: str):
        frm, self.level = self.level, to
        self.peak_level = max(self.peak_level, to)
        direction = "up" if to > frm else "down"
        _DEGRADE_LEVEL.set(float(to))
        _DEGRADE_TRANSITIONS.inc(direction=direction, to=str(to))
        FLIGHT.record("serving.degrade", frm=frm, to=to,
                      direction=direction, why=why)
        self.transitions.append({"from": frm, "to": to,
                                 "direction": direction, "why": why,
                                 "t": self.clock()})
