"""Deterministic fault injection (chaos layer) — a copy of
``paddle_tpu/utils/faults.py`` (it never imported JAX), feeding this
package's metrics registry, tracer and flight recorder (every firing is
a ``fault`` event in :data:`~paddle_tpu_torch.observability.FLIGHT`).

The only way to *prove* the recovery paths
(preemption, NaN skip, elastic restart, crash-safe checkpoints) stay
correct is to drive them through induced failures on demand — seeded
and reproducible, so a chaos test that fails once fails every time.

Instrumented sites call :func:`fault_point` (a cheap no-op while no
rule is installed). Tests install rules against site names:

    serving.alloc    block allocation inside the engine (MemoryError)
    serving.tick     top of ``LLMEngine.step`` (exception / stall)
    serving.preempt  induced preemption (rule action receives the engine)
    serving.spec_verify  before the speculative verify forward — an
                     exception aborts the spec round exception-atomically
                     and the tick falls back to one-token decode
    serving.moe_dispatch  before the decode tick of an MoE model (the
                     expert all_to_all — a dead expert shard); an
                     exception aborts the tick exception-atomically:
                     no blocks leak and ``assert_quiescent`` stays clean
    serving.kv_quant  before the decode tick of an engine with an int8 KV
                     pool (its quantize-on-write); an exception aborts the
                     tick exception-atomically: pools, scale pools, tables
                     and the ledger stay untouched
    router.dispatch  before a request is handed to a replica engine —
                     fires pre-add, so the request stays with the router
                     (requeued, re-dispatched next step)
    router.kv_transfer  before a prefilled sequence is extracted for the
                     prefill→decode handoff; exception-atomic — the
                     sequence is pulled back and requeued, no blocks leak
                     on either replica
    router.replica_death  before a replica's step — an exception marks
                     the replica dead; its live requests requeue to a
                     healthy replica exactly once
    serving.prefix_evict  before a radix prefix-cache leaf eviction
                     frees its parked block — fires pre-mutation, so an
                     exception leaves the trie and free list untouched
                     (the allocation that triggered it fails cleanly)
    serving.adapter_swap  before a host→device LoRA adapter upload into
                     the stacked device cache (AdapterStore.ensure) —
                     fires pre-mutation, so an exception leaves the
                     cache, pins, and free list untouched; the scheduler
                     defers that admission to a later tick (no leaked
                     device cache entries, ``assert_quiescent`` clean)
    train.step       top of each trainer step (exception / stall)
    train.loss       loss override — return value replaces the real loss
                     (NaN injection)
    ckpt.write       before the checkpoint tmp file is written (OSError)
    ckpt.rename      between tmp-write and the atomic rename — the
                     crash window (InjectedCrash)
    collective.all_reduce  before a mesh all_reduce (dead-link chaos)
    router.kv_stall  straggler window inside one prefill→decode handoff
                     attempt — fires before ``KVTransfer.ship``; a
                     ``delay_s`` rule here makes the transfer slow (which
                     trips the hedging deadline), an exception makes it
                     fail (which burns one retry attempt)
    router.kv_partial  after ship, before install — a rule action
                     receives the shipped payload and returns a
                     corrupted/truncated replacement; geometry+checksum
                     validation must reject it and the router retries
                     from the pristine source payload
    serving.snapshot  before a host-side session snapshot is captured —
                     an exception skips this capture (the router keeps
                     the previous, staler snapshot)

Rules fire on specific hit counts of their site (``on={3, 5}``), every
k-th hit (``every=3``), or a seeded pseudo-random schedule
(:meth:`FaultRegistry.schedule`). An exhausted rule (``times``) stops
firing; ``clear()`` removes everything. All state is per-process and
host-side only.

Delay faults: ``delay_s`` sleeps *before* the rule's other behaviour
(exc/action) and composes with it — a rule with only ``delay_s`` models
a slow-but-correct straggler, ``delay_s`` + ``exc`` a slow failure. The
sleep goes through the swappable ``FAULTS.sleep`` so tests can fake
time. (``stall_s`` is the older exclusive form and always uses real
``time.sleep``.) The full machine-readable site list lives in
:data:`SITES` (the reference's list, kept whole so that a site keeps its
name and contract when the port wires it).

Usage::

    from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
    with FAULTS.scope("serving.alloc", exc=MemoryError, on={2, 3}):
        eng.run()        # 2nd and 3rd allocation attempts fail

Ref: Fleet's elastic controller is validated the same way in the
reference — induced pod kills, not production incidents.
"""
from __future__ import annotations

import contextlib
import random
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.observability.tracing import instant as _trace_instant

# chaos runs are self-describing: every firing increments this counter
# (labelled by site) and drops an instant event on the trace timeline
_INJECTED = METRICS.counter(
    "faults_injected_total",
    "fault-injection firings by chaos site", labelnames=("site",))

__all__ = ["FAULTS", "FaultRegistry", "FaultRule", "InjectedFault",
           "InjectedCrash", "SITES", "fault_point", "fault_value"]

# Every chaos site of the reference, site → one-line contract: what an
# injected failure there must guarantee.
SITES = {
    "serving.alloc": "block allocation inside the engine (MemoryError)",
    "serving.tick": "top of LLMEngine.step (exception / stall)",
    "serving.preempt": "induced preemption (action receives the engine)",
    "serving.spec_verify": "before the speculative verify forward; "
                           "exception-atomic spec-round abort",
    "serving.moe_dispatch": "before an MoE decode tick's expert "
                            "all_to_all; exception-atomic tick abort",
    "serving.kv_quant": "before an int8 pool's quantize-on-write scatter; "
                        "exception-atomic tick abort, no stale scales",
    "serving.cp_gather": "before a cp>1 decode tick's cross-shard partial "
                         "gather; exception-atomic tick abort, no leaked "
                         "blocks, ledger reconciles",
    "serving.prefix_evict": "before a radix prefix-cache leaf eviction; "
                            "pre-mutation, trie/free list untouched",
    "serving.adapter_swap": "before a LoRA adapter host→device upload; "
                            "pre-mutation, admission deferred",
    "serving.snapshot": "before a session-durability snapshot capture; "
                        "exception skips it, stale snapshot kept",
    "router.dispatch": "before a request is handed to a replica engine; "
                       "pre-add, request stays with the router",
    "router.kv_transfer": "before a prefilled sequence is extracted for "
                          "handoff; exception-atomic pull-back + requeue",
    "router.kv_stall": "straggler window inside one handoff ship attempt "
                       "(delay_s = slow, exc = burns a retry)",
    "router.kv_partial": "action corrupts/truncates the shipped payload; "
                         "validation rejects, router retries pristine",
    "router.replica_death": "before a replica's step; exception marks it "
                            "dead, live requests requeue exactly once",
    "collective.all_reduce": "before a mesh all_reduce (dead link)",
    "train.step": "top of each trainer step (exception / stall)",
    "train.loss": "loss override — action return replaces the loss",
    "ckpt.write": "before the checkpoint tmp file is written (OSError)",
    "ckpt.rename": "between tmp-write and atomic rename (InjectedCrash)",
}


class InjectedFault(RuntimeError):
    """Default exception raised by a rule with no explicit ``exc``."""


class InjectedCrash(RuntimeError):
    """Simulates a process kill at a crash window (e.g. mid-checkpoint-
    save). A RuntimeError so ElasticRunner's restart net catches it."""


@dataclass
class FaultRule:
    """One installed fault. Matches when its site is hit and the hit
    index (0-based, per site, counted from installation) satisfies
    ``on``/``every``; fires at most ``times`` times (None = unbounded).

    Exactly one primary behaviour:
      * ``exc``     — an exception class or instance to raise
      * ``action``  — called with the site's context kwargs; its return
                      value is handed back to the fault point (the
                      ``train.loss`` site uses it as the loss override)
      * ``stall_s`` — sleep this long (legacy exclusive stall injection)

    ``delay_s`` is orthogonal and composes: it sleeps (through the
    registry's swappable ``sleep``) *before* the primary behaviour runs;
    a rule with only ``delay_s`` is a pure straggler — slow, not broken.
    """
    site: str
    on: Optional[frozenset] = None
    every: Optional[int] = None
    times: Optional[int] = None
    exc: Any = None
    action: Optional[Callable[..., Any]] = None
    stall_s: Optional[float] = None
    delay_s: Optional[float] = None
    fired: int = 0
    _base_hit: int = 0          # site hit count when the rule was installed

    def matches(self, hit: int) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        rel = hit - self._base_hit
        if self.on is not None:
            return rel in self.on
        if self.every is not None:
            return self.every > 0 and rel % self.every == self.every - 1
        return True

    def fire(self, ctx: dict, sleep: Callable[[float], None] = time.sleep):
        self.fired += 1
        if self.delay_s is not None:
            sleep(self.delay_s)
        if self.exc is not None:
            raise self.exc if isinstance(self.exc, BaseException) \
                else self.exc(f"injected fault at {self.site}")
        if self.stall_s is not None:
            time.sleep(self.stall_s)
            return None
        if self.action is not None:
            return self.action(ctx)
        if self.delay_s is not None:
            return None          # pure delay fault: slow, not broken
        raise InjectedFault(f"injected fault at {self.site}")


class FaultRegistry:
    """Per-process rule table + per-site hit counters. The module-level
    :data:`FAULTS` singleton is what the instrumented sites consult."""

    def __init__(self):
        self._rules: dict[str, list[FaultRule]] = defaultdict(list)
        self.hits: dict[str, int] = defaultdict(int)
        self.log: list[tuple[str, int]] = []   # (site, hit) of every firing
        self.sleep: Callable[[float], None] = time.sleep  # delay_s clock

    # ------------------------------------------------------------- admin
    def install(self, site: str, *, on=None, every: Optional[int] = None,
                times: Optional[int] = None, exc=None,
                action: Optional[Callable] = None,
                stall_s: Optional[float] = None,
                delay_s: Optional[float] = None) -> FaultRule:
        rule = FaultRule(site=site,
                         on=None if on is None else frozenset(on),
                         every=every, times=times, exc=exc, action=action,
                         stall_s=stall_s, delay_s=delay_s,
                         _base_hit=self.hits[site])
        self._rules[site].append(rule)
        return rule

    def schedule(self, site: str, *, seed: int, p: float, horizon: int,
                 **kw) -> FaultRule:
        """Seeded pseudo-random hit set: each of the next ``horizon``
        hits of ``site`` fails independently with probability ``p``,
        drawn from ``random.Random(seed)`` — the same seed always yields
        the same schedule, so chaos runs are reproducible bit-for-bit."""
        rng = random.Random(seed)
        on = frozenset(i for i in range(horizon) if rng.random() < p)
        return self.install(site, on=on, **kw)

    def remove(self, rule: FaultRule):
        self._rules.get(rule.site, []) and self._rules[rule.site].remove(rule)
        if not self._rules.get(rule.site):
            self._rules.pop(rule.site, None)

    def clear(self, site: Optional[str] = None):
        if site is None:
            self._rules.clear()
            self.hits.clear()
            self.log.clear()
            self.sleep = time.sleep   # drop any test-injected fake clock
        else:
            self._rules.pop(site, None)

    def active(self) -> bool:
        return bool(self._rules)

    @contextlib.contextmanager
    def scope(self, site: str, **kw):
        """Install a rule for the duration of a with-block."""
        rule = self.install(site, **kw)
        try:
            yield rule
        finally:
            self.remove(rule)

    # ------------------------------------------------------------ firing
    def fire(self, site: str, **ctx):
        """Advance ``site``'s hit counter; run every matching rule.
        Returns the last matching rule's action result (None when no
        rule matched or the rule raised/stalled)."""
        hit = self.hits[site]
        self.hits[site] = hit + 1
        out = None
        for rule in self._rules.get(site, ()):
            if rule.matches(hit):
                self.log.append((site, hit))
                _INJECTED.inc(site=site)
                _trace_instant(f"fault:{site}", hit=hit)
                FLIGHT.record("fault", site=site, hit=hit)
                out = rule.fire(ctx, self.sleep)
        return out


FAULTS = FaultRegistry()


def fault_point(site: str, **ctx):
    """Instrumentation hook. A no-op (one dict lookup) unless a rule is
    installed for any site; returns the matched rule's action result."""
    if not FAULTS._rules:
        return None
    return FAULTS.fire(site, **ctx)


def fault_value(site: str, default, **ctx):
    """Value-override hook (e.g. ``train.loss``): returns ``default``
    unless a matching rule's action supplies a replacement."""
    if not FAULTS._rules:
        return default
    out = FAULTS.fire(site, default=default, **ctx)
    return default if out is None else out
