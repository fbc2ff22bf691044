"""Per-tenant SLO tracking and the usage-metering cost ledger — a copy
of ``paddle_tpu/observability/slo.py`` (it never imported JAX).

The observability stack up to here answers "is the fleet healthy now";
this module answers the two production questions it couldn't: **are we
meeting our objectives per tenant** (and how fast is the error budget
burning), and **which tenant consumed the chip** (a ledger a billing or
capacity-planning system can read).

:class:`SLOTracker` holds declarative objectives per tenant — the
fleet-wide key ``"*"`` is both the fleet's own scorecard (computed from
the untenanted instruments) and the default objective set applied to
every tenant without an explicit entry:

    ``ttft_p95``        p95 submission → first token  ≤ target seconds
    ``queue_wait_p95``  p95 submission → admission    ≤ target seconds
    ``inter_token_p95`` p95 inter-token gap           ≤ target seconds
    ``availability``    1 − (timeouts + rejections + replica deaths)
                        / finished  ≥ target fraction

Latency objectives read histogram bucket-count deltas (per tenant from
``serving_tenant_*_seconds``, fleet-wide from the untenanted
histograms): an observation landing in a bucket whose bound exceeds the
target counts against the budget — exact when the target sits on a
bucket bound, conservatively early otherwise. Availability reads
``serving[_tenant]_finished_total{reason}`` + rejections.

Alerting is SRE-style **multi-window, multi-burn-rate**: the error rate
over the window, divided by the objective's budget, is the burn rate
(burn 1.0 = spending the budget exactly at the sustainable pace). A
breach requires BOTH gates — fast burn (default 14.4×) over the short
window AND slow burn (default 6×) over the long/compliance window — so
one bad poll can't page and a slow leak can't hide. Breaches increment
``serving_slo_breaches_total``, drop a ``serving.slo_breach`` flight
event naming tenant + objective, and the per-poll gauges
``serving_slo_burn_rate{tenant,objective}`` (short-window burn) /
``serving_slo_budget_remaining`` feed the stock health rules and the
optional degradation-ladder signal.

The **cost ledger** attributes device resources to tenants *by
construction*, not by auditing call sites:

  * device-seconds — the engine's ``step()`` charges each tick's
    ``serving_tick_seconds`` observation to the tenants holding device
    state that tick (active slots, chunked prefills, beam groups), one
    equal row share each, remainder-balanced so the shares sum to the
    tick total exactly; an idle tick bills ``__idle__``.
  * block-seconds — each tick integrates every request's live KV block
    count (the MemLedger's per-request live table) × tick seconds.
  * goodput/waste/saved tokens — the :data:`GOODPUT` ledger forwards
    every charge to the tracker's sink together with the tenant the
    call site knows, so per-tenant sums reconcile with the untenanted
    goodput counters exactly, tick-for-tick. Batch-level overheads
    (padding rows, chaos aborts, MoE drops) bill ``__system__``.

``PT_SLO=0`` is the kill switch, read per call: polling, tick charges,
and the goodput sink all become a few dict reads, and a disabled run is
bit-identical to a build without the tracker. The tracker is polled
from the engine's gauge sweep with the same owner-claim protocol as
the degradation ladder (a router, ROADMAP.md queue 1 item 5(j), claims
it so N replicas don't multiply the poll cadence). ``GET /slo`` and ``GET /tenants`` on the
metrics HTTP server serve :func:`slo_doc` / :func:`tenants_doc`.
"""
from __future__ import annotations

import itertools
import os
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.goodput import GOODPUT
from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.observability.windows import WindowedReads

__all__ = ["SLOTracker", "Objective", "CostLedger", "default_objectives",
           "slo_doc", "tenants_doc", "SYSTEM_TENANT", "IDLE_TENANT"]

# reserved ledger rows: batch-level work no tenant owns, and ticks with
# no resident work at all — real tenants' rows still sum with these to
# the untenanted totals, so reconciliation never needs special cases
SYSTEM_TENANT = "__system__"
IDLE_TENANT = "__idle__"

# finish reasons that count against availability (rejections are
# tracked by their own counters; cancellations are caller-initiated)
_BAD_FINISH_REASONS = ("timeout", "replica_death")

# objective name -> (fleet-wide instrument, per-tenant instrument)
_LATENCY_SOURCES = {
    "ttft_p95": ("serving_ttft_seconds",
                 "serving_tenant_ttft_seconds"),
    "queue_wait_p95": ("serving_queue_wait_seconds",
                       "serving_tenant_queue_wait_seconds"),
    "inter_token_p95": ("serving_token_latency_seconds",
                        "serving_tenant_token_latency_seconds"),
}

_BURN = METRICS.gauge(
    "serving_slo_burn_rate",
    "short-window error-budget burn rate per tenant and objective "
    "(1.0 = spending the budget exactly at the sustainable pace; the "
    "breach gate also requires the slow burn over the long window)",
    labelnames=("tenant", "objective"))
_BUDGET_LEFT = METRICS.gauge(
    "serving_slo_budget_remaining",
    "fraction of the error budget left over the compliance window, per "
    "tenant and objective (1.0 = untouched, 0.0 = exhausted)",
    labelnames=("tenant", "objective"))
_BREACHES = METRICS.counter(
    "serving_slo_breaches_total",
    "multi-window burn-rate alerts fired (fast AND slow gates both "
    "over threshold), by tenant and objective",
    labelnames=("tenant", "objective"))
_DEV_SECONDS = METRICS.counter(
    "serving_tenant_device_seconds_total",
    "engine tick wall-seconds attributed to each tenant (equal row "
    "share of every tick the tenant held device state; __idle__ for "
    "empty ticks) — sums over tenants to serving_tick_seconds' total",
    labelnames=("tenant",))
_BLOCK_SECONDS = METRICS.counter(
    "serving_tenant_kv_block_seconds_total",
    "KV-pool occupancy integrated over time per tenant (live blocks x "
    "tick seconds, from the memory ledger's per-request live counts)",
    labelnames=("tenant",))

_TRACKERS: "weakref.WeakSet" = weakref.WeakSet()
_SEQ = itertools.count()


def slo_enabled() -> bool:
    """``PT_SLO=0`` kill switch, read per call so a mid-flight flip
    stops all tracking on the very next poll/charge."""
    return os.environ.get("PT_SLO", "1") != "0"


def _guard(tenant) -> str:
    """Map a raw tenant id onto its (cardinality-guarded) ledger row."""
    if tenant is None:
        return SYSTEM_TENANT
    from paddle_tpu_torch.serving.telemetry import tenant_label
    return tenant_label(tenant)


# ------------------------------------------------------------- objectives
@dataclass
class Objective:
    """One declarative objective. ``target`` is a latency threshold in
    seconds for the p95 objectives, or the availability fraction for
    ``availability``. ``budget`` is the allowed bad fraction of events
    — default 0.05 for the p95 objectives (5% of observations may
    exceed the threshold) and ``1 - target`` for availability. The
    long/compliance window is ``window_s``; the fast gate reads
    ``short_s``."""
    name: str
    target: float
    window_s: float = 3600.0
    short_s: float = 300.0
    budget: Optional[float] = None
    fast_burn: float = 14.4
    slow_burn: float = 6.0

    def __post_init__(self):
        if self.name not in _LATENCY_SOURCES and self.name != "availability":
            raise ValueError(
                f"unknown objective {self.name!r} — expected one of "
                f"{sorted(_LATENCY_SOURCES)} or 'availability'")
        if self.name == "availability" and not 0.0 < self.target < 1.0:
            raise ValueError("availability target must be in (0, 1), "
                             f"got {self.target}")
        if self.name != "availability" and self.target <= 0:
            raise ValueError(f"latency target must be > 0, got {self.target}")
        if not 0 < self.short_s <= self.window_s:
            raise ValueError("need 0 < short_s <= window_s, got "
                             f"{self.short_s} / {self.window_s}")
        if self.budget is None:
            self.budget = ((1.0 - self.target)
                           if self.name == "availability" else 0.05)
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")

    def describe(self) -> dict:
        return {"name": self.name, "target": self.target,
                "window_s": self.window_s, "short_s": self.short_s,
                "budget": self.budget, "fast_burn": self.fast_burn,
                "slow_burn": self.slow_burn}


def default_objectives() -> List[Objective]:
    """The stock objective set — lab-scale latency targets and
    three-nines availability over a one-hour compliance window."""
    return [Objective("ttft_p95", target=1.0),
            Objective("queue_wait_p95", target=1.0),
            Objective("inter_token_p95", target=0.25),
            Objective("availability", target=0.999)]


# ------------------------------------------------------------ cost ledger
class CostLedger:
    """Host-side usage-metering dicts, keyed by (cardinality-guarded)
    tenant. The token columns are fed by the GOODPUT sink; the
    time-integral columns by :meth:`SLOTracker.charge_tick`. All
    methods are a few dict ops; with ``PT_SLO=0`` they return after one
    env read."""

    def __init__(self):
        self.device_seconds: Dict[str, float] = {}
        self.block_seconds: Dict[str, float] = {}
        self.good_tokens: Dict[str, int] = {}
        self.waste_tokens: Dict[str, Dict[str, int]] = {}
        self.saved_tokens: Dict[str, int] = {}
        # untenanted mirrors, accumulated term-by-term alongside the
        # per-tenant cells so the reconciliation invariant (sum of rows
        # == total) is arithmetic, not bookkeeping
        self.device_seconds_total = 0.0
        self.block_seconds_total = 0.0
        self.ticks = 0

    # ------------------------------------------------ GOODPUT sink API
    def good(self, tenant, n):
        if not slo_enabled():
            return
        k = _guard(tenant)
        self.good_tokens[k] = self.good_tokens.get(k, 0) + int(n)

    def waste(self, tenant, why, n):
        if not slo_enabled():
            return
        k = _guard(tenant)
        by = self.waste_tokens.setdefault(k, {})
        by[why] = by.get(why, 0) + int(n)

    def saved(self, tenant, n):
        if not slo_enabled():
            return
        k = _guard(tenant)
        self.saved_tokens[k] = self.saved_tokens.get(k, 0) + int(n)

    # -------------------------------------------------------- reports
    def good_total(self) -> int:
        return sum(self.good_tokens.values())

    def waste_total(self) -> int:
        return sum(n for by in self.waste_tokens.values()
                   for n in by.values())

    def saved_total(self) -> int:
        return sum(self.saved_tokens.values())

    def tenants(self) -> List[str]:
        keys = set(self.device_seconds) | set(self.block_seconds) \
            | set(self.good_tokens) | set(self.waste_tokens) \
            | set(self.saved_tokens)
        return sorted(keys)

    def snapshot(self) -> dict:
        rows = {}
        for t in self.tenants():
            rows[t] = {
                "device_seconds": self.device_seconds.get(t, 0.0),
                "block_seconds": self.block_seconds.get(t, 0.0),
                "good_tokens": self.good_tokens.get(t, 0),
                "waste_tokens": dict(self.waste_tokens.get(t, {})),
                "saved_tokens": self.saved_tokens.get(t, 0),
            }
        return {"ticks": self.ticks,
                "device_seconds_total": self.device_seconds_total,
                "block_seconds_total": self.block_seconds_total,
                "good_tokens_total": self.good_total(),
                "waste_tokens_total": self.waste_total(),
                "saved_tokens_total": self.saved_total(),
                "tenants": rows}


# --------------------------------------------------------------- tracker
class SLOTracker:
    """Construct one and hand it to an engine (``LLMEngine(...,
    slo=tracker)`` — polled from its gauge sweep, charged from its
    tick). Constructing a tracker also attaches its cost ledger as the
    process-wide GOODPUT attribution sink."""

    def __init__(self, objectives=None, *, registry=None,
                 clock: Callable[[], float] = None):
        if objectives is None:
            objectives = {"*": default_objectives()}
        if isinstance(objectives, (list, tuple)):
            objectives = {"*": list(objectives)}
        self.objectives: Dict[str, List[Objective]] = {}
        for tenant, objs in objectives.items():
            objs = list(objs)
            names = [o.name for o in objs]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate objective for tenant "
                                 f"{tenant!r}: {names}")
            self.objectives[str(tenant)] = objs
        self.windows = WindowedReads(registry)
        self.registry = self.windows.registry
        self.ledger = CostLedger()
        self.clock = clock or time.monotonic
        # who polls: None = the owning engine's gauge sweep; a router
        # claims the tracker so N replicas sharing it don't advance the
        # burn-rate windows N times per step (same protocol as the
        # degradation ladder)
        self.owner: object = None
        self.seq = next(_SEQ)
        self.polls = 0
        self.state: Dict[Tuple[str, str], dict] = {}
        self.breaches: List[dict] = []        # host-side audit trail
        self._hist: Dict[Tuple[str, str], deque] = {}
        self._alerting: set = set()
        GOODPUT.attach_sink(self.ledger)
        _TRACKERS.add(self)

    enabled = staticmethod(slo_enabled)

    # ----------------------------------------------------- tick charge
    def charge_tick(self, engine, seconds: float):
        """Called from the engine's ``step()`` finally block with the
        tick's ``serving_tick_seconds`` observation. Splits the tick
        over the tenants holding device state (equal row shares,
        remainder-balanced so the shares sum to ``seconds`` exactly)
        and integrates each request's live KV blocks over the tick."""
        if not slo_enabled():
            return
        led = self.ledger
        led.ticks += 1
        led.device_seconds_total += seconds
        rids = {int(r) for r in engine.slot_req[engine.active]}
        rids.update(int(r) for r in engine.prefilling)
        rids.update(int(r) for r in engine.groups)
        rids.discard(-1)
        keys = []
        for rid in sorted(rids):
            req = engine.requests.get(rid)
            keys.append(_guard(getattr(req, "tenant_id", None)))
        if not keys:
            keys = [IDLE_TENANT]
        share, acc = seconds / len(keys), 0.0
        for k in keys[:-1]:
            led.device_seconds[k] = led.device_seconds.get(k, 0.0) + share
            _DEV_SECONDS.inc(share, tenant=k)
            acc += share
        rem = seconds - acc       # the last share absorbs the rounding
        last = keys[-1]
        led.device_seconds[last] = led.device_seconds.get(last, 0.0) + rem
        _DEV_SECONDS.inc(rem, tenant=last)
        mem = engine.kv.ledger
        if mem.enabled:
            for sid, nblocks in mem._req_live.items():
                if not nblocks:
                    continue
                rid = sid[0] if isinstance(sid, tuple) else sid
                req = engine.requests.get(rid)
                k = _guard(getattr(req, "tenant_id", None))
                c = nblocks * seconds
                led.block_seconds[k] = led.block_seconds.get(k, 0.0) + c
                led.block_seconds_total += c
                _BLOCK_SECONDS.inc(c, tenant=k)

    # ---------------------------------------------------------- polling
    def poll(self):
        """One burn-rate sweep: windowed deltas per (tenant, objective),
        burn rates over the fast and slow windows, gauges, and the
        AND-gated breach edge. Called from the gauge sweep."""
        if not slo_enabled():
            return
        self.polls += 1
        now = self.clock()
        w = self.windows
        hist = {name: w.window_histogram_series(name)
                for pair in _LATENCY_SOURCES.values() for name in pair}
        fin = w.window_counter_series("serving_finished_total")
        rej = w.window_counter_series("serving_rejections_total")
        tfin = w.window_counter_series("serving_tenant_finished_total")
        trej = w.window_counter_series("serving_tenant_rejections_total")
        tenants = {"*"} | set(self.objectives)
        tenants.update(k[0] for k in tfin)
        tenants.update(k[0] for k in trej)
        for _, tname in _LATENCY_SOURCES.values():
            tenants.update(k[0] for k in hist[tname])
        for tenant in sorted(tenants):
            objs = self.objectives.get(tenant,
                                       self.objectives.get("*", ()))
            for obj in objs:
                bad, total = self._window_delta(
                    obj, tenant, hist, fin, rej, tfin, trej)
                self._update(obj, tenant, now, bad, total)

    def _window_delta(self, obj, tenant, hist, fin, rej, tfin, trej):
        """(bad, total) event deltas for one (objective, tenant) since
        the previous poll."""
        if obj.name == "availability":
            if tenant == "*":
                total = sum(fin.values())
                bad = sum(fin.get((r,), 0.0) for r in _BAD_FINISH_REASONS)
                bad += sum(rej.values())
            else:
                total = sum(v for k, v in tfin.items() if k[0] == tenant)
                bad = sum(tfin.get((tenant, r), 0.0)
                          for r in _BAD_FINISH_REASONS)
                bad += trej.get((tenant,), 0.0)
            # a pure-reject window has bad > finished: clamp the
            # denominator up so the error rate saturates at 1
            return bad, max(total, bad)
        fleet_name, tenant_name = _LATENCY_SOURCES[obj.name]
        if tenant == "*":
            series = hist[fleet_name]
            inst = self.registry.get(fleet_name)
            deltas = None
            for d in series.values():
                deltas = d if deltas is None else \
                    [a + b for a, b in zip(deltas, d)]
        else:
            inst = self.registry.get(tenant_name)
            deltas = hist[tenant_name].get((tenant,))
        if inst is None or deltas is None:
            return 0.0, 0.0
        total = sum(deltas)
        # an observation lands in the first bucket whose bound >= value,
        # so buckets with bound <= target are within the objective; the
        # bucket straddling a mid-bucket target counts as bad
        # (conservative — alarms early, never late)
        good = sum(d for b, d in zip(inst.buckets, deltas)
                   if b <= obj.target)
        return float(total - good), float(total)

    def _update(self, obj, tenant, now, bad, total):
        key = (tenant, obj.name)
        dq = self._hist.setdefault(key, deque())
        dq.append((now, bad, total))
        horizon = now - obj.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

        def window(win_s):
            lo = now - win_s
            b = sum(x[1] for x in dq if x[0] >= lo)
            t = sum(x[2] for x in dq if x[0] >= lo)
            return b, t

        bad_s, tot_s = window(obj.short_s)
        bad_l, tot_l = window(obj.window_s)
        rate_s = bad_s / tot_s if tot_s > 0 else 0.0
        rate_l = bad_l / tot_l if tot_l > 0 else 0.0
        burn_s = rate_s / obj.budget
        burn_l = rate_l / obj.budget
        allowed = obj.budget * tot_l
        remaining = (1.0 if allowed == 0 else
                     min(1.0, max(0.0, 1.0 - bad_l / allowed)))
        _BURN.set(burn_s, tenant=tenant, objective=obj.name)
        _BUDGET_LEFT.set(remaining, tenant=tenant, objective=obj.name)
        breaching = burn_s >= obj.fast_burn and burn_l >= obj.slow_burn
        if breaching and key not in self._alerting:
            self._alerting.add(key)
            _BREACHES.inc(tenant=tenant, objective=obj.name)
            event = {"tenant": tenant, "objective": obj.name,
                     "burn_short": round(burn_s, 3),
                     "burn_long": round(burn_l, 3),
                     "budget_remaining": round(remaining, 4),
                     "target": obj.target, "t": now}
            FLIGHT.record("serving.slo_breach", **event)
            self.breaches.append(event)
        elif not breaching:
            self._alerting.discard(key)
        self.state[key] = {
            "tenant": tenant, "objective": obj.name,
            "burn_short": burn_s, "burn_long": burn_l,
            "budget_remaining": remaining,
            "compliance": 1.0 - rate_l,
            "window_bad": bad_l, "window_total": tot_l,
            "breaching": breaching,
        }

    # --------------------------------------------------------- reports
    def snapshot(self) -> dict:
        """The ``GET /slo`` document: configured objectives plus the
        last poll's compliance/burn/budget per (tenant, objective)."""
        return {
            "tracker": self.seq,
            "enabled": slo_enabled(),
            "polls": self.polls,
            "objectives": {t: [o.describe() for o in objs]
                           for t, objs in sorted(self.objectives.items())},
            "status": [self.state[k] for k in sorted(self.state)],
            "breaches": list(self.breaches),
        }

    def tenants_snapshot(self) -> dict:
        """The ``GET /tenants`` document: the cost-ledger rows."""
        doc = self.ledger.snapshot()
        doc["tracker"] = self.seq
        doc["enabled"] = slo_enabled()
        return doc


def slo_doc() -> dict:
    """Every live tracker's SLO scorecard (the /slo endpoint)."""
    trackers = sorted(_TRACKERS, key=lambda t: t.seq)
    return {"enabled": slo_enabled(),
            "trackers": [t.snapshot() for t in trackers]}


def tenants_doc() -> dict:
    """Every live tracker's cost ledger (the /tenants endpoint)."""
    trackers = sorted(_TRACKERS, key=lambda t: t.seq)
    return {"enabled": slo_enabled(),
            "trackers": [t.tenants_snapshot() for t in trackers]}
