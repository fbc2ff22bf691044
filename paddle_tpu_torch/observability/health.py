"""Health evaluator — a copy of ``paddle_tpu/observability/health.py``
(it never imported JAX): declarative rules over the registry.

The registry answers "how many"; operators need "is it healthy". A
:class:`HealthRule` names one scalar derived from registry values (a
counter ratio, a histogram quantile, a gauge) plus WARN/CRIT thresholds;
:class:`HealthEvaluator.evaluate` runs every rule and folds the per-rule
statuses into one overall ``OK``/``WARN``/``CRIT`` — what ``/healthz``
on :mod:`paddle_tpu_torch.observability.httpd` serves (HTTP 503 on CRIT,
so a dumb TCP health checker needs zero JSON parsing).

Rules are *greater-is-worse*: value >= crit → CRIT, >= warn → WARN.
A rule with no data yet (empty histogram → NaN quantile, zero-count
ratio) reports OK — absence of traffic is not an incident. Getters
never raise out of ``evaluate``: a getter that throws marks its rule
CRIT with the error attached (a broken health probe IS unhealthy).
Getters read metrics BY NAME: a name nobody registers reads 0.0 (or
NaN), so the serving instruments keep the reference's names.

The module-global :data:`HEALTH` ships with the reference's default rule
set (:func:`install_default_rules`), training rules included: they read
OK while nothing feeds them.
"""
from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Sequence

from paddle_tpu_torch.observability.metrics import METRICS, Histogram

__all__ = ["HEALTH", "HealthEvaluator", "HealthRule", "install_default_rules",
           "gauge_max",
           "counter_value", "gauge_value", "counter_ratio", "counter_share",
           "gauge_imbalance", "gauge_deficit", "histogram_quantile",
           "histogram_sum_ratio", "kv_parked_ratio"]

_ORDER = {"OK": 0, "WARN": 1, "CRIT": 2}


# ------------------------------------------------------------ getter factories
def _series_total(inst) -> float:
    """Sum of every label series of a counter/gauge (0.0 when absent)."""
    if inst is None:
        return 0.0
    return float(sum(cell[0] for cell in inst._series.values()))


def counter_value(name: str, registry=None) -> Callable[[], float]:
    """Current value of a counter, summed across label series."""
    def get():
        reg = registry if registry is not None else METRICS
        return _series_total(reg.get(name))
    return get


gauge_value = counter_value      # same read path for gauges


def counter_ratio(num: str, den: str, registry=None) -> Callable[[], float]:
    """num/den over two counters; 0.0 while the denominator is zero."""
    def get():
        reg = registry if registry is not None else METRICS
        d = _series_total(reg.get(den))
        return _series_total(reg.get(num)) / d if d else 0.0
    return get


def counter_share(part: str, whole: Sequence[str],
                  registry=None) -> Callable[[], float]:
    """part / sum(whole counters) — e.g. wasted device tokens over all
    accounted device tokens. NaN while the denominator is zero: no
    traffic is not an incident."""
    def get():
        reg = registry if registry is not None else METRICS
        d = sum(_series_total(reg.get(n)) for n in whole)
        return _series_total(reg.get(part)) / d if d else float("nan")
    return get


def gauge_imbalance(name: str, registry=None) -> Callable[[], float]:
    """Spread across a labeled gauge's series: (max - min) / max(mean, 1),
    e.g. per-replica outstanding-request counts — 0 when perfectly
    balanced, large when one series hoards the load. NaN (→ OK) with
    fewer than two series: imbalance needs something to compare."""
    def get():
        reg = registry if registry is not None else METRICS
        inst = reg.get(name)
        if inst is None or len(inst._series) < 2:
            return float("nan")
        vals = [float(cell[0]) for cell in inst._series.values()]
        mean = sum(vals) / len(vals)
        return (max(vals) - min(vals)) / max(mean, 1.0)
    return get


def gauge_max(name: str, registry=None, *,
              deficit: bool = False) -> Callable[[], float]:
    """Worst series of a labeled gauge — max over label series, e.g.
    the hottest tenant's SLO burn rate. ``deficit=True`` reads
    ``max(1 - v)`` instead (worst budget CONSUMED when the gauge stores
    budget remaining). NaN (→ OK) while the gauge is absent or empty."""
    def get():
        reg = registry if registry is not None else METRICS
        inst = reg.get(name)
        if inst is None or not inst._series:
            return float("nan")
        vals = [float(cell[0]) for cell in inst._series.values()]
        if deficit:
            vals = [1.0 - v for v in vals]
        return max(vals)
    return get


def histogram_quantile(name: str, q: float, registry=None,
                       **labels) -> Callable[[], float]:
    """q-quantile of a histogram series (label kwargs select the series
    of a labeled histogram, e.g. ``phase="host"``); NaN while
    empty/absent."""
    def get():
        reg = registry if registry is not None else METRICS
        h = reg.get(name)
        if not isinstance(h, Histogram):
            return float("nan")
        return h.quantile(q, **labels)
    return get


def gauge_deficit(name: str, registry=None, **labels) -> Callable[[], float]:
    """1 - gauge value — a greater-is-worse view of a utilisation gauge
    (MBU, goodput ratio). NaN while the series is absent OR reads <= 0:
    by this repo's convention a utilisation of 0.0 means "undefined"
    (unknown peak, e.g. CPU), and undefined is not an incident."""
    def get():
        reg = registry if registry is not None else METRICS
        inst = reg.get(name)
        if inst is None:
            return float("nan")
        try:
            v = float(inst.value(**labels))
        except Exception:
            return float("nan")
        return 1.0 - v if v > 0.0 else float("nan")
    return get


def kv_parked_ratio(registry=None) -> Callable[[], float]:
    """serving_kv_blocks{state="parked"} / serving_kv_pool_blocks — the
    reclaimable prefix-cache share of the pool. NaN (→ OK) while the
    radix cache is disabled (``PT_RADIX_CACHE=0`` — a flat-manager pool
    parking ~everything after a burst is normal LRU behavior, and with
    caching off entirely there is nothing to rule on) or while the pool
    gauges are absent/zero."""
    def get():
        if os.environ.get("PT_RADIX_CACHE", "1") == "0":
            return float("nan")
        reg = registry if registry is not None else METRICS
        inst = reg.get("serving_kv_blocks")
        pool = reg.get("serving_kv_pool_blocks")
        if inst is None or pool is None:
            return float("nan")
        try:
            denom = float(pool.value())
            if denom <= 0.0:
                return float("nan")
            return float(inst.value(state="parked")) / denom
        except Exception:
            return float("nan")
    return get


def histogram_sum_ratio(num: str, den: str,
                        registry=None) -> Callable[[], float]:
    """sum(num histogram) / sum(den histogram) — e.g. seconds stalled in
    prefetch per second spent stepping; 0.0 while the denominator is 0."""
    def get():
        reg = registry if registry is not None else METRICS
        def hsum(n):
            h = reg.get(n)
            if not isinstance(h, Histogram):
                return 0.0
            return float(sum(s.sum for s in h._series.values()))
        d = hsum(den)
        return hsum(num) / d if d else 0.0
    return get


# --------------------------------------------------------------------- rules
class HealthRule:
    """One named scalar + WARN/CRIT thresholds (greater is worse)."""

    def __init__(self, name: str, getter: Callable[[], float],
                 warn: float, crit: float, description: str = ""):
        if crit < warn:
            raise ValueError(
                f"rule {name!r}: crit ({crit}) must be >= warn ({warn})")
        self.name = name
        self.getter = getter
        self.warn = warn
        self.crit = crit
        self.description = description

    def evaluate(self) -> dict:
        try:
            v = float(self.getter())
        except Exception as e:        # a broken probe IS unhealthy
            return {"name": self.name, "value": None, "status": "CRIT",
                    "warn": self.warn, "crit": self.crit,
                    "error": f"{type(e).__name__}: {e}"}
        if math.isnan(v):             # no data yet — not an incident
            status, v_out = "OK", None
        elif v >= self.crit:
            status, v_out = "CRIT", v
        elif v >= self.warn:
            status, v_out = "WARN", v
        else:
            status, v_out = "OK", v
        return {"name": self.name, "value": v_out, "status": status,
                "warn": self.warn, "crit": self.crit}


class HealthEvaluator:
    """An ordered rule list + one ``evaluate()`` fold."""

    def __init__(self, rules: Optional[List[HealthRule]] = None):
        self.rules: List[HealthRule] = list(rules or [])

    def add_rule(self, rule: HealthRule) -> HealthRule:
        """Add (or replace, by name) one rule."""
        self.rules = [r for r in self.rules if r.name != rule.name]
        self.rules.append(rule)
        return rule

    def rule(self, name: str, getter, warn: float, crit: float,
             description: str = "") -> HealthRule:
        return self.add_rule(HealthRule(name, getter, warn, crit,
                                        description))

    def remove_rule(self, name: str):
        self.rules = [r for r in self.rules if r.name != name]

    def clear(self):
        self.rules = []

    def evaluate(self) -> dict:
        """{"status": worst-of-rules, "rules": [per-rule dicts]}.
        No rules installed → OK (an unconfigured probe must not page)."""
        results = [r.evaluate() for r in self.rules]
        worst = max((r["status"] for r in results),
                    key=_ORDER.__getitem__, default="OK")
        return {"status": worst, "rules": results}


def install_default_rules(ev: HealthEvaluator,
                          registry=None) -> HealthEvaluator:
    """The stock rule set. Thresholds are deliberately loose — they flag
    "clearly on fire", not "worth a look"; tighten per deployment via
    ``HEALTH.rule(...)`` (same name replaces)."""
    ev.rule("nan_skip_rate",
            counter_ratio("train_nan_skips_total", "train_steps_total",
                          registry),
            warn=0.05, crit=0.25,
            description="fraction of optimizer steps skipped on "
                        "non-finite loss")
    ev.rule("serving_queue_wait_p95_s",
            histogram_quantile("serving_queue_wait_seconds", 0.95, registry),
            warn=1.0, crit=5.0,
            description="p95 submission→admission wait")
    ev.rule("prefetch_stall_ratio",
            histogram_sum_ratio("io_prefetch_stall_seconds",
                                "train_step_seconds", registry),
            warn=0.2, crit=0.5,
            description="host seconds stalled waiting on the input "
                        "pipeline per second of stepping")
    ev.rule("ckpt_crc_failures",
            counter_value("ckpt_crc_failures_total", registry),
            warn=1, crit=3,
            description="array CRC mismatches caught on checkpoint load")
    ev.rule("elastic_restarts",
            counter_value("elastic_restarts_total", registry),
            warn=1, crit=3,
            description="elastic restarts taken after failures")
    ev.rule("serving_waste_ratio",
            counter_share("serving_waste_total",
                          ("serving_goodput_tokens_total",
                           "serving_waste_total"), registry),
            warn=0.6, crit=0.95,
            description="wasted device tokens / all accounted device "
                        "tokens (goodput ledger): spec rejects, replay "
                        "re-prefill, padding rows, capacity drops")
    ev.rule("serving_decode_mbu_collapse",
            gauge_deficit("serving_mbu", registry, phase="decode"),
            warn=0.95, crit=0.99,
            description="1 - serving_mbu{decode}: decode is bandwidth-"
                        "bound at continuous-batching sizes, so MBU "
                        "below ~5% on real hardware means the tick is "
                        "nowhere near the HBM roof (skipped while MBU "
                        "reads 0.0 = undefined, e.g. on the CPU)")
    ev.rule("serving_kv_fragmentation",
            gauge_value("serving_kv_fragmentation", registry),
            warn=0.25, crit=0.6,
            description="window-recycling holes / (holes + live KV "
                        "table entries): high means block tables are "
                        "mostly None placeholders — capacity burned on "
                        "positions nothing will ever attend again")
    ev.rule("serving_kv_parked_ratio",
            kv_parked_ratio(registry),
            warn=0.9, crit=0.995,
            description="radix-parked blocks / KV pool size: near 1.0 "
                        "the whole pool is cache residue and every "
                        "admission pays an eviction walk (skipped while "
                        "PT_RADIX_CACHE=0 or before the pool gauges "
                        "exist)")
    ev.rule("serving_tick_host_p95_s",
            histogram_quantile("serving_tick_breakdown_seconds", 0.95,
                               registry, phase="host"),
            warn=0.25, crit=2.5,
            description="p95 host-bookkeeping share of an engine tick "
                        "(the tick-anatomy remainder after prefill/"
                        "draft/verify/sample device phases)")
    ev.rule("serving_degrade_level",
            gauge_value("serving_degrade_level", registry),
            warn=2, crit=4,
            description="degradation-ladder rung: L2+ is shrinking "
                        "prefill budgets, L4 rejects new sessions. NOTE "
                        "this rule reads the gauge the controller "
                        "writes — never feed THIS evaluator back into "
                        "DegradationController(health=...), or the rung "
                        "becomes its own input and latches")
    ev.rule("serving_slo_burn_rate",
            gauge_max("serving_slo_burn_rate", registry),
            warn=6.0, crit=14.4,
            description="hottest tenant/objective short-window SLO "
                        "error-budget burn multiple (1.0 = spending "
                        "exactly the budget): 6x is the tracker's slow-"
                        "burn gate, 14.4x its fast-burn page threshold")
    ev.rule("serving_slo_budget_spent",
            gauge_max("serving_slo_budget_remaining", registry,
                      deficit=True),
            warn=0.8, crit=1.0,
            description="worst tenant/objective fraction of the "
                        "compliance-window error budget already "
                        "consumed (1 - serving_slo_budget_remaining)")
    ev.rule("router_hedge_rate",
            gauge_value("router_hedge_rate", registry),
            warn=0.2, crit=0.6,
            description="hedged / successful KV handoffs (lifetime): "
                        "sustained hedging means a straggling decode "
                        "replica or transport link")
    return ev


HEALTH = install_default_rules(HealthEvaluator())
