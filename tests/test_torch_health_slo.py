"""The port's health evaluator, SLO tracker and cost ledger against the
JAX package's.

Each test writes the same metric feeds into both packages' registries
(the reference's ``paddle_tpu.observability.METRICS`` and the port's own)
on an injected clock, then holds the port's readings to the reference's:

* ``HealthEvaluator.evaluate()`` under the default rules, and every
  getter factory on its own;
* ``SLOTracker`` burn rates, budgets, breaches, ``snapshot()`` and
  ``tenants_snapshot()``;
* the ``CostLedger`` (the GOODPUT sink and ``charge_tick``) and the
  ``PT_SLO=0`` kill switch;
* the metric names the health rules and the ladder's signals read:
  every one the reference's serving path registers, the port registers
  under the same name, kind and labels.

Tolerance: exact, or 1e-12 relative where a float sum is involved.
"""
import math
import types

import numpy as np
import pytest

import paddle_tpu.serving  # noqa: F401  (registers the serving metrics)
from paddle_tpu.observability import GOODPUT as J_GOODPUT
from paddle_tpu.observability import METRICS as J_METRICS
from paddle_tpu.observability import health as J_HEALTH
from paddle_tpu.observability import slo as J_SLO
from paddle_tpu.serving import degrade as J_DEGRADE
from paddle_tpu.serving import telemetry as J_TEL
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS, health, slo)
from paddle_tpu_torch.serving import degrade
from paddle_tpu_torch.serving import telemetry as TEL

SIDES = ((J_METRICS, J_HEALTH, J_SLO, J_GOODPUT, J_TEL),
         (METRICS, health, slo, GOODPUT, TEL))


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        METRICS.reset()
        FLIGHT.clear()
        REQUESTS.disable()
        REQUESTS.clear()
        GOODPUT.attach_sink(None)
        TEL.reset_tenant_labels()
        J_TEL.reset_tenant_labels()
    clean()
    yield
    clean()


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _both(name, op, *args, **labels):
    """Apply one metric write to the same-named instrument of both
    registries."""
    for reg, *_ in SIDES:
        getattr(reg.get(name), op)(*args, **labels)


def _close(a, b, path="doc"):
    """Equal structures, floats within 1e-12 relative (NaN == NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            assert a is b, (path, a, b)
        elif math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), (path, a, b)
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=1e-15), (path, a, b)
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------------ health
# metric feeds that push each default rule through OK / WARN / CRIT
FEEDS = {
    "idle": [],
    "queue_wait_warn": [("serving_queue_wait_seconds", "observe", 2.0, {})]
    * 20,
    "queue_wait_crit": [("serving_queue_wait_seconds", "observe", 9.0, {})]
    * 20,
    "waste": [("serving_goodput_tokens_total", "inc", 10, {}),
              ("serving_waste_total", "inc", 90, {"why": "pad_rows"})],
    "mbu_collapse": [("serving_mbu", "set", 0.02, {"phase": "decode"})],
    "mbu_undefined": [("serving_mbu", "set", 0.0, {"phase": "decode"})],
    "fragmentation": [("serving_kv_fragmentation", "set", 0.4, {})],
    "parked": [("serving_kv_pool_blocks", "set", 100, {}),
               ("serving_kv_blocks", "set", 99.6, {"state": "parked"})],
    "host_tick": [("serving_tick_breakdown_seconds", "observe", 0.5,
                   {"phase": "host"})] * 5,
    "ladder": [("serving_degrade_level", "set", 4, {})],
    "burn": [("serving_slo_burn_rate", "set", 7.0,
              {"tenant": "a", "objective": "ttft_p95"}),
             ("serving_slo_burn_rate", "set", 20.0,
              {"tenant": "b", "objective": "availability"})],
    "budget": [("serving_slo_budget_remaining", "set", 0.1,
                {"tenant": "a", "objective": "ttft_p95"})],
}


@pytest.mark.parametrize("feed", sorted(FEEDS))
def test_default_rules_give_the_reference_verdicts(feed):
    for name, op, v, labels in FEEDS[feed]:
        _both(name, op, v, **labels)
    want = J_HEALTH.HEALTH.evaluate()
    got = health.HEALTH.evaluate()
    _close(got, want)
    assert [r["name"] for r in got["rules"]] == \
        [r.name for r in J_HEALTH.HEALTH.rules]
    if feed != "idle":
        assert got["status"] != "OK" or feed == "mbu_undefined", got


GETTERS = {
    "counter_value": lambda m: m.counter_value("serving_tokens_total"),
    "gauge_value": lambda m: m.gauge_value("serving_queue_depth"),
    "counter_ratio": lambda m: m.counter_ratio("serving_preemptions_total",
                                               "serving_admissions_total"),
    "counter_share": lambda m: m.counter_share(
        "serving_waste_total", ("serving_goodput_tokens_total",
                                "serving_waste_total")),
    "gauge_imbalance": lambda m: m.gauge_imbalance("serving_slo_burn_rate"),
    "gauge_max": lambda m: m.gauge_max("serving_slo_burn_rate"),
    "gauge_max_deficit": lambda m: m.gauge_max(
        "serving_slo_budget_remaining", deficit=True),
    "histogram_quantile": lambda m: m.histogram_quantile(
        "serving_tick_breakdown_seconds", 0.9, phase="host"),
    "gauge_deficit": lambda m: m.gauge_deficit("serving_mbu",
                                               phase="decode"),
    "kv_parked_ratio": lambda m: m.kv_parked_ratio(),
    "histogram_sum_ratio": lambda m: m.histogram_sum_ratio(
        "serving_ttft_seconds", "serving_tick_seconds"),
}


@pytest.mark.parametrize("radix", ["1", "0"])
@pytest.mark.parametrize("getter", sorted(GETTERS))
def test_getter_factories_read_as_the_reference(getter, radix, monkeypatch):
    monkeypatch.setenv("PT_RADIX_CACHE", radix)
    make = GETTERS[getter]
    reads = []
    for step in range(3):
        reads.append((make(J_HEALTH)(), make(health)()))
        _both("serving_tokens_total", "inc", 3 + step)
        _both("serving_queue_depth", "set", 2 * step)
        _both("serving_preemptions_total", "inc", step)
        _both("serving_admissions_total", "inc", 4)
        _both("serving_waste_total", "inc", step, why="pad_rows")
        _both("serving_goodput_tokens_total", "inc", 5)
        _both("serving_slo_burn_rate", "set", 1.5 * step,
              tenant=f"t{step}", objective="ttft_p95")
        _both("serving_slo_budget_remaining", "set", 1.0 - 0.3 * step,
              tenant=f"t{step}", objective="ttft_p95")
        _both("serving_tick_breakdown_seconds", "observe", 0.01 * (step + 1),
              phase="host")
        _both("serving_mbu", "set", 0.3 * step, phase="decode")
        _both("serving_kv_pool_blocks", "set", 64)
        _both("serving_kv_blocks", "set", 10 * step, state="parked")
        _both("serving_ttft_seconds", "observe", 0.2)
        _both("serving_tick_seconds", "observe", 0.05)
    reads.append((make(J_HEALTH)(), make(health)()))
    for want, got in reads:
        _close(got, want)


def test_rules_evaluator_and_broken_probe_behave_as_the_reference():
    for m in (J_HEALTH, health):
        with pytest.raises(ValueError, match="crit"):
            m.HealthRule("x", lambda: 0.0, warn=2, crit=1)
    docs = []
    for m in (J_HEALTH, health):
        ev = m.HealthEvaluator()
        assert ev.evaluate() == {"status": "OK", "rules": []}
        ev.rule("a", lambda: 0.5, warn=0.4, crit=0.9)
        ev.rule("b", lambda: float("nan"), warn=0.1, crit=0.2)

        def boom():
            raise RuntimeError("probe down")
        ev.rule("c", boom, warn=1, crit=2)
        first = ev.evaluate()
        ev.rule("c", lambda: 0.0, warn=1, crit=2)     # same name replaces
        ev.remove_rule("a")
        second = ev.evaluate()
        ev.clear()
        docs.append((first, second, ev.evaluate()))
    assert docs[0] == docs[1]
    assert docs[1][0]["status"] == "CRIT"
    assert docs[1][0]["rules"][2]["error"] == "RuntimeError: probe down"
    assert docs[1][1]["status"] == "OK"


# ------------------------------------------------------------- SLO tracker
def _trackers(objectives, **kw):
    clocks = (_Clock(), _Clock())
    return clocks, (J_SLO.SLOTracker(objectives, clock=clocks[0], **kw),
                    slo.SLOTracker(objectives, clock=clocks[1], **kw))


def _objs(m, spec):
    return {t: [m.Objective(*a, **k) for a, k in objs]
            for t, objs in spec.items()}


def _same_tracker_state(jt, tt):
    _close(tt.state, jt.state)
    js, ts = jt.snapshot(), tt.snapshot()
    js.pop("tracker"), ts.pop("tracker")
    _close(ts, js)
    jl, tl = jt.tenants_snapshot(), tt.tenants_snapshot()
    jl.pop("tracker"), tl.pop("tracker")
    _close(tl, jl)
    for name in ("serving_slo_burn_rate", "serving_slo_budget_remaining",
                 "serving_slo_breaches_total"):
        _close({k: c[0] for k, c in METRICS.get(name)._series.items()},
               {k: c[0] for k, c in J_METRICS.get(name)._series.items()},
               name)


SCRIPTS = {
    # (tenant objectives, [(dt, [(metric, op, value, labels), ...]), ...])
    "availability": (
        {"*": [(("availability",), dict(target=0.999, window_s=60.0,
                                        short_s=10.0))]},
        [(5.0, [("serving_tenant_finished_total", "inc", 18,
                 {"tenant": "acme", "reason": "eos"}),
                ("serving_tenant_finished_total", "inc", 2,
                 {"tenant": "acme", "reason": "timeout"}),
                ("serving_finished_total", "inc", 20, {"reason": "eos"})]),
         (1.0, [("serving_tenant_rejections_total", "inc", 5,
                 {"tenant": "acme"}),
                ("serving_rejections_total", "inc", 5,
                 {"reason": "degraded"})]),
         (30.0, []), (70.0, [])]),
    "latency_bounds": (
        {"lat": [(("ttft_p95",), dict(target=0.1, budget=0.5, window_s=60.0,
                                      short_s=60.0, fast_burn=1.0,
                                      slow_burn=1.0))]},
        [(1.0, [("serving_tenant_ttft_seconds", "observe", v,
                 {"tenant": "lat"}) for v in (0.04, 0.1, 0.11, 0.3)]),
         (1.0, [("serving_ttft_seconds", "observe", 2.0, {})])]),
    "multi_window_gate": (
        {"t": [(("availability",), dict(target=0.99, window_s=100.0,
                                        short_s=10.0))]},
        [(10.0, [("serving_tenant_finished_total", "inc", 1000,
                  {"tenant": "t", "reason": "eos"})]),
         (85.0, [("serving_tenant_finished_total", "inc", 10,
                  {"tenant": "t", "reason": "timeout"})]),
         (1.0, [("serving_tenant_finished_total", "inc", 200,
                 {"tenant": "t", "reason": "timeout"})]),
         (1.0, [("serving_tenant_finished_total", "inc", 50,
                 {"tenant": "t", "reason": "timeout"})]),
         (153.0, [])]),
    "defaults_mixed": (
        None,
        [(1.0, [("serving_queue_wait_seconds", "observe", 0.3, {}),
                ("serving_tenant_queue_wait_seconds", "observe", 2.0,
                 {"tenant": "x"}),
                ("serving_token_latency_seconds", "observe", 0.5, {}),
                ("serving_tenant_token_latency_seconds", "observe", 0.01,
                 {"tenant": "y"}),
                ("serving_tenant_finished_total", "inc", 3,
                 {"tenant": "y", "reason": "length"})]),
         (400.0, [("serving_ttft_seconds", "observe", 0.05, {})]),
         (4000.0, [])]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_tracker_burn_budget_and_breaches_equal_the_reference(script):
    spec, steps = SCRIPTS[script]
    objs = (None, None) if spec is None else (_objs(J_SLO, spec),
                                              _objs(slo, spec))
    clocks = (_Clock(), _Clock())
    jt = J_SLO.SLOTracker(objs[0], clock=clocks[0])
    tt = slo.SLOTracker(objs[1], clock=clocks[1])
    jt.poll(), tt.poll()
    _same_tracker_state(jt, tt)
    for dt, writes in steps:
        for name, op, v, labels in writes:
            _both(name, op, v, **labels)
        for c in clocks:
            c.t += dt
        jt.poll(), tt.poll()
        _same_tracker_state(jt, tt)
    assert tt.polls == jt.polls == len(steps) + 1
    assert [e["kind"] for e in FLIGHT.events()].count("serving.slo_breach") \
        == len(jt.breaches)


def test_objective_validation_matches_the_reference():
    bad = [(("tail_latency",), dict(target=1.0)),
           (("availability",), dict(target=1.0)),
           (("ttft_p95",), dict(target=1.0, short_s=10.0, window_s=5.0)),
           (("ttft_p95",), dict(target=1.0, budget=0.0)),
           (("ttft_p95",), dict(target=0.0))]
    for a, k in bad:
        errs = []
        for m in (J_SLO, slo):
            with pytest.raises(ValueError) as ei:
                m.Objective(*a, **k)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    assert [o.describe() for o in slo.default_objectives()] == \
        [o.describe() for o in J_SLO.default_objectives()]
    for m in (J_SLO, slo):
        with pytest.raises(ValueError, match="duplicate objective"):
            m.SLOTracker([m.Objective("ttft_p95", target=1.0),
                          m.Objective("ttft_p95", target=2.0)])


# ------------------------------------------------------------ cost ledger
def test_goodput_sink_and_ledger_equal_the_reference():
    jt, tt = J_SLO.SLOTracker(), slo.SLOTracker()
    for g in (J_GOODPUT, GOODPUT):
        g.good(5, tenant="a")
        g.good(3)
        g.waste("pad_rows", 4)
        g.waste("spec_rejected", 2, tenant="a")
        g.waste("spec_rejected", 0, tenant="a")
        g.saved(6, tenant="b")
    for jl, tl in ((jt.ledger, tt.ledger),):
        assert tl.good_tokens == jl.good_tokens == {
            "a": 5, slo.SYSTEM_TENANT: 3}
        assert tl.waste_tokens == jl.waste_tokens
        assert tl.saved_tokens == jl.saved_tokens == {"b": 6}
        assert tl.snapshot() == jl.snapshot()
    assert tt.ledger.good_total() == GOODPUT.good_total()
    assert tt.ledger.waste_total() == GOODPUT.waste_total()
    led = slo.CostLedger()
    led.good("a", 2)
    led.waste("a", "pad_rows", 1)
    led.saved(None, 3)
    assert led.tenants() == sorted(["a", slo.SYSTEM_TENANT])


def _fake_engine(slot_req, active, prefilling, groups, tenants, live=None):
    reqs = {rid: types.SimpleNamespace(tenant_id=t)
            for rid, t in tenants.items()}
    led = types.SimpleNamespace(enabled=live is not None,
                                _req_live=dict(live or {}))
    return types.SimpleNamespace(
        slot_req=np.array(slot_req), active=np.array(active),
        prefilling=dict(prefilling), groups=dict(groups), requests=reqs,
        kv=types.SimpleNamespace(ledger=led))


@pytest.mark.parametrize("seconds", [0.1, 0.25, 1e-7, 3.3])
def test_charge_tick_splits_as_the_reference(seconds):
    jt, tt = J_SLO.SLOTracker(), slo.SLOTracker()
    engines = [
        _fake_engine([1, 2, -1], [True, True, True], {3: None}, {},
                     {1: "a", 2: "b", 3: None},
                     live={1: 4, 2: 0, (3, 7): 2}),
        _fake_engine([-1], [True], {}, {}, {}),
        _fake_engine([5, 6], [True, False], {}, {9: None},
                     {5: "a", 6: "c", 9: "beam"}, live={9: 3, 5: 1}),
    ]
    for eng in engines:
        jt.charge_tick(eng, seconds)
        tt.charge_tick(eng, seconds)
    assert tt.ledger.device_seconds == jt.ledger.device_seconds
    assert tt.ledger.block_seconds == jt.ledger.block_seconds
    assert tt.ledger.snapshot() == jt.ledger.snapshot()
    assert sum(tt.ledger.device_seconds.values()) == pytest.approx(
        tt.ledger.device_seconds_total, rel=1e-12)
    assert slo.IDLE_TENANT in tt.ledger.device_seconds
    _close({k: c[0] for k, c in
            METRICS.get("serving_tenant_device_seconds_total")
            ._series.items()},
           {k: c[0] for k, c in
            J_METRICS.get("serving_tenant_device_seconds_total")
            ._series.items()})


def test_kill_switch_leaves_both_trackers_inert(monkeypatch):
    monkeypatch.setenv("PT_SLO", "0")
    assert not slo.slo_enabled() and not J_SLO.slo_enabled()
    jt, tt = J_SLO.SLOTracker(), slo.SLOTracker()
    eng = _fake_engine([1], [True], {}, {}, {1: "a"}, live={1: 2})
    for t, g in ((jt, J_GOODPUT), (tt, GOODPUT)):
        t.poll()
        t.charge_tick(eng, 0.5)
        g.good(4, tenant="a")
    for t in (jt, tt):
        assert t.polls == 0 and t.state == {} and t.ledger.ticks == 0
        assert t.ledger.snapshot()["tenants"] == {}
    for name in ("serving_slo_burn_rate", "serving_slo_budget_remaining",
                 "serving_tenant_device_seconds_total",
                 "serving_tenant_kv_block_seconds_total"):
        assert METRICS.get(name)._series == {}, name
    assert slo.slo_doc()["enabled"] is False
    assert slo.tenants_doc()["enabled"] is False
    monkeypatch.delenv("PT_SLO")
    tt.poll()
    assert tt.polls == 1


# ------------------------------------------------------ names by contract
class _Recorder:
    """A registry that records every name read through it."""

    def __init__(self, reg):
        self.reg, self.names = reg, set()

    def get(self, name):
        self.names.add(name)
        return self.reg.get(name)


def _names_read(health_mod, degrade_mod, reg):
    rec = _Recorder(reg)
    health_mod.install_default_rules(health_mod.HealthEvaluator(),
                                     registry=rec).evaluate()
    c = degrade_mod.DegradationController(
        registry=rec, signals=degrade_mod.default_signals(slo_burn=True))
    c.poll()
    c.poll()
    return rec.names


def test_every_name_the_rules_and_signals_read_is_registered_alike():
    """A metric the port spelled differently would read 0.0 without a
    word. The serving engine's names start with ``serving_`` and the
    router's with ``router_`` (the stock imbalance rule reads
    ``router_replica_outstanding``; every router instrument is held to
    the reference's type and label names); the trainer's (``train_*``,
    ``io_*``, ``ckpt_*``, ``elastic_*``) are outside the port."""
    import paddle_tpu.serving.router  # noqa: F401  (registers router_*)
    import paddle_tpu_torch.serving.router  # noqa: F401
    read = _names_read(J_HEALTH, J_DEGRADE, J_METRICS)
    assert read == _names_read(health, degrade, METRICS)
    serving = {n for n in read if n in J_METRICS._instruments
               and n.startswith("serving_")}
    assert {"serving_degrade_level", "serving_slo_burn_rate",
            "serving_kv_stall_total", "serving_goodput_tokens_total",
            "serving_waste_total", "serving_queue_wait_seconds",
            "serving_mbu", "serving_kv_block_utilization"} <= serving
    router = {n for n in J_METRICS._instruments if n.startswith("router_")}
    assert len(router) == 12 and "router_kv_transfer_seconds" in router
    for name in sorted(serving | router):
        j, t = J_METRICS.get(name), METRICS.get(name)
        assert t is not None, f"the port never registers {name}"
        assert type(t).__name__ == type(j).__name__, name
        assert t.labelnames == j.labelnames, name


NEW_INSTRUMENTS = (
    "serving_tenant_tokens_total", "serving_tenant_admissions_total",
    "serving_tenant_queue_wait_seconds", "serving_tenant_waste_tokens_total",
    "serving_tenant_ttft_seconds", "serving_tenant_token_latency_seconds",
    "serving_tenant_finished_total", "serving_tenant_rejections_total",
    "serving_tenant_label_overflow_total", "serving_degrade_level",
    "serving_degrade_transitions_total", "serving_degrade_shed_total",
    "serving_tenant_throttled_total", "serving_slo_burn_rate",
    "serving_slo_budget_remaining", "serving_slo_breaches_total",
    "serving_tenant_device_seconds_total",
    "serving_tenant_kv_block_seconds_total", "device_bytes_in_use",
    "device_bytes_peak", "device_bytes_limit")


@pytest.mark.parametrize("name", NEW_INSTRUMENTS)
def test_new_instruments_match_the_reference(name):
    if name.startswith("device_"):
        import paddle_tpu.utils.profiler  # noqa: F401  (registers them)
    j, t = J_METRICS.get(name), METRICS.get(name)
    assert t is not None and j is not None, name
    assert (type(t).__name__, t.help, t.labelnames) == \
        (type(j).__name__, j.help, j.labelnames)
    if hasattr(j, "buckets"):
        assert tuple(t.buckets) == tuple(j.buckets)
