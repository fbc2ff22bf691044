"""The port's tenant admission and usage metering against the JAX
package's engine.

* With tenants and weights (and a tenant without a weight, and
  untenanted requests), both engines admit the same requests in the
  same order and give token-identical streams — synchronous and at
  ``async_depth=2``, with and without preemption — and charge the same
  deficits.
* A saturating tenant does not starve a light one, with and without an
  ``AdapterStore`` (the two tenant tests of the reference's
  ``test_serving_multilora.py``); weights are validated.
* The ``CostLedger``'s tokens by tenant equal the reference engine's
  (speculative decoding, preemption, injected faults); its
  device-seconds reconcile with ``serving_tick_seconds`` after every
  tick, also at ``async_depth=2``.
* The ``tenant_label`` cardinality guard collapses tenants past
  ``PT_TENANT_LABEL_CAP`` as the reference's does.

Same weights (fp32, CPU). Tolerance: exact; the tick reconciliation is
bit-exact for the total and 1e-12 relative for the sum of shares.
"""
import numpy as np
import pytest

from paddle_tpu.observability import GOODPUT as J_GOODPUT
from paddle_tpu.observability import METRICS as J_METRICS
from paddle_tpu.observability.slo import SLOTracker as JTracker
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import telemetry as J_TEL
from paddle_tpu.serving.adapters import AdapterStore as JStore
from paddle_tpu.utils.faults import FAULTS as J_FAULTS
from paddle_tpu.utils.faults import InjectedFault as JInjected
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS, SLOTracker)
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import telemetry as TEL
from paddle_tpu_torch.serving.adapters import AdapterStore
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import tiny_pair
from tests.test_torch_multilora import make_adapter

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def drafts():
    return tiny_pair(seed=3, **{**TINY, "num_hidden_layers": 1})


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        FAULTS.clear()
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


def _series(reg, name):
    inst = reg.get(name)
    return {} if inst is None else {k: c[0] for k, c in inst._series.items()}


TENANT_SERIES = ("serving_tenant_admissions_total",
                 "serving_tenant_tokens_total",
                 "serving_tenant_finished_total",
                 "serving_tenant_waste_tokens_total")


# ------------------------------------------------------ weighted fair share
def _mix(seed=21):
    rs = np.random.RandomState(seed)
    tenants = ["A", "A", "B", "A", "C", None, "B", "A", "C", "B", None, "A"]
    return [(rs.randint(0, 64, (int(rs.randint(3, 14)),)),
             int(rs.randint(3, 9)), t) for t in tenants]


def _serve_tenants(eng, req_cls, mix):
    trail = []

    def stream(req, tok):
        trail.append((req.req_id, int(tok)))
    eng.sched.set_tenant_weight("A", 2.0)
    eng.sched.set_tenant_weight("B", 1.0)
    ids = [eng.add_request(req_cls(p, max_new_tokens=n, tenant_id=t,
                                   stream=stream))
           for p, n, t in mix]
    eng.run()
    return trail, [list(map(int, eng.requests[i].tokens)) for i in ids]


@pytest.mark.parametrize("preemption", [False, True])
@pytest.mark.parametrize("async_depth", [0, 2])
def test_weighted_tenants_admit_and_stream_as_the_reference(
        pair, async_depth, preemption):
    jm, tm = pair
    kw = dict(num_slots=3, block_size=4, max_prompt_len=16, max_seq_len=32,
              async_depth=async_depth, preemption=preemption)
    if preemption:
        kw["num_blocks"] = 8
    mix = _mix()
    jeng, teng = JEngine(jm, **kw), LLMEngine(tm, **kw)
    want = _serve_tenants(jeng, JRequest, mix)
    got = _serve_tenants(teng, Request, mix)
    assert got == want
    assert teng.sched.tenant_charged == jeng.sched.tenant_charged
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    if preemption:
        assert teng.stats["preemptions"] > 0
    for name in TENANT_SERIES:
        assert _series(METRICS, name) == _series(J_METRICS, name), name
    assert sum(_series(METRICS, "serving_tenant_tokens_total").values()) \
        == sum(len(t) for t, (_, _, ten) in zip(got[1], mix)
               if ten is not None)
    teng.assert_quiescent()


def test_untenanted_queue_stays_fcfs(pair):
    jm, tm = pair
    kw = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=32)
    mix = [(p, n, None) for p, n, _ in _mix(22)]
    got = _serve_tenants(LLMEngine(tm, **kw), Request, mix)
    assert got == _serve_tenants(JEngine(jm, **kw), JRequest, mix)
    firsts = []
    for rid, _ in got[0]:
        if rid not in firsts:
            firsts.append(rid)
    assert firsts == sorted(firsts)         # first tokens in arrival order


# ------------------------------------------- the multi-LoRA tenant tests
def _stores(pair):
    jm, tm = pair
    js, ts = JStore(jm, capacity=2, max_rank=4), AdapterStore(
        tm, capacity=2, max_rank=4)
    for s in (js, ts):
        s.register("t1", make_adapter(tm, 1))
    return js, ts


@pytest.mark.parametrize("with_store", [False, True])
def test_fair_admission_light_tenant_not_starved(pair, with_store):
    """One slot, four queued requests from a saturating tenant plus one
    from a light tenant enqueued LAST: the light tenant is served well
    before the heavy backlog drains (FCFS would serve it last), in the
    reference's order."""
    orders = []
    stores = _stores(pair) if with_store else (None, None)
    for model, cls, req_cls, store in zip(pair, (JEngine, LLMEngine),
                                          (JRequest, Request), stores):
        order = []

        def track(req, tok, order=order):
            if len(req.tokens) == 1:
                order.append(req.tenant_id)

        eng = cls(model, num_slots=1, block_size=4, max_prompt_len=16,
                  max_seq_len=24, adapter_store=store)
        aid = "t1" if with_store else None
        for i in range(4):
            eng.add_request(req_cls(np.arange(1 + i, 6 + i, dtype=np.int32),
                                    max_new_tokens=3, tenant_id="heavy",
                                    stream=track, adapter_id=aid))
        eng.add_request(req_cls(np.arange(9, 14, dtype=np.int32),
                                max_new_tokens=3, tenant_id="light",
                                stream=track))
        eng.run()
        eng.assert_quiescent()
        orders.append(order)
    assert orders[1] == orders[0]
    assert len(orders[1]) == 5
    assert orders[1].index("light") <= 2, orders[1]
    assert orders[1][-1] == "heavy"


def test_tenant_weight_validation(pair):
    eng = LLMEngine(pair[1], num_slots=3, block_size=4, max_prompt_len=16,
                    max_seq_len=24, adapter_store=_stores(pair)[1])
    eng.sched.set_tenant_weight("gold", 4.0)
    assert eng.sched.tenant_weights["gold"] == 4.0
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="positive"):
            eng.sched.set_tenant_weight("bad", bad)
    assert "bad" not in eng.sched.tenant_weights


# ---------------------------------------------------------- cost ledger
class _Audit:
    """After every charge, the tracker's device-seconds total equals the
    tick histogram's sum of its own registry, and the shares sum to it."""

    def __init__(self, tracker, registry):
        self.tracker, self.registry = tracker, registry
        self.ticks = 0
        orig = tracker.charge_tick

        def charge(engine, seconds):
            orig(engine, seconds)
            led = tracker.ledger
            tick = registry.get("serving_tick_seconds")
            assert led.device_seconds_total == sum(
                s.sum for s in tick._series.values())
            assert sum(led.device_seconds.values()) == pytest.approx(
                led.device_seconds_total, rel=1e-12, abs=1e-15)
            assert sum(led.block_seconds.values()) == pytest.approx(
                led.block_seconds_total, rel=1e-12, abs=1e-15)
            self.ticks += 1
        tracker.charge_tick = charge


@pytest.mark.parametrize("mode", ["spec_chaos", "async"])
def test_cost_ledger_by_tenant_equals_the_reference(pair, drafts, mode):
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 64, (int(n),)) for n in rs.randint(3, 14, 6)]
    kw = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=48,
              preemption=True)
    ledgers = []
    for side in ("ref", "port"):
        jside = side == "ref"
        faults = J_FAULTS if jside else FAULTS
        exc = JInjected if jside else InjectedFault
        if mode == "spec_chaos":
            faults.install("serving.spec_verify", on={2, 5}, exc=exc)
            ekw = dict(draft_model=drafts[0 if jside else 1], spec_k=3)
        else:
            ekw = dict(async_depth=2)
        faults.install("serving.preempt", every=5, times=4,
                       action=lambda ctx: ctx["engine"]._preempt())
        tr = JTracker() if jside else SLOTracker()
        audit = _Audit(tr, J_METRICS if jside else METRICS)
        eng = (JEngine if jside else LLMEngine)(
            pair[0 if jside else 1], slo=tr, **kw, **ekw)
        req_cls = JRequest if jside else Request
        for i, p in enumerate(prompts):
            eng.add_request(req_cls(p, max_new_tokens=8,
                                    tenant_id="acme" if i % 2 else "beta"))
        eng.run()
        eng.assert_quiescent()
        faults.clear()
        led = tr.ledger
        ledgers.append((led.good_tokens, led.waste_tokens, led.saved_tokens,
                        eng.stats["preemptions"], audit.ticks))
        g = J_GOODPUT if jside else GOODPUT
        assert led.good_total() == g.good_total()
        assert led.waste_total() == g.waste_total()
        assert led.saved_total() == g.saved_total()
        assert audit.ticks == led.ticks > 0
        assert {"acme", "beta"} <= set(led.tenants())
        assert led.device_seconds["acme"] > 0 and \
            led.block_seconds["acme"] > 0
    assert ledgers[1] == ledgers[0]
    assert ledgers[1][3] > 0                         # preemption bit
    if mode == "spec_chaos":
        by_why = {}
        for by in ledgers[1][1].values():
            for why, n in by.items():
                by_why[why] = by_why.get(why, 0) + n
        assert by_why.get("chaos_abort", 0) > 0      # the fault bit too
    assert _series(METRICS, "serving_tenant_tokens_total") == \
        _series(J_METRICS, "serving_tenant_tokens_total")


# ---------------------------------------------------- cardinality guard
def test_tenant_label_cardinality_guard(monkeypatch):
    monkeypatch.setenv("PT_TENANT_LABEL_CAP", "2")
    seq = ["t1", "t2", "t3", 999, "t1", "t2", "t4"]
    assert [TEL.tenant_label(t) for t in seq] == \
        [J_TEL.tenant_label(t) for t in seq] == \
        ["t1", "t2", "__overflow__", "__overflow__", "t1", "t2",
         "__overflow__"]
    assert TEL.TENANT_OVERFLOW_LABEL == J_TEL.TENANT_OVERFLOW_LABEL
    assert _series(METRICS, "serving_tenant_label_overflow_total") == \
        {(): 3.0}
    tr = SLOTracker()                 # the guard protects the ledger rows
    GOODPUT.good(1, tenant="t9")
    assert tr.ledger.good_tokens == {"__overflow__": 1}
    monkeypatch.setenv("PT_TENANT_LABEL_CAP", "not a number")
    TEL.reset_tenant_labels()
    assert TEL.tenant_label("t3") == "t3"      # default cap 64
