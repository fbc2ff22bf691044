"""The port's degradation ladder against the JAX package's.

* Scripted signal sequences into both controllers (one clock) give the
  same levels, ``transitions`` and flight records: hysteresis, patience,
  broken signals, forced rungs and the ``PT_DEGRADE=0`` kill switch. The
  default signals read the same windowed metric feeds alike.
* On the engines, the reference's and the port's with the same weights:
  L0 is bit-identical to an engine without a controller, L1 turns a
  draft model's speculation off, L2 shrinks chunked-prefill chunks to
  ``max_prompt_len // chunk_shrink``, L3 sheds only best-effort
  tenants, L4 rejects with ``OverloadError`` and
  ``serving_rejections_total{reason="degraded"}``. Greedy streams are
  token-identical and the shed and reject counts equal.
* The tenant token bucket throttles and refills on an injected clock;
  removing it restores unlimited admission.

Same weights (fp32, CPU). Tolerance: exact.
"""
import numpy as np
import pytest

from paddle_tpu.observability import FLIGHT as J_FLIGHT
from paddle_tpu.observability import METRICS as J_METRICS
from paddle_tpu.observability.requests import REQUESTS as J_REQUESTS
from paddle_tpu.observability.slo import SLOTracker as JTracker
from paddle_tpu.serving import DegradationController as JCtrl
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import OverloadError as JOverload
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import degrade as J_DEGRADE
from paddle_tpu.serving import telemetry as J_TEL
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS, SLOTracker)
from paddle_tpu_torch.serving import (DegradationController, LLMEngine,
                                      OverloadError, QueueFullError,
                                      Request, SessionSnapshot,
                                      default_signals)
from paddle_tpu_torch.serving import telemetry as TEL
from tests.test_torch_common import tiny_pair

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
ENG = dict(num_slots=4, block_size=4, max_prompt_len=16, max_seq_len=48)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def drafts():
    return tiny_pair(seed=3, **{**TINY, "num_hidden_layers": 1})


@pytest.fixture(autouse=True)
def _port_hygiene(monkeypatch):
    monkeypatch.delenv("PT_DEGRADE", raising=False)

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


def _series(reg, name):
    inst = reg.get(name)
    return {} if inst is None else {k: c[0] for k, c in inst._series.items()}


def _held(cls, **kw):
    """A controller that holds whatever rung a test forces: no signals,
    endless down-patience, so the engine's polls never walk it down."""
    kw.setdefault("signals", [])
    kw.setdefault("down_patience", 10 ** 9)
    return cls(**kw)


# ------------------------------------------------------------ the ladder
def _boom(c):
    raise RuntimeError("signal crashed")


# name -> (controller kwargs, [(action, arg), ...]); actions: "t" sets the
# scripted target and polls, "force" forces a rung, "kill"/"revive" flip
# PT_DEGRADE, "poll" polls with the target unchanged
SCRIPTS = {
    "climb_fast_descend_slowly": (
        dict(up_patience=1, down_patience=3),
        [("t", 0), ("t", 3), ("t", 0), ("poll", 0), ("poll", 0),
         ("poll", 0), ("poll", 0), ("poll", 0), ("t", 2), ("t", 0)]
        + [("poll", 0)] * 6),
    "up_patience": (dict(up_patience=3),
                    [("t", 4)] * 3 + [("t", 1)] * 4 + [("t", 4)] * 2),
    "broken_signal": (dict(extra=[("boom", _boom)]),
                      [("t", 2), ("t", 0)] + [("poll", 0)] * 3),
    "kill_switch": (dict(), [("t", 4), ("kill", 0), ("poll", 0),
                             ("t", 3), ("revive", 0), ("t", 4)]),
    "forced_rungs": (dict(down_patience=2),
                     [("force", 3), ("t", 0), ("t", 0), ("force", 4),
                      ("force", 9), ("force", -2), ("t", 1), ("t", 1)]),
    "flapping": (dict(down_patience=2),
                 [("t", v) for v in (2, 0, 2, 0, 0, 1, 0, 0, 0, 4, 0)]),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_signals_walk_both_ladders_alike(script, monkeypatch):
    kw, steps = SCRIPTS[script]
    kw = dict(kw)
    extra = kw.pop("extra", [])
    sig = {"target": 0}
    clocks = (_Clock(), _Clock())
    ctrls = [cls(signals=[("test", lambda c: sig["target"])] + extra,
                 clock=clk, **kw)
             for cls, clk in zip((JCtrl, DegradationController), clocks)]
    trail = [[], []]
    for i, (what, arg) in enumerate(steps):
        for clk in clocks:
            clk.t = float(i)
        if what == "kill":
            monkeypatch.setenv("PT_DEGRADE", "0")
        elif what == "revive":
            monkeypatch.delenv("PT_DEGRADE")
        for side, c in enumerate(ctrls):
            if what == "force":
                c.force_level(arg)
            else:
                if what == "t":
                    sig["target"] = arg
                c.poll()
            trail[side].append((c.level, c.active_level, c.spec_enabled(),
                                c.prefill_budget(16), c.shed_best_effort(),
                                c.accepting_sessions(),
                                dict(c.last_targets)))
    assert trail[1] == trail[0]
    assert ctrls[1].transitions == ctrls[0].transitions
    assert ctrls[1].peak_level == ctrls[0].peak_level
    assert _series(METRICS, "serving_degrade_transitions_total") == \
        _series(J_METRICS, "serving_degrade_transitions_total")
    assert _series(METRICS, "serving_degrade_level") == \
        _series(J_METRICS, "serving_degrade_level")
    kinds = [(e["kind"], e.get("frm"), e.get("to"), e.get("why"))
             for e in FLIGHT.events() if e["kind"] == "serving.degrade"]
    assert kinds == [(e["kind"], e.get("frm"), e.get("to"), e.get("why"))
                     for e in J_FLIGHT.events()
                     if e["kind"] == "serving.degrade"]


def test_controller_validation_matches_the_reference():
    for kw in (dict(up_patience=0), dict(down_patience=0),
               dict(chunk_shrink=0)):
        msgs = []
        for cls in (JCtrl, DegradationController):
            with pytest.raises(ValueError) as ei:
                cls(**kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
    assert [n for n, _ in default_signals(slo_burn=True)] == \
        ["health", "goodput", "queue_wait", "kv_pressure", "slo_burn"]
    snap = SessionSnapshot(req_id=3, prompt=np.arange(4), tokens=(7, 8))
    assert snap.resume_ids().tolist() == [0, 1, 2, 3, 7, 8]


# metric windows fed to both registries between polls of the default
# signals: [(metric, op, value, labels), ...] per poll
WINDOWS = [
    [],
    [("serving_goodput_tokens_total", "inc", 30, {}),
     ("serving_waste_total", "inc", 70, {"why": "pad_rows"})],
    [("serving_goodput_tokens_total", "inc", 10, {}),
     ("serving_waste_total", "inc", 90, {"why": "spec_rejected"})],
    [("serving_queue_wait_seconds", "observe", 1.5, {})] * 4,
    [("serving_queue_wait_seconds", "observe", 7.0, {})] * 4,
    [("serving_kv_block_utilization", "set", 0.99, {}),
     ("serving_kv_stall_total", "inc", 2, {"blocked_on": "active"})],
    [("serving_slo_burn_rate", "set", 20.0,
      {"tenant": "a", "objective": "ttft_p95"})],
    [("serving_goodput_tokens_total", "inc", 500, {})],
    [("serving_slo_burn_rate", "set", 0.0,
      {"tenant": "a", "objective": "ttft_p95"})],
] + [[]] * 16


@pytest.mark.parametrize("slo_burn", [False, True])
def test_default_signals_read_the_same_windows(slo_burn):
    clocks = (_Clock(), _Clock())
    ctrls = [cls(signals=sigs(slo_burn=slo_burn), clock=clk)
             for cls, sigs, clk in (
                 (JCtrl, J_DEGRADE.default_signals, clocks[0]),
                 (DegradationController, default_signals, clocks[1]))]
    trail = [[], []]
    for i, writes in enumerate(WINDOWS):
        for name, op, v, labels in writes:
            for reg in (J_METRICS, METRICS):
                getattr(reg.get(name), op)(v, **labels)
        for side, c in enumerate(ctrls):
            clocks[side].t = float(i)
            c.poll()
            trail[side].append((c.level, dict(c.last_targets)))
    assert trail[1] == trail[0]
    assert ctrls[1].transitions == ctrls[0].transitions
    assert max(lvl for lvl, _ in trail[1]) == 4     # queue wait hit L4
    assert trail[1][-1][0] == 0                     # and it recovered


# ---------------------------------------------------------- the engines
def _prompts(n, rs, lo=3, hi=14):
    return [rs.randint(0, 64, (int(k),)) for k in rs.randint(lo, hi, size=n)]


def _serve(eng, req_cls, prompts, max_new=10, **rkw):
    ids = [eng.add_request(req_cls(p, max_new_tokens=max_new, **rkw))
           for p in prompts]
    eng.run()
    return [list(map(int, eng.requests[i].tokens)) for i in ids]


def _engines(pair, ctrls=(None, None), slos=(None, None), **kw):
    jm, tm = pair
    args = {**ENG, **kw}
    return (JEngine(jm, degrade=ctrls[0], slo=slos[0], **args),
            LLMEngine(tm, degrade=ctrls[1], slo=slos[1], **args))


@pytest.mark.parametrize("kill", [False, True])
def test_level_zero_is_bit_identical_on_both_engines(pair, kill, monkeypatch):
    """A held L0 controller and an SLO tracker leave both engines'
    streams those of engines without them, with the kill switches
    (``PT_DEGRADE=0``, ``PT_SLO=0``) off and on."""
    if kill:
        monkeypatch.setenv("PT_DEGRADE", "0")
        monkeypatch.setenv("PT_SLO", "0")
    prompts = _prompts(6, np.random.RandomState(40))
    jplain, tplain = _engines(pair)
    want = _serve(jplain, JRequest, prompts)
    assert _serve(tplain, Request, prompts) == want
    jeng, teng = _engines(pair, (_held(JCtrl), _held(DegradationController)),
                          (JTracker(), SLOTracker()))
    assert _serve(jeng, JRequest, prompts) == want
    assert _serve(teng, Request, prompts) == want
    teng.assert_quiescent()
    assert teng.degrade.transitions == jeng.degrade.transitions == []
    ticks = teng.slo.ledger.ticks
    assert ticks == jeng.slo.ledger.ticks and (ticks == 0) == kill
    # the default signals read wall-clock windows (queue wait), so where
    # they move the ladder is the host's business; the greedy streams are
    # the same at every rung
    assert _serve(_engines(pair, (None, DegradationController()))[1],
                  Request, prompts) == want


def test_l1_turns_speculation_off_on_both(pair, drafts):
    prompts = _prompts(4, np.random.RandomState(41))
    want = _serve(_engines(pair)[0], JRequest, prompts)
    ctrls = (_held(JCtrl), _held(DegradationController))
    for c in ctrls:
        c.force_level(1)
    jeng = JEngine(pair[0], draft_model=drafts[0], spec_k=2,
                   degrade=ctrls[0], **ENG)
    teng = LLMEngine(pair[1], draft_model=drafts[1], spec_k=2,
                     degrade=ctrls[1], **ENG)
    assert _serve(jeng, JRequest, prompts) == want
    assert _serve(teng, Request, prompts) == want
    assert teng.stats["spec_ticks"] == jeng.stats["spec_ticks"] == 0
    assert not teng._spec_on() and not teng._spec_would_run()
    for c in ctrls:
        c.force_level(0)
    assert teng._spec_on()


def test_l2_shrinks_prefill_chunks_on_both(pair):
    prompts = _prompts(3, np.random.RandomState(42), lo=20, hi=30)
    kw = dict(max_prompt_len=8, max_seq_len=64)
    want = _serve(_engines(pair, **kw)[0], JRequest, prompts)
    ctrls = (_held(JCtrl, chunk_shrink=4),
             _held(DegradationController, chunk_shrink=4))
    for c in ctrls:
        c.force_level(2)
    jeng, teng = _engines(pair, ctrls, **kw)
    chunks = []
    for eng, req_cls, tracker in ((jeng, JRequest, J_REQUESTS),
                                  (teng, Request, REQUESTS)):
        tracker.enable()
        reqs = [req_cls(p, max_new_tokens=10) for p in prompts]
        for r in reqs:
            eng.add_request(r)
        eng.run()
        assert [list(map(int, r.tokens)) for r in reqs] == want
        chunks.append([e["tokens"] for r in reqs
                       for e in tracker.timeline(r.trace_id)["events"]
                       if e["kind"] == "prefill_chunk"])
        tracker.disable()
    assert chunks[1] == chunks[0]
    assert chunks[1] and max(chunks[1]) <= 8 // 4
    teng.assert_quiescent()


def test_l3_sheds_only_best_effort_on_both(pair):
    rs = np.random.RandomState(43)
    prompts = [rs.randint(0, 64, (5,)) for _ in range(4)]
    ctrls = (_held(JCtrl), _held(DegradationController))
    jeng, teng = _engines(pair, ctrls)
    done = []
    for eng, req_cls, c in ((jeng, JRequest, ctrls[0]),
                            (teng, Request, ctrls[1])):
        eng.sched.set_tenant_priority("B", "best_effort")
        c.force_level(3)
        reqs = [req_cls(p, max_new_tokens=4,
                        tenant_id="A" if i % 2 == 0 else "B")
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        for _ in range(60):
            if not eng.has_work():
                break
            eng.step()
            if all(r.done for r in reqs if r.tenant_id == "A"):
                break
        first = sorted(r.tenant_id for r in reqs if r.done)
        c.force_level(0)
        eng.run()
        done.append((first, [list(map(int, r.tokens)) for r in reqs]))
    assert done[1] == done[0]
    assert done[1][0] == ["A", "A"]
    shed = _series(METRICS, "serving_degrade_shed_total")
    assert shed == _series(J_METRICS, "serving_degrade_shed_total")
    assert shed.get(("B",), 0) > 0 and ("A",) not in shed
    teng.assert_quiescent()


def test_l4_rejects_new_sessions_on_both(pair):
    ctrls = (_held(JCtrl), _held(DegradationController))
    jeng, teng = _engines(pair, ctrls)
    for eng, req_cls, c, err in ((jeng, JRequest, ctrls[0], JOverload),
                                 (teng, Request, ctrls[1], OverloadError)):
        c.force_level(4)
        with pytest.raises(err) as ei:
            eng.add_request(req_cls(np.arange(5), max_new_tokens=4,
                                    tenant_id="T"))
        with pytest.raises(err):
            eng.add_request(req_cls(np.arange(5), max_new_tokens=4))
        c.force_level(0)
        eng.add_request(req_cls(np.arange(5), max_new_tokens=4))
        eng.run()
    assert isinstance(ei.value, QueueFullError)
    assert str(ei.value) == "degradation ladder at L4 — new sessions " \
        "rejected, retry after the cluster recovers"
    assert teng.stats["rejected"] == jeng.stats["rejected"] == 2
    for name in ("serving_rejections_total",
                 "serving_tenant_rejections_total"):
        assert _series(METRICS, name) == _series(J_METRICS, name)
    assert _series(METRICS, "serving_rejections_total") == \
        {("degraded",): 2}
    teng.assert_quiescent()


# ----------------------------------------------------- token-bucket rates
def test_tenant_rate_limit_throttles_and_refills_on_both(pair):
    rs = np.random.RandomState(44)
    prompts = [rs.randint(0, 64, (5,)) for _ in range(3)]
    out = []
    for eng, req_cls in zip(_engines(pair), (JRequest, Request)):
        clk = [0.0]
        eng.sched.clock = lambda: clk[0]
        eng.sched.set_tenant_rate("T", max_tokens_per_s=10.0, burst=10.0)
        reqs = [req_cls(p, max_new_tokens=12, tenant_id=t)
                for p, t in zip(prompts, ("T", "T", "U"))]
        for r in reqs:
            eng.add_request(r)
        eng.step()
        # the first T admission costs 5 + 12 = 17 against a 10-token
        # burst: the bucket overdraws to -7 and the second T waits
        level = eng.sched._bucket_level("T", clk[0])
        admitted = [r.req_id in eng.prefilling or bool(
            (eng.slot_req == r.req_id).any()) for r in reqs]
        clk[0] += 5.0                     # refills 50 tokens, capped at 10
        eng.run()
        out.append((level, admitted, [list(map(int, r.tokens))
                                      for r in reqs],
                    eng.sched._bucket_level("T", clk[0])))
    assert out[1] == out[0]
    assert out[1][0] == -7.0 and out[1][1] == [True, False, True]
    th = _series(METRICS, "serving_tenant_throttled_total")
    assert th == _series(J_METRICS, "serving_tenant_throttled_total")
    assert th.get(("T",), 0) >= 1 and ("U",) not in th


def test_tenant_rate_validation_and_removal(pair):
    eng = LLMEngine(pair[1], **ENG)
    for bad in (dict(max_tokens_per_s=0), dict(max_tokens_per_s=2,
                                                 burst=-1)):
        with pytest.raises(ValueError):
            eng.sched.set_tenant_rate("T", **bad)
    with pytest.raises(ValueError, match="priority"):
        eng.sched.set_tenant_priority("T", "gold")
    eng.sched.set_tenant_rate("T", max_tokens_per_s=1.0)
    assert eng.sched.tenant_bucket["T"][0] == 1.0      # burst: one second
    eng.sched.set_tenant_rate("T", None)
    assert not eng.sched.tenant_rate and not eng.sched.tenant_bucket
    # unlimited again: four requests of 40 tokens each admit in one pass
    rs = np.random.RandomState(45)
    for _ in range(4):
        eng.add_request(Request(rs.randint(0, 64, (8,)), max_new_tokens=32,
                                tenant_id="T"))
    eng.step()
    assert not eng.queue
    eng.run()
    eng.assert_quiescent()
    assert _series(METRICS, "serving_tenant_throttled_total") == {}
