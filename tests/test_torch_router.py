"""The port's multi-replica router (``serving/router.py``) against the JAX
package's, on the same tiny Llama weights — the cases of
``tests/test_router.py``.

* Routed, disaggregated (chunked prefill and speculative decoding on the
  decode replica included), kill-switch and parallel runs: the port's
  greedy streams equal the JAX router's and the port's single engine's,
  token for token.
* Dispatch (least outstanding requests), session affinity, health
  gating, the imbalance rule, drain rebalancing, draining a prefill
  replica, and the ``router.dispatch``, ``router.kv_transfer`` and
  ``router.replica_death`` chaos sites: streams equal the single
  engine's and every replica ends quiescent (no leaked block, dead
  replicas included).

Same weights (fp32, CPU). Tolerance: exact.
"""
import numpy as np
import pytest

from paddle_tpu.observability.health import HEALTH as J_HEALTH
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Replica as JReplica
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import Router as JRouter
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS)
from paddle_tpu_torch.observability.health import (HEALTH,
                                                   gauge_imbalance)
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import (EngineDrainingError, LLMEngine,
                                      Replica, Request, Router)
from paddle_tpu_torch.serving import telemetry as TEL
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
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
    monkeypatch.delenv("PT_ROUTER_DISAGG", raising=False)

    def clean():
        METRICS.reset()
        FLIGHT.clear()
        REQUESTS.disable()
        REQUESTS.clear()
        GOODPUT.attach_sink(None)
        TEL.reset_tenant_labels()
        # the Router installs a stock rule on the global evaluators
        HEALTH.remove_rule("router_replica_imbalance")
        J_HEALTH.remove_rule("router_replica_imbalance")
    clean()
    yield
    clean()


def _mk(model, **kw):
    return LLMEngine(model, **{**ENG, **kw})


def _jmk(model, **kw):
    return JEngine(model, **{**ENG, **kw})


def _prompts(n, rs, lo=3, hi=14):
    return [rs.randint(0, 64, (int(n_),)) for n_ in rs.randint(lo, hi, size=n)]


def _single(model, prompts, max_new=10, **ekw):
    """The port's single engine over the same requests."""
    eng = _mk(model, **ekw)
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=max_new))
    out = {rid: list(map(int, t)) for rid, t in eng.run().items()}
    eng.assert_quiescent()
    return out


def _route(router, prompts, max_new=10, req=Request, parallel=False):
    for p in prompts:
        router.add_request(req(p, max_new_tokens=max_new))
    out = router.run(parallel=parallel) if parallel else router.run()
    return {rid: list(map(int, t)) for rid, t in out.items()}


def _requeues_by_label():
    inst = METRICS.get("router_requeues_total")
    return {} if inst is None else {k: c[0] for k, c in inst._series.items()}


def _quiescent(router):
    router.assert_quiescent()
    for rep in router.replicas:
        rep.engine.assert_quiescent()


# ------------------------------------------------------- greedy identity
def test_routed_two_replicas_matches_jax_router_and_single_engine(pair):
    jm, tm = pair
    prompts = _prompts(8, np.random.RandomState(0))
    ref = _single(tm, prompts)
    jout = _route(JRouter([_jmk(jm), _jmk(jm)]), prompts, req=JRequest)
    r = Router([_mk(tm), _mk(tm)])
    out = _route(r, prompts)
    assert out == ref == jout
    _quiescent(r)
    assert r.stats["dispatched"] == 8 and r.stats["requeues"] == 0


def test_disaggregated_matches_jax_router_and_single_engine(pair):
    """One prefill and one decode replica: every sequence crosses the KV
    handoff, a 19-token prompt in three chunks on the prefill replica."""
    jm, tm = pair
    rs = np.random.RandomState(1)
    prompts = _prompts(5, rs) + [rs.randint(0, 64, (19,))]
    ref = _single(tm, prompts, max_prompt_len=8)
    jr = JRouter([JReplica(_jmk(jm, max_prompt_len=8), role="prefill"),
                  JReplica(_jmk(jm, max_prompt_len=8), role="decode")])
    jout = _route(jr, prompts, req=JRequest)
    r = Router([Replica(_mk(tm, max_prompt_len=8), role="prefill"),
                Replica(_mk(tm, max_prompt_len=8), role="decode")])
    assert r.disagg and r.replicas[0].engine.prefill_only
    out = _route(r, prompts)
    assert out == ref == jout
    _quiescent(r)
    assert r.stats["transfers"] == jr.stats["transfers"] == 6
    assert not r.replicas[0].engine.has_work()
    assert r.replicas[0].engine.stats["ticks"] == 0     # never decoded


def test_disagg_spec_decode_on_decode_replica(pair, drafts):
    """Speculative decoding runs on the decode replica over installed
    blocks; greedy streams still equal the plain single engine's."""
    jm, tm = pair
    jd, td = drafts
    prompts = _prompts(4, np.random.RandomState(2))
    ref = _single(tm, prompts, max_new=8)
    jr = JRouter([JReplica(_jmk(jm), role="prefill"),
                  JReplica(_jmk(jm, draft_model=jd, spec_k=2),
                           role="decode")])
    jout = _route(jr, prompts, max_new=8, req=JRequest)
    r = Router([Replica(_mk(tm), role="prefill"),
                Replica(_mk(tm, draft_model=td, spec_k=2), role="decode")])
    out = _route(r, prompts, max_new=8)
    assert out == ref == jout
    _quiescent(r)
    assert r.stats["transfers"] == 4
    assert r.replicas[1].engine.stats["spec_ticks"] > 0


def test_disagg_kill_switch(pair, monkeypatch):
    """PT_ROUTER_DISAGG=0 collapses the roles to 'both': no transfers,
    streams intact, as the JAX router's."""
    monkeypatch.setenv("PT_ROUTER_DISAGG", "0")
    jm, tm = pair
    prompts = _prompts(6, np.random.RandomState(3))
    ref = _single(tm, prompts)
    jout = _route(JRouter([JReplica(_jmk(jm), role="prefill"),
                           JReplica(_jmk(jm), role="decode")]),
                  prompts, req=JRequest)
    r = Router([Replica(_mk(tm), role="prefill"),
                Replica(_mk(tm), role="decode")])
    assert not r.disagg
    assert all(rep.role == "both" and not rep.engine.prefill_only
               for rep in r.replicas)
    out = _route(r, prompts)
    assert out == ref == jout
    _quiescent(r)
    assert r.stats["transfers"] == 0


def test_parallel_run_matches_sequential(pair):
    """run(parallel=True): one thread per replica; the streams are
    the JAX router's and the single engine's, and no thread outlives the
    call."""
    import threading
    jm, tm = pair
    prompts = _prompts(8, np.random.RandomState(4))
    ref = _single(tm, prompts)
    jout = _route(JRouter([_jmk(jm), _jmk(jm)]), prompts, req=JRequest)
    r = Router([_mk(tm), _mk(tm)])
    out = _route(r, prompts, parallel=True)
    assert out == ref == jout
    _quiescent(r)
    assert all(r.replicas[i].engine.stats["ticks"] > 0 for i in (0, 1))
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pt-router-")]


# ------------------------------------------------------- dispatch policy
def test_lor_prefers_least_loaded_replica(pair):
    _, tm = pair
    rs = np.random.RandomState(5)
    r = Router([_mk(tm), _mk(tm)])
    long_rid = r.add_request(Request(rs.randint(0, 64, (5,)),
                                     max_new_tokens=24))
    short_rid = r.add_request(Request(rs.randint(0, 64, (5,)),
                                      max_new_tokens=2))
    assert r._where[long_rid] == 0 and r._where[short_rid] == 1
    while not r.requests[short_rid].done:
        r.step()
    nxt = r.add_request(Request(rs.randint(0, 64, (5,)), max_new_tokens=2))
    assert r._where[nxt] == 1          # r1 idle, r0 still decoding
    r.run()
    _quiescent(r)


def test_session_affinity_sticks_to_one_replica(pair):
    _, tm = pair
    rs = np.random.RandomState(6)
    r = Router([_mk(tm), _mk(tm)])
    alice = [r.add_request(Request(rs.randint(0, 64, (6,)),
                                   max_new_tokens=6, session_id="alice"))
             for _ in range(3)]
    bob = [r.add_request(Request(rs.randint(0, 64, (6,)),
                                 max_new_tokens=6, session_id="bob"))
           for _ in range(3)]
    assert len({r._where[rid] for rid in alice}) == 1
    assert len({r._where[rid] for rid in bob}) == 1
    assert r._where[alice[0]] != r._where[bob[0]]
    r.run()
    _quiescent(r)


def test_crit_replica_receives_nothing(pair):
    _, tm = pair
    prompts = _prompts(5, np.random.RandomState(7))
    ref = _single(tm, prompts)
    bad = Replica(_mk(tm))
    bad.health.rule("always_on_fire", lambda: 99.0, warn=1.0, crit=2.0)
    r = Router([bad, Replica(_mk(tm))])
    assert _route(r, prompts) == ref
    assert bad.engine.stats["ticks"] == 0
    _quiescent(r)


def test_imbalance_health_rule_installed_and_fires(pair):
    _, tm = pair
    Router([_mk(tm), _mk(tm)])
    assert any(rule.name == "router_replica_imbalance"
               for rule in HEALTH.rules)
    reg = MetricsRegistry()
    g = reg.gauge("router_replica_outstanding", "t", labelnames=("replica",))
    get = gauge_imbalance("router_replica_outstanding", registry=reg)
    g.set(10.0, replica="a")
    assert np.isnan(get())
    g.set(0.0, replica="b")
    assert get() == pytest.approx(2.0)
    g.set(10.0, replica="b")
    assert get() == pytest.approx(0.0)


# ------------------------------------------------------ drain/rebalance
def test_drain_replica_rebalances_without_deadlock(pair):
    _, tm = pair
    prompts = _prompts(10, np.random.RandomState(8))
    ref = _single(tm, prompts, max_new=6)
    r = Router([_mk(tm, num_slots=2, max_queue_len=2),
                _mk(tm, num_slots=2, max_queue_len=2)])
    for p in prompts:
        r.add_request(Request(p, max_new_tokens=6))
    assert len(r._queue) > 0
    r.drain_replica("r0")
    assert r.replicas[0].draining
    out = {rid: list(map(int, t)) for rid, t in r.run().items()}
    assert out == ref
    _quiescent(r)
    assert all(i != 0 for i in r._where.values())
    assert r.stats["requeues"] >= 1
    by = _requeues_by_label()
    assert by and all(k == ("r0", "drain") for k in by)
    assert sum(by.values()) == r.stats["requeues"]


def test_drain_prefill_replica_flushes_handoffs(pair):
    _, tm = pair
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 64, (19,))] + _prompts(3, rs, hi=8)
    ref = _single(tm, prompts, max_new=6, max_prompt_len=8)
    r = Router([Replica(_mk(tm, max_prompt_len=8), role="prefill"),
                Replica(_mk(tm, max_prompt_len=8), role="decode")])
    for p in prompts:
        r.add_request(Request(p, max_new_tokens=6))
    r.step()                    # the 19-token prompt is mid-chunk on r0
    assert r.replicas[0].engine.prefilling
    r.drain_replica("r0")
    assert not r.replicas[0].engine.has_work()
    out = {rid: list(map(int, t)) for rid, t in r.run().items()}
    assert out == ref
    _quiescent(r)


# ---------------------------------------------------------- chaos sites
def test_chaos_dispatch_requeues_and_recovers(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(10))
    ref = _single(tm, prompts)
    r = Router([_mk(tm), _mk(tm)])
    with FAULTS.scope("router.dispatch", exc=InjectedFault, on={0, 2}):
        out = _route(r, prompts)
    assert out == ref
    _quiescent(r)
    assert r.stats["requeues"] == 2 and r.stats["dispatched"] == 6
    assert sum(n for (rep, why), n in _requeues_by_label().items()
               if why == "dispatch_fault") == 2


def test_chaos_kv_transfer_requeues_no_leak(pair):
    _, tm = pair
    prompts = _prompts(5, np.random.RandomState(11))
    ref = _single(tm, prompts)
    r = Router([Replica(_mk(tm), role="prefill"),
                Replica(_mk(tm), role="decode")])
    with FAULTS.scope("router.kv_transfer", exc=InjectedFault, on={1, 3}):
        out = _route(r, prompts)
    assert out == ref
    _quiescent(r)
    assert r.stats["requeues"] == 2
    assert _requeues_by_label() == {("r0", "kv_transfer"): 2}


def test_chaos_replica_death_requeues_exactly_once(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(12))
    ref = _single(tm, prompts)
    r = Router([_mk(tm), _mk(tm)])
    seen = {"r0": 0}

    def kill_r0(ctx):
        if ctx["replica"] == "r0":
            seen["r0"] += 1
            if seen["r0"] == 3:
                raise InjectedFault("induced r0 death")

    with FAULTS.scope("router.replica_death", action=kill_r0):
        out = _route(r, prompts)
    assert out == ref
    _quiescent(r)
    assert r.stats["deaths"] == 1 and not r.replicas[0].alive
    assert r.stats["requeues"] == len(r._requeued) >= 1
    by = _requeues_by_label()
    assert by and all(k == ("r0", "replica_death") for k in by)
    assert sum(by.values()) == r.stats["requeues"]


def test_replica_death_twice_marks_request_failed(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(13))
    ref = _single(tm, prompts)
    r = Router([_mk(tm), _mk(tm), _mk(tm)])
    seen = {"r0": 0, "r1": 0}

    def kill_two(ctx):
        name = ctx["replica"]
        if name in seen:
            seen[name] += 1
            if (name, seen[name]) in (("r0", 2), ("r1", 6)):
                raise InjectedFault(f"induced {name} death")

    with FAULTS.scope("router.replica_death", action=kill_two):
        for p in prompts:
            r.add_request(Request(p, max_new_tokens=10))
        out = r.run()
    assert r.stats["deaths"] == 2
    failed = 0
    for rid, req in r.requests.items():
        assert req.done
        if req.finish_reason == "replica_death":
            failed += 1
            continue
        assert list(map(int, out[rid])) == ref[rid]
    assert failed >= 1
    assert r.stats["requeues"] == len(r._requeued)
    _quiescent(r)


def test_all_replicas_down_rejects_new_requests(pair):
    _, tm = pair
    r = Router([_mk(tm)])
    r.replicas[0].alive = False
    with pytest.raises(EngineDrainingError):
        r.add_request(Request(np.arange(5), max_new_tokens=4))


def test_serving_import_surface():
    import paddle_tpu.serving as JS
    import paddle_tpu_torch.serving as S
    names = ("Router", "Replica", "KVTransfer", "DeviceKVTransfer",
             "KVPayload", "KVTransferError", "TransportPolicy",
             "validate_payload", "LLMEngine", "Request", "SessionSnapshot")
    for name in names:
        assert hasattr(S, name) and hasattr(JS, name), name
        assert name in S.__all__ and name in JS.__all__, name
