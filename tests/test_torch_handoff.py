"""The port's session snapshots, sealed KV handoff and hardened transport
against the reference's — the router, snapshot and transfer cases of
``tests/test_degradation.py`` (L4 at the router, snapshot capture, the
double-death restore and its cap, payload validation, a partial
transfer retried once, exhausted retries, a hedged handoff, the
p95-derived deadline) and the sealed int8 handoff cases of
``tests/test_serving_quant.py`` (disaggregated int8 streams, the seal
over the scales, a corrupted scale, a ``kv_dtype`` mismatch).

Greedy streams equal the port's single engine's (and, for the int8
fleet, the JAX single int8 engine's) token for token; every replica ends
quiescent. Same weights (fp32, CPU). Tolerance: exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from paddle_tpu.observability.health import HEALTH as J_HEALTH
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS)
from paddle_tpu_torch.observability.health import HEALTH
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import (DegradationController,
                                      DeviceKVTransfer, KVTransferError,
                                      LLMEngine, OverloadError,
                                      QueueFullError, Replica, Request,
                                      Router, SessionSnapshot,
                                      TransportPolicy, validate_payload)
from paddle_tpu_torch.serving import telemetry as TEL
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import tiny_pair
from tests._torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
ENG = dict(num_slots=4, block_size=4, max_prompt_len=16, max_seq_len=48)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(autouse=True)
def _port_hygiene(monkeypatch):
    monkeypatch.delenv("PT_ROUTER_DISAGG", raising=False)
    monkeypatch.delenv("PT_QUANT_KV", raising=False)

    def clean():
        METRICS.reset()
        FLIGHT.clear()
        REQUESTS.disable()
        REQUESTS.clear()
        GOODPUT.attach_sink(None)
        TEL.reset_tenant_labels()
        HEALTH.remove_rule("router_replica_imbalance")
        J_HEALTH.remove_rule("router_replica_imbalance")
    clean()
    yield
    clean()


def _mk(model, **kw):
    return LLMEngine(model, **{**ENG, **kw})


def _prompts(n, rs, lo=3, hi=14):
    return [rs.randint(0, 64, (int(n_),)) for n_ in rs.randint(lo, hi, size=n)]


def _single(model, prompts, max_new=10, **ekw):
    eng = _mk(model, **ekw)
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=max_new))
    out = {rid: list(map(int, t)) for rid, t in eng.run().items()}
    eng.assert_quiescent()
    return out


def _series(name):
    inst = METRICS.get(name)
    return {} if inst is None else {k: c[0] for k, c in inst._series.items()}


def _flight_kinds():
    return [e["kind"] for e in FLIGHT.events()]


def _ctrl(**kw):
    kw.setdefault("signals", [])
    kw.setdefault("down_patience", 10 ** 9)
    return DegradationController(**kw)


def _quiescent(router):
    router.assert_quiescent()
    for rep in router.replicas:
        rep.engine.assert_quiescent()


def _kill_two(seen, at):
    def kill(ctx):
        name = ctx["replica"]
        if name in seen:
            seen[name] += 1
            if (name, seen[name]) in at:
                raise InjectedFault(f"induced {name} death")
    return kill


def _zeroed(ctx):
    """A corrupted COPY: the source payload stays pristine for a retry."""
    p = ctx["payload"]
    return dataclasses.replace(p, k=torch.zeros_like(p.k))


# ------------------------------------------------- L4 at the router
def test_l4_rejects_new_sessions_engine_and_router(pair):
    _, tm = pair
    c = _ctrl()
    c.force_level(4)
    eng = _mk(tm, degrade=c)
    with pytest.raises(OverloadError) as ei:
        eng.add_request(Request(np.arange(5), max_new_tokens=4))
    assert isinstance(ei.value, QueueFullError)
    assert _series("serving_rejections_total").get(("degraded",)) == 1
    router = Router([Replica(_mk(tm), name="r0")], degrade=_ctrl())
    router.degrade.force_level(4)
    with pytest.raises(OverloadError):
        router.add_request(Request(np.arange(5), max_new_tokens=4))
    assert router.degrade.owner is router
    assert router.replicas[0].engine.degrade is router.degrade
    assert _series("serving_rejections_total").get(("degraded",)) == 2


# ---------------------------------------------------------- snapshots
def test_snapshot_capture_and_resume_ids(pair):
    _, tm = pair
    eng = _mk(tm)
    req = Request(np.arange(6), max_new_tokens=6, session_id="s1",
                  tenant_id="t1")
    eng.add_request(req)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot_session(req.req_id)
    assert isinstance(snap, SessionSnapshot)
    assert snap.tokens == tuple(req.tokens) and snap.gen == len(req.tokens)
    assert snap.session_id == "s1" and snap.tenant_id == "t1"
    ids = snap.resume_ids()
    assert list(ids[:6]) == list(range(6))
    assert list(ids[6:]) == list(req.tokens)
    assert _series("serving_session_snapshots_total").get((), 0) == 1
    assert eng.snapshot_session(10 ** 9) is None
    with FAULTS.scope("serving.snapshot", exc=InjectedFault, on={0}):
        with pytest.raises(InjectedFault):
            eng.snapshot_session(req.req_id)
    eng.run()
    eng.assert_quiescent()


def test_snapshot_drains_the_async_window(pair):
    """Under async decode the snapshot's tokens are the synchronous
    engine's at that step: the window is drained first."""
    _, tm = pair
    sync, asy = _mk(tm), _mk(tm, async_depth=2)
    for e in (sync, asy):
        e.add_request(Request(np.arange(6), max_new_tokens=12, req_id=0))
    for _ in range(6):
        sync.step()
        asy.step()
    snap = asy.snapshot_session(0)
    assert snap.tokens == tuple(sync.requests[0].tokens)
    assert not asy._async_win
    for e in (sync, asy):
        e.run()
        e.assert_quiescent()


def test_double_death_restores_from_snapshot(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(45))
    ref = _single(tm, prompts, max_new=8)
    router = Router([Replica(_mk(tm), name=f"r{i}") for i in range(3)],
                    snapshot_every=1)
    kill = _kill_two({"r0": 0, "r1": 0}, (("r0", 2), ("r1", 6)))
    with FAULTS.scope("router.replica_death", action=kill):
        for p in prompts:
            router.add_request(Request(p, max_new_tokens=8))
        out = {rid: list(map(int, t)) for rid, t in router.run().items()}
    assert router.stats["deaths"] == 2
    assert all(req.finish_reason != "replica_death"
               for req in router.requests.values())
    assert out == ref
    assert _series("router_session_restores_total").get((), 0) >= 1
    assert "router.session_restore" in _flight_kinds()
    assert _series("serving_waste_total").get(("replay_prefill",), 0) > 0
    _quiescent(router)


def test_restore_cap_fails_closed(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(46))
    router = Router([Replica(_mk(tm), name=f"r{i}") for i in range(3)],
                    snapshot_every=1, max_session_restores=0)
    kill = _kill_two({"r0": 0, "r1": 0}, (("r0", 2), ("r1", 6)))
    with FAULTS.scope("router.replica_death", action=kill):
        for p in prompts:
            router.add_request(Request(p, max_new_tokens=8))
        router.run()
    assert any(req.finish_reason == "replica_death"
               for req in router.requests.values())
    _quiescent(router)


# ------------------------------------------------- transport hardening
def test_validate_payload_rejects_corruption(pair):
    _, tm = pair
    eng = _mk(tm)
    eng.add_request(Request(np.arange(6), max_new_tokens=4))
    eng.step()
    rid = next(iter(eng.requests))
    payload = eng.extract_sequence(rid)
    assert payload.expect is not None
    assert payload.k.shape == (2, 2, 4, 2, 8) and payload.n_blocks == 2
    assert payload.tokens_bytes == 2 * payload.k.numel() * 4
    eng.assert_quiescent()
    tgt = _mk(tm)
    validate_payload(payload, tgt)
    zeroed = dataclasses.replace(payload, k=torch.zeros_like(payload.k))
    with pytest.raises(KVTransferError, match="checksum"):
        validate_payload(zeroed, tgt)
    truncated = dataclasses.replace(payload, n_blocks=0)
    with pytest.raises(KVTransferError, match="drifted|truncated"):
        validate_payload(truncated, tgt)
    bad_geom = dataclasses.replace(
        payload, k=payload.k[:, :, :, :1], v=payload.v[:, :, :, :1],
        expect=None)
    with pytest.raises(KVTransferError, match="geometry"):
        validate_payload(bad_geom, tgt)
    assert tgt.install_sequence(payload)
    out = tgt.run()
    assert len(out[rid]) == 4
    tgt.assert_quiescent()


def test_extract_refuses_what_cannot_travel(pair):
    """Queued, mid-chunk and beam requests hold no active greedy slot;
    a mismatched block size or model refuses at install."""
    _, tm = pair
    eng = _mk(tm, max_prompt_len=4)
    a = eng.add_request(Request(np.arange(10), max_new_tokens=4))
    with pytest.raises(ValueError, match="no active greedy slot"):
        eng.extract_sequence(a)              # still queued
    eng.step()
    assert a in eng.prefilling
    with pytest.raises(ValueError, match="no active greedy slot"):
        eng.extract_sequence(a)              # mid-chunk
    eng.run()
    b = eng.add_request(Request(np.arange(4), max_new_tokens=4,
                                num_beams=2))
    eng.step()
    with pytest.raises(ValueError, match="no active greedy slot"):
        eng.extract_sequence(b)
    eng.run()
    eng.assert_quiescent()
    src = _mk(tm)
    src.add_request(Request(np.arange(5), max_new_tokens=4, req_id=7))
    src.step()
    payload = src.extract_sequence(7)
    with pytest.raises(ValueError, match="block_size"):
        _mk(tm, block_size=8).install_sequence(payload)
    _, wide = tiny_pair(**{**TINY, "num_key_value_heads": 4})
    with pytest.raises(ValueError, match="geometry"):
        _mk(wide).install_sequence(payload)
    dst = _mk(tm)
    dst._draining = True
    from paddle_tpu_torch.serving import EngineDrainingError
    with pytest.raises(EngineDrainingError):
        dst.install_sequence(payload)


def test_install_returns_false_when_full_and_leaves_state(pair):
    _, tm = pair
    src = _mk(tm)
    src.add_request(Request(np.arange(5), max_new_tokens=8, req_id=0))
    src.step()
    payload = src.extract_sequence(0)
    dst = _mk(tm, num_slots=1)
    dst.add_request(Request(np.arange(3), max_new_tokens=20, req_id=1))
    dst.step()
    free = dst.mgr.free_blocks
    assert dst.install_sequence(payload) is False
    assert dst.mgr.free_blocks == free and 0 not in dst.requests
    dst.run()
    assert dst.install_sequence(payload) is True
    dst.run()
    assert len(payload.req.tokens) == 8
    dst.assert_quiescent()


def test_partial_transfer_retried_exactly_once(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(47))
    ref = _single(tm, prompts)
    router = Router([Replica(_mk(tm), name="p0", role="prefill"),
                     Replica(_mk(tm), name="d0", role="decode")])
    with FAULTS.scope("router.kv_partial", on={0}, action=_zeroed):
        for p in prompts:
            router.add_request(Request(p, max_new_tokens=10))
        out = {rid: list(map(int, t)) for rid, t in router.run().items()}
    assert out == ref
    assert _series("router_transfer_retries_total") == {("d0", "partial"): 1}
    assert "router.kv_retry" in _flight_kinds()
    assert router.stats["transfers"] == 6
    _quiescent(router)


def test_transfer_retries_exhausted_fails_handoff_cleanly(pair):
    _, tm = pair
    router = Router([Replica(_mk(tm), name="p0", role="prefill"),
                     Replica(_mk(tm), name="d0", role="decode")],
                    transport=TransportPolicy(max_attempts=2,
                                              backoff_base_s=0.0,
                                              hedge=False))
    with FAULTS.scope("router.kv_partial", every=1, action=_zeroed):
        router.add_request(Request(np.random.RandomState(48).randint(
            0, 64, (6,)), max_new_tokens=4))
        for _ in range(30):
            router.step()
    assert sum(_series("router_transfer_retries_total").values()) >= 2
    assert router._pending
    assert router.replicas[1].engine.mgr.free_blocks == \
        router.replicas[1].engine.mgr.num_blocks
    out = router.run()
    assert len(out) == 1
    _quiescent(router)


def test_hedged_handoff_loser_leaves_no_leak(pair):
    _, tm = pair
    prompts = _prompts(6, np.random.RandomState(49))
    ref = _single(tm, prompts)
    router = Router([Replica(_mk(tm), name="p0", role="prefill"),
                     Replica(_mk(tm), name="d0", role="decode"),
                     Replica(_mk(tm), name="d1", role="decode")],
                    transport=TransportPolicy(deadline_s=0.01,
                                              max_attempts=1))
    with FAULTS.scope("router.kv_stall", on={0}, delay_s=0.05):
        for p in prompts:
            router.add_request(Request(p, max_new_tokens=10))
        out = {rid: list(map(int, t)) for rid, t in router.run().items()}
    assert out == ref
    assert router.stats["hedges"] == 1
    assert _series("router_hedges_total").get((), 0) == 1
    kinds = _flight_kinds()
    assert "router.kv_hedge" in kinds and "router.kv_hedge_win" in kinds
    assert _series("router_hedge_rate").get((), 0) > 0
    _quiescent(router)


def test_deadline_derived_from_history_needs_samples():
    scratch = MetricsRegistry()
    h = scratch.histogram("router_kv_transfer_seconds", "scratch",
                          buckets=(0.01, 0.1, 1.0))
    tp = TransportPolicy(min_samples=4, deadline_margin=2.0,
                         min_deadline_s=0.05)
    assert tp.deadline(h) is None
    for _ in range(4):
        h.observe(0.1)
    d = tp.deadline(h)
    assert d is not None and d >= 0.05
    assert TransportPolicy(deadline_s=0.3).deadline(h) == 0.3
    with pytest.raises(ValueError):
        TransportPolicy(max_attempts=0)


# ------------------------------------------------ sealed int8 handoff
def test_disaggregated_int8_matches_single_engine(pair):
    jm, tm = pair
    rs = np.random.RandomState(7)
    prompts = _prompts(4, rs) + [rs.randint(1, 64, (19,))]
    ref = _single(tm, prompts, max_new=8, max_prompt_len=8,
                  kv_dtype="int8")
    jeng = JEngine(jm, **{**ENG, "max_prompt_len": 8, "kv_dtype": "int8"})
    for p in prompts:
        jeng.add_request(JRequest(p, max_new_tokens=8))
    jref = {rid: list(map(int, t)) for rid, t in jeng.run().items()}
    r = Router([Replica(_mk(tm, max_prompt_len=8, kv_dtype="int8"),
                        role="prefill"),
                Replica(_mk(tm, max_prompt_len=8, kv_dtype="int8"),
                        role="decode")])
    for p in prompts:
        r.add_request(Request(p, max_new_tokens=8))
    out = {rid: list(map(int, t)) for rid, t in r.run().items()}
    assert out == ref == jref
    _quiescent(r)
    assert r.stats["transfers"] == 5


def _extract_one(model, prompt, **kw):
    src = _mk(model, prefill_only=True, **kw)
    src.add_request(Request(prompt, max_new_tokens=6, req_id=0))
    while 0 not in [int(x) for x in src.slot_req] or not src.active.any():
        src.step()
    return src, src.extract_sequence(0)


def test_payload_seal_covers_scales(pair):
    _, tm = pair
    src, payload = _extract_one(tm, np.random.RandomState(8).randint(
        1, 64, (9,)), kv_dtype="int8")
    assert payload.k_scale is not None and payload.expect["quant"]
    assert {"kssum", "vssum"} <= set(payload.expect)
    assert payload.k.dtype == torch.int8
    assert payload.k_scale.shape == payload.k.shape[:4]
    dst = _mk(tm, kv_dtype="int8")
    validate_payload(DeviceKVTransfer().ship(payload, dst), dst)
    assert dst.install_sequence(payload)
    out = {rid: list(map(int, t)) for rid, t in dst.run().items()}
    assert len(out[0]) == 6
    src.assert_quiescent()
    dst.assert_quiescent()


def test_corrupted_scale_rejected(pair):
    _, tm = pair
    _, payload = _extract_one(tm, np.random.RandomState(9).randint(
        1, 64, (9,)), kv_dtype="int8")
    dst = _mk(tm, kv_dtype="int8")
    payload.k_scale = payload.k_scale * 2.0
    with pytest.raises(KVTransferError, match="k-scale-checksum"):
        validate_payload(payload, dst)


def test_kv_dtype_mismatch_rejected(pair):
    _, tm = pair
    rs = np.random.RandomState(10)
    _, qpayload = _extract_one(tm, rs.randint(1, 64, (9,)), kv_dtype="int8")
    bf16_dst = _mk(tm)
    with pytest.raises(KVTransferError, match="dtype mismatch"):
        validate_payload(qpayload, bf16_dst)
    with pytest.raises(ValueError, match="quantization"):
        bf16_dst.install_sequence(qpayload)
    _, bpayload = _extract_one(tm, rs.randint(1, 64, (9,)))
    int8_dst = _mk(tm, kv_dtype="int8")
    with pytest.raises(KVTransferError, match="dtype mismatch"):
        validate_payload(bpayload, int8_dst)
