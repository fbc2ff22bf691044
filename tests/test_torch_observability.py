"""The port's observability against the JAX package.

* The peak tables cover the reference's kinds plus the H100's, keyed on
  the name the card reports ("NVIDIA H100 80GB HBM3": 989e12 dense bf16
  FLOP/s, 3.35e12 B/s); the CPU and unknown kinds read 0.0. The CPU
  engine exports 0 MFU/MBU, never a fabricated figure;
  ``PT_ROOFLINE_KIND`` gives a what-if.
* ``ModelGeometry`` and the FLOPs/bytes models equal the reference's;
  the engine's per-phase roofline accumulators (tokens, weight passes,
  KV positions) equal the reference engine's on the same mixes (chunked
  prefill, speculative decoding, an int8 pool).
* GOODPUT totals by reason (good, saved, spec_rejected, replay_prefill,
  chaos_abort, pad_rows) equal the reference's on the same mix and the
  same fault schedule; async_overrun bills what the engine counts.
* The request tracker's event kinds, in order, per request, and the
  flight recorder's serving records equal the reference's.
* The tick breakdown sums to the tick's wall time, tick for tick,
  synchronous and at ``async_depth=2``.

Same weights (fp32, CPU). Tolerance: counts exactly; breakdown sums to
1e-9 relative (one clock, float addition).
"""
import dataclasses
import math

import numpy as np
import pytest

from paddle_tpu.observability import FLIGHT as J_FLIGHT
from paddle_tpu.observability import GOODPUT as J_GOODPUT
from paddle_tpu.observability import REQUESTS as J_REQUESTS
from paddle_tpu.observability import flops as J_FLOPS
from paddle_tpu.observability import roofline as J_ROOF
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.utils.faults import FAULTS as J_FAULTS
from paddle_tpu_torch.observability import (FLIGHT, GOODPUT, METRICS,
                                            REQUESTS, flops, roofline)
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.utils.faults import FAULTS
from tests.test_torch_common import tiny_pair

H100 = "NVIDIA H100 80GB HBM3"
TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
PHASES = ("prefill", "draft", "verify", "sample", "host")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def drafts():
    """(reference, port) draft of other weights: most proposals fail."""
    return tiny_pair(seed=3, **{**TINY, "num_hidden_layers": 1})


@pytest.fixture(autouse=True)
def _port_hygiene():
    def clean():
        FAULTS.clear()
        METRICS.reset()
        FLIGHT.clear()
        REQUESTS.disable()
        REQUESTS.clear()
        roofline.reset_serving_roofline()
    clean()
    yield
    clean()


# ------------------------------------------------------------ peak tables
def test_peak_tables_cover_reference_kinds_and_the_h100():
    assert set(flops.PEAK_BF16) == set(J_FLOPS.PEAK_BF16) | {H100}
    assert set(roofline.PEAK_HBM_BPS) == set(J_ROOF.PEAK_HBM_BPS) | {H100}
    for k, v in J_FLOPS.PEAK_BF16.items():
        assert flops.PEAK_BF16[k] == v
        assert roofline.PEAK_HBM_BPS[k] == J_ROOF.PEAK_HBM_BPS[k]
    assert flops.PEAK_BF16[H100] == 989e12
    assert roofline.PEAK_HBM_BPS[H100] == 3.35e12


@pytest.mark.parametrize("kind,fl,bw", [
    (H100, 989e12, 3.35e12), ("TPU v5e", 197e12, 819e9),
    ("TPU v99", 197e12, 819e9), ("NVIDIA A100-SXM4-80GB", 0.0, 0.0),
    ("cpu", 0.0, 0.0), ("", 0.0, 0.0)])
def test_peaks_by_kind(kind, fl, bw):
    assert flops.chip_peak_flops(kind=kind) == fl
    assert roofline.chip_peak_hbm_bw(kind=kind) == bw


def test_torch_devices_resolve_and_the_cpu_is_undefined(monkeypatch):
    import torch
    monkeypatch.delenv("PT_ROOFLINE_KIND", raising=False)
    for dev in (torch.device("cpu"), "cpu", None):
        assert roofline.resolve_serving_peaks(dev) == (0.0, 0.0)
    assert flops.device_kind(torch.device("cpu")) == ("cpu", "cpu")
    monkeypatch.setenv("PT_ROOFLINE_KIND", H100)
    assert roofline.resolve_serving_peaks(torch.device("cpu")) == \
        (989e12, 3.35e12)


# --------------------------------------------------- geometry and models
@pytest.mark.parametrize("family", ["llama", "mixtral", "qwen2_moe"])
def test_geometry_matches_reference(family):
    from tests.test_torch_common import MOE_FAMILIES
    if family == "llama":
        from paddle_tpu.models.llama import LlamaConfig as J
        from paddle_tpu_torch.models.llama import LlamaConfig as T
        jc, tc = J.tiny(num_key_value_heads=2), T.tiny(num_key_value_heads=2)
    else:
        _, jcfg, _, tcfg, _ = MOE_FAMILIES[family]
        jc, tc = jcfg(), tcfg()
    jg = J_ROOF.ModelGeometry.from_config(jc)
    tg = roofline.ModelGeometry.from_config(tc)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    q = dict(kv_dtype_bytes=1, kv_scale_bytes=4, weight_dtype_bytes=0.5)
    jq, tq = dataclasses.replace(jg, **q), dataclasses.replace(tg, **q)
    for tokens, passes, ctx in ((1, 1, 10), (37, 2, 900), (8, 1, 4096)):
        for j, t in ((jg, tg), (jq, tq)):
            assert roofline.phase_flops(t, tokens, ctx) == \
                J_ROOF.phase_flops(j, tokens, ctx)
            assert roofline.phase_bytes(
                t, tokens=tokens, weight_passes=passes,
                kv_read_positions=ctx) == J_ROOF.phase_bytes(
                j, tokens=tokens, weight_passes=passes,
                kv_read_positions=ctx)


# ------------------------------------------------------------------ mixes
def _mix(seed, n=5, lo=3, hi=22):
    rs = np.random.RandomState(seed)
    ps = [rs.randint(0, 64, (int(k),)) for k in rs.randint(lo, hi, n)]
    # a radix prefix hit: the third prompt's head again
    return ps + [np.concatenate([ps[2][:9], rs.randint(0, 64, 3)])]


EKW = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=40)


def _run(cls, req_cls, model, prompts, new=6, extra=(), **kw):
    eng = cls(model, **{**EKW, **kw})
    ids = [eng.add_request(req_cls(p, max_new_tokens=new)) for p in prompts]
    ids += [eng.add_request(req_cls(p, **k)) for p, k in extra]
    eng.run()
    eng.assert_quiescent()
    return eng, ids


def _both(pair, drafts=None, prompts=None, extra=(), **kw):
    jm, tm = pair
    prompts = _mix(0) if prompts is None else prompts
    jkw, tkw = dict(kw), dict(kw)
    if drafts is not None:
        jkw.update(draft_model=drafts[0], spec_k=3)
        tkw.update(draft_model=drafts[1], spec_k=3)
    je, jids = _run(JEngine, JRequest, jm, prompts, extra=extra, **jkw)
    te, tids = _run(LLMEngine, Request, tm, prompts, extra=extra, **tkw)
    assert [te.requests[i].tokens for i in tids] == \
        [je.requests[i].tokens for i in jids]
    return je, te, jids, tids


@pytest.mark.parametrize("case", ["plain", "spec", "int8", "beam"])
def test_phase_accumulators_match_reference(pair, drafts, case):
    kw = {"plain": {}, "spec": {}, "int8": {"kv_dtype": "int8"},
          "beam": {"num_slots": 4}}[case]
    extra = ([(np.arange(5, 11), dict(max_new_tokens=5, num_beams=2))]
             if case == "beam" else ())
    je, te, _, _ = _both(pair, drafts if case == "spec" else None,
                         extra=extra, **kw)
    for p in ("prefill", "decode", "spec_draft", "spec_verify"):
        assert te._phase_acc[p][1:] == je._phase_acc[p][1:], p
    assert dataclasses.asdict(te._geom) == dataclasses.asdict(je._geom)
    if case == "spec":
        assert te._phase_acc["spec_verify"][1] > 0
        assert dataclasses.asdict(te._draft_geom) == \
            dataclasses.asdict(je._draft_geom)
    if case == "int8":
        assert te._geom.kv_dtype_bytes == 1 and te._geom.kv_scale_bytes == 4


def test_cpu_engine_exports_zero_mfu_mbu_and_a_what_if(pair, monkeypatch):
    monkeypatch.delenv("PT_ROOFLINE_KIND", raising=False)
    _run(LLMEngine, Request, pair[1], _mix(1))
    mbu, mfu = METRICS.get("serving_mbu"), METRICS.get("serving_mfu")
    ai = METRICS.get("serving_arith_intensity")
    assert mbu.value(phase="decode") == 0.0
    assert mfu.value(phase="decode") == 0.0
    assert ai.value(phase="decode") > 0.0
    for ph, rep in roofline.serving_roofline_report()["phases"].items():
        assert rep["bound"] == "undefined", ph
    roofline.reset_serving_roofline()
    monkeypatch.setenv("PT_ROOFLINE_KIND", H100)
    _run(LLMEngine, Request, pair[1], _mix(1))
    doc = roofline.serving_roofline_report()
    dec = doc["phases"]["decode"]
    assert dec["mbu"] > 0.0 and dec["mbu"] == mbu.value(phase="decode")
    assert dec["bound"] == "bandwidth-bound"
    assert doc["machine"]["peak_hbm_bps"] == 3.35e12
    assert doc["phases"]["prefill"]["arith_intensity"] > \
        dec["arith_intensity"]


# ---------------------------------------------------------------- goodput
def _ledger(g):
    return (g.good_total(), g.saved_total(),
            {k: v for k, v in g.waste_by_why().items() if v})


def test_goodput_by_reason_matches_reference(pair, drafts):
    """Spec rejects (a draft of other weights), pad rows (chunked prefill
    and verify batches), replay prefill (preemption on a tight pool),
    saved tokens (a radix hit) and chaos aborts (a verify fault every
    third round): the same totals, reason by reason."""
    for f in (FAULTS, J_FAULTS):
        f.install("serving.spec_verify", every=3, times=4,
                  exc=RuntimeError)
    je, te, _, _ = _both(pair, drafts, prompts=_mix(2, 6, 4, 20),
                         num_blocks=14, preemption=True)
    assert te.stats["preemptions"] == je.stats["preemptions"] > 0
    assert te.stats["spec_fallbacks"] == je.stats["spec_fallbacks"] > 0
    got, want = _ledger(GOODPUT), _ledger(J_GOODPUT)
    assert got == want
    assert {"spec_rejected", "pad_rows", "replay_prefill",
            "chaos_abort"} <= set(got[2])
    assert got[1] > 0


def test_async_overrun_bills_goodput(pair):
    """A stream-callback cancel mid-cruise: the rows the dispatched ticks
    ran for the dead slot bill ``async_overrun``, exactly what the engine
    counts."""
    rs = np.random.RandomState(8)
    pa, pb = rs.randint(2, 64, (4,)), rs.randint(2, 64, (5,))
    eng = LLMEngine(pair[1], num_slots=2, block_size=16, max_seq_len=64,
                    async_depth=3)
    state = {}

    def cb(req, tok):
        if len(req.tokens) == 3:
            eng.cancel(state["rb"])

    eng.add_request(Request(pa, max_new_tokens=8, stream=cb))
    state["rb"] = eng.add_request(Request(pb, max_new_tokens=8))
    eng.run()
    eng.assert_quiescent()
    assert eng.stats["async_overrun"] == 3
    assert GOODPUT.waste_by_why()["async_overrun"] == 3


# ------------------------------------------------ request tracker, flight
def _kinds(tracker, reqs):
    return [[e["kind"] for e in tracker.timeline(r.trace_id)["events"]]
            for r in reqs]


def test_request_events_and_flight_records_match_reference(pair, drafts):
    """Preemption, chunked prefill, a radix hit, speculative rounds, a
    beam group and a cancel: per request, the same event kinds in the
    same order; the same serving flight records."""
    REQUESTS.enable()
    J_REQUESTS.enable()
    J_FLIGHT.clear()
    extra = [(np.arange(7, 13), dict(max_new_tokens=4, num_beams=2))]
    jm, tm = pair
    out = {}
    for name, cls, req_cls, model, draft in (
            ("ref", JEngine, JRequest, jm, drafts[0]),
            ("port", LLMEngine, Request, tm, drafts[1])):
        eng = cls(model, **{**EKW, "num_slots": 4, "num_blocks": 14,
                            "preemption": True}, draft_model=draft,
                  spec_k=3)
        reqs = [req_cls(p, max_new_tokens=6) for p in _mix(4, 5, 4, 18)]
        reqs += [req_cls(p, **k) for p, k in extra]
        for r in reqs:
            eng.add_request(r)
        eng.step()
        eng.step()
        eng.cancel(reqs[1].req_id)
        eng.run()
        eng.assert_quiescent()
        out[name] = (reqs, eng)
    (jr, je), (tr, te) = out["ref"], out["port"]
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert te.stats["preemptions"] == je.stats["preemptions"] > 0
    assert _kinds(REQUESTS, tr) == _kinds(J_REQUESTS, jr)
    assert [r.trace_summary["finish_reason"] for r in tr] == \
        [r.trace_summary["finish_reason"] for r in jr]
    assert any("beam" == r.finish_reason for r in tr)

    def serving(rec):
        return [(e["kind"], e.get("rid"), e.get("phase"))
                for e in rec.events() if e["kind"].startswith("serving.")]
    assert serving(FLIGHT) == serving(J_FLIGHT)
    assert any(k == "serving.preempt" for k, _, _ in serving(FLIGHT))


def test_fault_firings_land_in_the_flight_ring(pair):
    FAULTS.install("serving.tick", on={0}, exc=RuntimeError)
    eng = LLMEngine(pair[1], **EKW)
    eng.add_request(Request(np.arange(3, 8), max_new_tokens=3))
    with pytest.raises(RuntimeError):
        eng.step()
    eng.run()
    kinds = [(e["kind"], e.get("site")) for e in FLIGHT.events()]
    assert ("fault", "serving.tick") in kinds


# --------------------------------------------------------- tick breakdown
def _sums():
    hist = METRICS.get("serving_tick_breakdown_seconds")
    parts = {p: hist.value(phase=p) for p in PHASES}
    return parts, METRICS.get("serving_tick_seconds").value()


@pytest.mark.parametrize("depth", [0, 2])
def test_tick_breakdown_reconciles_tick_for_tick(pair, drafts, depth):
    """After every tick each phase observed exactly one sample and the
    five sum to the tick's total; at async_depth the hidden host time is
    observed once a tick too."""
    kw = (dict(draft_model=drafts[1], spec_k=3) if depth == 0
          else dict(async_depth=depth))
    eng = LLMEngine(pair[1], num_slots=4, block_size=8, max_prompt_len=16,
                    max_seq_len=64, **kw)
    rs = np.random.RandomState(0)
    for n in (4, 7, 11, 5, 9):
        eng.add_request(Request(rs.randint(0, 64, (n,)), max_new_tokens=8))
    hid = METRICS.get("serving_tick_host_hidden_seconds")
    ticks = 0
    while eng.has_work():
        eng.step()
        ticks += 1
        parts, tick = _sums()
        assert tick["count"] == ticks
        for p in PHASES:
            assert parts[p]["count"] == ticks, p
        total = sum(parts[p]["sum"] for p in PHASES)
        assert math.isclose(total, tick["sum"], rel_tol=1e-9)
        if depth:
            assert hid.value()["count"] == ticks
    eng.assert_quiescent()
    assert ticks > 2
    hist = METRICS.get("serving_tick_breakdown_seconds")
    busy = ("prefill", "draft", "verify") if depth == 0 else ("prefill",
                                                              "sample")
    for p in busy:
        assert hist.value(phase=p)["sum"] > 0.0, p
    anat = roofline.serving_roofline_report()["tick_anatomy"]
    assert anat["ticks_seconds"] == pytest.approx(_sums()[1]["sum"])
    assert 0.0 <= anat["overlap_fraction"] <= 1.0
