"""Speculative decoding in the port against the reference.

Ports ``tests/test_serving_spec.py`` (all but
``test_beam_requests_never_speculate``: beams are ROADMAP.md queue 1
item 5(f)), ``tests/test_paged_rewind.py`` and the first three tests of
``tests/test_spec_draft_reuse.py`` (the seeding read from ``draft_cur``
and the reuse counter; the goodput ledger waits for item 5(h)) to
``paddle_tpu_torch``. Against the JAX package, with the same weights
(fp32): ``_forward_rows`` over the dense draft cache, the verify chunk
and rewind, and the engine's greedy speculative streams token for token
— with a draft equal to the target, an unrelated draft, chunked
prefill, preemption, and an int8 KV pool.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import decoding as jdecoding
from paddle_tpu.models import paged as jpaged
from paddle_tpu.models import speculative as jspec
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models.decoding import KVCache
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.paged import (PagedKVCache, RefBlockManager,
                                           greedy_accept_length,
                                           llama_prefill_chunk_paged,
                                           llama_prefill_paged,
                                           llama_verify_chunk_paged,
                                           spec_advance_frontiers,
                                           spec_rewind_lens,
                                           stochastic_accept_row)
from paddle_tpu_torch.models.speculative import _forward_rows
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving.telemetry import _SPEC_DRAFT_REUSE
from paddle_tpu_torch.utils.faults import FAULTS
from tests.test_torch_common import F32_TOL, tiny_pair, to_np

pytestmark = pytest.mark.chaos

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def dpair():
    # an unrelated tiny model: near-zero acceptance, which stresses the
    # reject/rewind path far harder than a well-matched draft would
    return tiny_pair(seed=1, **{**TINY, "num_hidden_layers": 1})


@pytest.fixture(scope="module")
def draft(dpair):
    return dpair[1]


@pytest.fixture(autouse=True)
def _hygiene():
    FAULTS.clear()
    METRICS.reset()
    yield
    FAULTS.clear()


def _prompts(n, rs, lo=3, hi=12):
    return [rs.randint(0, 64, (int(l),)) for l in rs.randint(lo, hi, size=n)]


def _run(eng, prompts, max_new=10, **kw):
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=max_new, **kw))
    out = eng.run()
    return {rid: list(map(int, t)) for rid, t in out.items()}


def _baseline(model, prompts, max_new=10, **ekw):
    kw = dict(num_slots=4, block_size=8, max_prompt_len=16, max_seq_len=64)
    kw.update(ekw)
    return _run(LLMEngine(model, device="cpu", **kw), prompts, max_new)


def _jrun(model, prompts, max_new=10, **kw):
    eng = JEngine(model, **kw)
    for p in prompts:
        eng.add_request(JRequest(p, max_new_tokens=max_new))
    out = eng.run()
    return {rid: list(map(int, t)) for rid, t in out.items()}, eng


# ------------------------------------------------------ greedy identity
@pytest.mark.parametrize("which_draft", ["unrelated", "self"])
def test_greedy_spec_identical_to_nonspec_and_reference(pair, dpair,
                                                        which_draft):
    """Token-for-token identity at temperature 0, at both extremes of
    draft quality: an unrelated draft (everything rejected — pure rewind
    exercise) and draft == target (everything accepted — pure
    multi-commit exercise); and the same streams and spec counts as the
    reference engine with the same weights."""
    jm, tm = pair
    jd, td = (jm, tm) if which_draft == "self" else dpair
    rs = np.random.RandomState(0)
    prompts = _prompts(6, rs)
    base = _baseline(tm, prompts)
    kw = dict(spec_k=4, num_slots=4, block_size=8, max_prompt_len=16,
              max_seq_len=64)
    eng = LLMEngine(tm, draft_model=td, device="cpu", **kw)
    spec = _run(eng, prompts)
    assert spec == base
    eng.assert_quiescent()
    assert eng.stats["spec_ticks"] > 0
    assert eng.stats["spec_proposed"] > 0
    if which_draft == "self":
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"]
    want, jeng = _jrun(jm, prompts, draft_model=jd, **kw)
    assert spec == want
    for k in ("spec_ticks", "spec_proposed", "spec_accepted"):
        assert eng.stats[k] == jeng.stats[k], k


def test_greedy_spec_identical_under_preemption_chaos(model):
    """Induced preemptions evict mid-spec requests (the draft frontier
    resets), replay rebuilds them, and outputs stay the greedy chain."""
    rs = np.random.RandomState(10)
    prompts = _prompts(5, rs, lo=4, hi=12)
    base = _baseline(model, prompts, max_new=8,
                     num_slots=2, block_size=4, max_seq_len=32,
                     preemption=True)
    FAULTS.install("serving.preempt", every=2, times=8,
                   action=lambda ctx: ctx["engine"]._preempt())
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=2,
                    block_size=4, max_prompt_len=16, max_seq_len=32,
                    preemption=True, device="cpu")
    spec = _run(eng, prompts, max_new=8)
    assert eng.stats["preemptions"] > 0, "schedule never fired"
    assert spec == base
    eng.assert_quiescent()


def test_spec_with_tight_block_pool_preempt_replay(model):
    """A pool too small for all slots forces organic evict/replay while
    speculation is staging multi-block reservations."""
    rs = np.random.RandomState(3)
    prompts = _prompts(5, rs)
    base = _baseline(model, prompts, max_new=12, num_slots=4,
                     block_size=4, num_blocks=18, preemption=True,
                     max_seq_len=48)
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                    block_size=4, num_blocks=18, max_prompt_len=16,
                    max_seq_len=48, preemption=True, device="cpu")
    spec = _run(eng, prompts, max_new=12)
    assert spec == base
    eng.assert_quiescent()


def test_spec_composes_with_chunked_prefill(pair):
    """Prompts longer than max_prompt_len chunk-prefill in; the slot's
    first spec round then catch-up-feeds the whole committed sequence
    into the empty draft cache before proposing (the reference's streams
    too)."""
    jm, tm = pair
    rs = np.random.RandomState(6)
    prompts = _prompts(4, rs, lo=14, hi=30)
    kw = dict(num_slots=2, block_size=4, max_prompt_len=8, max_seq_len=48)
    base = _baseline(tm, prompts, **kw)
    eng = LLMEngine(tm, draft_model=tm, spec_k=4, device="cpu", **kw)
    spec = _run(eng, prompts)
    assert spec == base
    assert eng.stats["spec_ticks"] > 0
    eng.assert_quiescent()
    want, _ = _jrun(jm, prompts, draft_model=jm, spec_k=4, **kw)
    assert spec == want


def test_spec_over_int8_pool_matches_reference(pair, dpair):
    """An int8 KV pool under speculation: the verify reads the pool in
    K3's int8 mode (the plain version here). Greedy streams equal the
    port's int8 engine without speculation and the reference's int8
    speculative engine."""
    jm, tm = pair
    jd, td = dpair
    rs = np.random.RandomState(8)
    prompts = _prompts(5, rs, lo=4, hi=20)
    kw = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=48,
              kv_dtype="int8")
    base = _baseline(tm, prompts, **kw)
    for jdraft, tdraft in ((jm, tm), (jd, td)):
        eng = LLMEngine(tm, draft_model=tdraft, spec_k=3, device="cpu", **kw)
        spec = _run(eng, prompts)
        assert eng.cache.k_scale_store
        assert eng.stats["spec_ticks"] > 0
        assert spec == base
        eng.assert_quiescent()
        want, _ = _jrun(jm, prompts, draft_model=jdraft, spec_k=3, **kw)
        assert spec == want


# --------------------------------------------------- chaos: spec_verify
def test_spec_verify_fault_is_exception_atomic(model):
    """An injected fault before the verify must (a) not leak blocks, (b)
    fall back to the one-token tick for that round, (c) leave outputs
    exactly the non-spec greedy chain."""
    rs = np.random.RandomState(0)
    prompts = _prompts(5, rs)
    base = _baseline(model, prompts)
    FAULTS.install("serving.spec_verify", every=2, times=4)
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                    block_size=8, max_prompt_len=16, max_seq_len=64,
                    device="cpu")
    spec = _run(eng, prompts)
    assert eng.stats["spec_fallbacks"] > 0, "fault never fired"
    assert spec == base
    eng.assert_quiescent()
    snap = METRICS.snapshot()["counters"]
    assert snap['faults_injected_total{site="serving.spec_verify"}'] > 0
    assert snap["serving_spec_fallbacks_total"] >= eng.stats["spec_fallbacks"]


# ------------------------------------------------- kill switch / gating
def test_kill_switch_disables_speculation(model, monkeypatch):
    monkeypatch.setenv("PT_SPEC_DECODE", "0")
    rs = np.random.RandomState(0)
    prompts = _prompts(4, rs)
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                    block_size=8, max_prompt_len=16, max_seq_len=64,
                    device="cpu")
    spec = _run(eng, prompts)
    assert eng.stats["spec_ticks"] == 0
    assert spec == _baseline(model, prompts)
    eng.assert_quiescent()


def test_async_engine_drains_for_speculation(model):
    """With a draft and ``async_depth=2`` every decoding tick would
    speculate, so the pipeline never cruises (reason ``spec``) and the
    streams are the synchronous speculative engine's."""
    rs = np.random.RandomState(2)
    prompts = _prompts(3, rs)
    kw = dict(draft_model=model, spec_k=4, num_slots=4, block_size=8,
              max_prompt_len=16, max_seq_len=64, device="cpu")
    want = _run(LLMEngine(model, **kw), prompts)
    eng = LLMEngine(model, async_depth=2, **kw)
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=10))
    eng.step()
    assert eng._async_block_reason() == "spec"
    out = {rid: list(map(int, t)) for rid, t in eng.run().items()}
    assert out == want
    assert not eng._async_win
    eng.assert_quiescent()


# --------------------------------------------------- sampling / adaptive
def test_stochastic_spec_runs_and_respects_budgets(model):
    """temperature > 0 through the accept/reject/resample path: lengths
    honour max_new_tokens and the engine drains clean."""
    rs = np.random.RandomState(1)
    prompts = _prompts(5, rs)
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                    block_size=8, max_prompt_len=16, max_seq_len=64,
                    device="cpu")
    out = _run(eng, prompts, max_new=12, temperature=0.8, top_p=0.95)
    assert all(len(v) == 12 for v in out.values())
    assert eng.stats["spec_accepted"] > 0    # draft==target: plenty accepted
    eng.assert_quiescent()


def test_spec_probs_match_the_sampler_filter(model):
    """The accept rule's host distribution is the softmax of exactly the
    logits the one-token tick samples from (``decoding.filter_rows``)."""
    from paddle_tpu_torch.models.decoding import filter_rows
    eng = LLMEngine(model, draft_model=model, num_slots=2, block_size=8,
                    max_prompt_len=16, max_seq_len=64, top_k=20,
                    device="cpu")
    rs = np.random.RandomState(4)
    row = rs.randn(64).astype(np.float32) * 3
    for temp, top_p in ((0.7, 0.9), (1.3, 1.0), (0.5, 0.3)):
        want = torch.softmax(filter_rows(
            torch.as_tensor(row)[None], torch.tensor([temp]),
            torch.tensor([top_p]), 20)[0].double(), -1).numpy()
        np.testing.assert_allclose(eng._spec_probs(row, temp, top_p), want,
                                   atol=1e-6)


def test_adaptive_k_shrinks_on_bad_draft(model, draft):
    """With an unrelated draft nearly everything is rejected, so the
    per-slot EMA must drive k to the floor; with draft==target it must
    stay at the ceiling."""
    rs = np.random.RandomState(2)
    prompts = _prompts(4, rs)
    bad = LLMEngine(model, draft_model=draft, spec_k=4, num_slots=4,
                    block_size=8, max_prompt_len=16, max_seq_len=96,
                    device="cpu")
    _run(bad, prompts, max_new=24)
    good = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                     block_size=8, max_prompt_len=16, max_seq_len=96,
                     device="cpu")
    _run(good, prompts, max_new=24)
    bad_rate = bad.stats["spec_accepted"] / max(bad.stats["spec_proposed"], 1)
    good_rate = (good.stats["spec_accepted"]
                 / max(good.stats["spec_proposed"], 1))
    assert good_rate == 1.0
    assert bad_rate < 0.5
    # adaptive k throttled drafting: fewer proposals per spec tick
    assert (bad.stats["spec_proposed"] / bad.stats["spec_ticks"]
            < good.stats["spec_proposed"] / good.stats["spec_ticks"])


def test_spec_metrics_exported(model):
    rs = np.random.RandomState(0)
    prompts = _prompts(3, rs)
    eng = LLMEngine(model, draft_model=model, spec_k=4, num_slots=4,
                    block_size=8, max_prompt_len=16, max_seq_len=64,
                    device="cpu")
    _run(eng, prompts)
    snap = METRICS.snapshot()
    assert snap["counters"]["serving_spec_proposed_total"] > 0
    assert snap["counters"]["serving_spec_accepted_total"] > 0
    assert 0.0 <= snap["gauges"]["serving_spec_acceptance_rate"] <= 1.0
    hist = [k for k in snap.get("histograms", {})
            if k.startswith("serving_spec_tokens_per_tick")]
    assert hist, "tokens-per-tick histogram missing"
    assert eng.stats["spec_draft_s"] > 0 and eng.stats["spec_verify_s"] > 0


# --------------------------------------------------------- ctor gating
def test_spec_rejects_vocab_mismatch_window_and_dynamic_rope(model):
    cfg = LlamaConfig.tiny(num_hidden_layers=1, hidden_size=32,
                           num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=32)
    kw = dict(num_slots=2, block_size=8, max_prompt_len=16, max_seq_len=64,
              device="cpu")
    with pytest.raises(ValueError):
        LLMEngine(model, draft_model=LlamaForCausalLM(cfg, device="cpu"),
                  **kw)
    with pytest.raises(ValueError):
        LLMEngine(model, draft_model=model, spec_k=0, **kw)
    win = LlamaForCausalLM(LlamaConfig.tiny(**{**TINY,
                                               "sliding_window": 8}),
                           device="cpu")
    with pytest.raises(NotImplementedError):
        LLMEngine(win, draft_model=model, **kw)
    dyn = LlamaForCausalLM(LlamaConfig.tiny(**{
        **TINY, "rope_scaling": {"type": "dynamic", "factor": 2.0}}),
        device="cpu")
    with pytest.raises(NotImplementedError):
        LLMEngine(dyn, draft_model=model, **kw)


# ------------------------------------------- the draft's row forward
def test_forward_rows_matches_reference(pair):
    """Two rounds of per-row chunks through the dense draft cache, with a
    write mask (a padding row, padding columns): logits and the written
    cache positions equal the reference's ``_forward_rows``."""
    jm, tm = pair
    cfg = tm.cfg
    rs = np.random.RandomState(5)
    b, cap = 3, 24
    tc = KVCache.init(cfg.num_hidden_layers, b, cap,
                      cfg.num_key_value_heads, 8, torch.float32,
                      device="cpu")
    jc = jdecoding.KVCache.init(cfg.num_hidden_layers, b, cap,
                                cfg.num_key_value_heads, 8, jnp.float32)
    pos = np.zeros(b, np.int32)
    for c, cl in ((6, np.array([6, 4, 0], np.int32)),
                  (3, np.array([3, 1, 2], np.int32))):
        ids = rs.randint(0, 64, (b, c)).astype(np.int32)
        got = _forward_rows(tm, ids, tc, pos, cl)
        want, jc = jspec._forward_rows(jm, jnp.asarray(ids), jc,
                                       jnp.asarray(pos), None,
                                       jnp.asarray(cl))
        live = np.arange(c)[None, :] < cl[:, None]
        np.testing.assert_allclose(to_np(got)[live], np.asarray(want)[live],
                                   **F32_TOL)
        pos = pos + cl
    for li in range(cfg.num_hidden_layers):
        for r in range(b):
            n = int(pos[r])
            np.testing.assert_allclose(to_np(tc.view_k(li))[r, :n],
                                       np.asarray(jc.k[li])[r, :n],
                                       **F32_TOL)
            np.testing.assert_allclose(to_np(tc.view_v(li))[r, :n],
                                       np.asarray(jc.v[li])[r, :n],
                                       **F32_TOL)
            # nothing past the frontier was written (the sink took it)
            assert not to_np(tc.view_k(li))[r, n:].any()


# --------------------------------------------------- paged rewind units
def _fresh(cfg, nb=16, bs=4, slots=2, mb=8, kv_dtype=None):
    return PagedKVCache.init(cfg.num_hidden_layers, nb, bs,
                             cfg.num_key_value_heads,
                             cfg.hidden_size // cfg.num_attention_heads,
                             slots, mb, torch.float32, kv_dtype=kv_dtype,
                             device="cpu")


def _prefill(model, cache, slot, seq, mgr, key, mb=8):
    t = mgr.allocate(key, len(seq))
    rows = np.full((1, mb), mgr.num_blocks, np.int32)
    rows[0, :len(t)] = t
    last, cache = llama_prefill_paged(
        model, np.asarray(seq)[None], np.asarray([len(seq)]), cache,
        np.asarray([slot], np.int32), rows)
    return last, cache, t


def test_rewind_touches_only_lens(model):
    cache = _fresh(model.cfg)
    cache.lens[:] = torch.tensor([11, 5], dtype=cache.lens.dtype)
    tables_before = cache.block_tables.clone()
    out = spec_rewind_lens(cache, np.asarray([0], np.int32),
                           np.asarray([7], np.int32))
    assert out is cache                      # in place
    assert cache.lens.tolist() == [7, 5]
    assert torch.equal(cache.block_tables, tables_before)
    # sentinel slot ids (OOB) must drop, not clamp onto the last row
    spec_rewind_lens(cache, np.asarray([0, 99], np.int32),
                     np.asarray([3, 1], np.int32))
    assert cache.lens.tolist() == [3, 5]


def test_advance_frontiers_scalar_and_array():
    pos, dpos = spec_advance_frontiers(10, 12, 3)
    assert (pos, dpos) == (13, 12)
    pos, dpos = spec_advance_frontiers(10, 15, 2)
    assert (pos, dpos) == (12, 12)      # frontier clamped back to pos
    p, d = spec_advance_frontiers(np.array([4, 8]), np.array([9, 8]),
                                  np.array([1, 3]))
    assert p.tolist() == [5, 11] and d.tolist() == [5, 8]


def test_greedy_accept_length_shapes():
    assert int(greedy_accept_length(np.array([3, 5, 7]), [3, 5, 9])) == 2
    assert int(greedy_accept_length(np.array([3, 5, 7]), [1, 5, 7])) == 0
    assert int(greedy_accept_length(np.array([3, 5, 7]), [3, 5, 7])) == 3
    out = greedy_accept_length(np.array([[1, 2], [1, 2]]),
                               np.array([[1, 9], [1, 2]]))
    assert out.tolist() == [1, 2]


def test_stochastic_accept_row_extremes_and_reference():
    V = 8
    q = np.zeros(V)
    q[3] = 1.0
    bonus = np.zeros(V)
    bonus[5] = 1.0
    rs = np.random.RandomState(0)
    # p == q on the proposal: always accepted, bonus from p[last]
    assert stochastic_accept_row([3], [q], [q, bonus], rs) == ([3, 5], 1)
    # p puts zero mass on the proposal: rejected, resample from p - q
    p0 = np.zeros(V)
    p0[6] = 1.0
    assert stochastic_accept_row([3], [q], [p0, bonus], rs) == ([6], 0)
    # random rows: the same draws from the same RandomState as the
    # reference's rule
    g = np.random.RandomState(9)
    for _ in range(20):
        k = g.randint(1, 4)
        qs = [g.dirichlet(np.ones(V)) for _ in range(k)]
        ps = [g.dirichlet(np.ones(V)) for _ in range(k + 1)]
        props = [int(g.randint(V)) for _ in range(k)]
        seed = int(g.randint(1 << 30))
        assert (stochastic_accept_row(props, qs, ps,
                                      np.random.RandomState(seed))
                == jpaged.stochastic_accept_row(
                    props, qs, ps, np.random.RandomState(seed)))


def test_rewind_past_block_boundary_then_reappend(pair):
    """Verify writes 5 tokens crossing into a third block (lens 6 -> 11),
    rewind keeps one (lens 7 — back across the block-2 boundary at 8),
    then appending the real continuation over the stale region yields
    logits identical to a straight prefill of the committed sequence; the
    verify logits equal the reference's."""
    jm, tm = pair
    cfg = tm.cfg
    rs = np.random.RandomState(0)
    seq0 = rs.randint(0, 64, (6,))
    vtoks = rs.randint(0, 64, (5,))          # speculative: positions 6..10
    cont = rs.randint(0, 64, (3,))           # real continuation: 7..9

    mgr = RefBlockManager(16, 4)
    cache = _fresh(cfg)
    _, cache, _ = _prefill(tm, cache, 0, seq0, mgr, "a")
    t = mgr.allocate("a", 11)                # cover the verify worst case
    rows = np.full((1, 8), 16, np.int32)
    rows[0, :len(t)] = t
    vl, cache = llama_verify_chunk_paged(
        tm, vtoks[None], np.asarray([5], np.int32),
        np.asarray([6], np.int32), cache, np.asarray([0], np.int32), rows)
    assert int(cache.lens[0]) == 11
    # the reference's verify over the same prefix
    jc = jpaged.PagedKVCache.init(cfg.num_hidden_layers, 16, 4,
                                  cfg.num_key_value_heads, 8, 2, 8,
                                  jnp.float32)
    jmgr = jpaged.RefBlockManager(16, 4)
    jt = jmgr.allocate("a", 6)
    jrows = np.full((1, 8), 16, np.int32)
    jrows[0, :len(jt)] = jt
    _, jc = jpaged.llama_prefill_paged(
        jm, jnp.asarray(seq0[None]), jnp.asarray([6]), jc,
        jnp.asarray([0], jnp.int32), jnp.asarray(jrows))
    jt = jmgr.allocate("a", 11)
    jrows[0, :len(jt)] = jt
    jvl, _ = jpaged.llama_verify_chunk_paged(
        jm, jnp.asarray(vtoks[None]), jnp.asarray([5], jnp.int32),
        jnp.asarray([6], jnp.int32), jc, jnp.asarray([0], jnp.int32),
        jnp.asarray(jrows))
    np.testing.assert_allclose(to_np(vl), np.asarray(jvl), **F32_TOL)
    spec_rewind_lens(cache, np.asarray([0], np.int32),
                     np.asarray([7], np.int32))
    assert int(cache.lens[0]) == 7
    last, cache = llama_prefill_chunk_paged(
        tm, cont[None], np.asarray([3], np.int32), np.asarray([7], np.int32),
        cache, np.asarray([0], np.int32), rows)
    committed = np.concatenate([seq0, vtoks[:1], cont])
    ref_last, _, _ = _prefill(tm, _fresh(cfg), 0, committed,
                              RefBlockManager(16, 4), "ref")
    np.testing.assert_allclose(to_np(last), to_np(ref_last),
                               rtol=2e-4, atol=2e-5)


def test_rewind_to_zero_reuses_slot(model):
    """Full rollback: lens -> 0 leaves the slot reusable for an unrelated
    sequence over the same block rows."""
    cfg = model.cfg
    rs = np.random.RandomState(1)
    seq0 = rs.randint(0, 64, (9,))
    seq1 = rs.randint(0, 64, (7,))
    mgr = RefBlockManager(16, 4)
    cache = _fresh(cfg)
    _, cache, t = _prefill(model, cache, 0, seq0, mgr, "a")
    spec_rewind_lens(cache, np.asarray([0], np.int32),
                     np.asarray([0], np.int32))
    assert int(cache.lens[0]) == 0
    rows = np.full((1, 8), 16, np.int32)
    rows[0, :len(t)] = t
    last, cache = llama_prefill_chunk_paged(
        model, seq1[None], np.asarray([7], np.int32),
        np.asarray([0], np.int32), cache, np.asarray([0], np.int32), rows)
    ref_last, _, _ = _prefill(model, _fresh(cfg), 0, seq1,
                              RefBlockManager(16, 4), "ref")
    np.testing.assert_allclose(to_np(last), to_np(ref_last),
                               rtol=2e-4, atol=2e-5)


def test_rewind_after_preempt_replay_in_engine(model):
    """Rewinds interleaved with evict/replay (the draft frontier resets to
    zero on preemption) still produce the exact greedy chain."""
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 64, (int(n),)) for n in rs.randint(4, 12, 3)]

    def run(eng):
        for p in prompts:
            eng.add_request(Request(p, max_new_tokens=8))
        return {r: list(map(int, t)) for r, t in eng.run().items()}

    base = run(LLMEngine(model, num_slots=2, block_size=4,
                         max_prompt_len=16, max_seq_len=32,
                         preemption=True, device="cpu"))
    FAULTS.install("serving.preempt", every=4, times=5,
                   action=lambda ctx: ctx["engine"]._preempt())
    eng = LLMEngine(model, draft_model=model, spec_k=3, num_slots=2,
                    block_size=4, max_prompt_len=16, max_seq_len=32,
                    preemption=True, device="cpu")
    spec = run(eng)
    FAULTS.clear()
    assert eng.stats["preemptions"] > 0
    assert spec == base
    eng.assert_quiescent()


# ------------------------------------------------ draft reuse (radix)
def _reuse_kw(model, **kw):
    # one slot: the second request is guaranteed to land on the slot
    # whose draft cache holds the first request's prefix
    base = dict(num_slots=1, block_size=8, max_prompt_len=16,
                max_seq_len=96, draft_model=model, prefix_caching=True,
                device="cpu")
    base.update(kw)
    return base


def _two_phase(model, rs, **ekw):
    """Two sequential requests sharing a 24-token prefix; returns
    (outputs, the second request's seeded ``draft_cur`` read at its first
    token, the reuse counter's rise)."""
    shared = rs.randint(0, 64, (24,))
    p1 = np.concatenate([shared, rs.randint(0, 64, (4,))])
    p2 = np.concatenate([shared, rs.randint(0, 64, (4,))])
    eng = LLMEngine(model, **_reuse_kw(model, **ekw))
    o1 = _run(eng, [p1], max_new=8)
    seeded = []
    r0 = _SPEC_DRAFT_REUSE.value()
    eng.add_request(Request(
        p2, max_new_tokens=8,
        stream=lambda req, tok: (seeded.append(int(eng.draft_cur[0]))
                                 if len(req.tokens) == 1 else None)))
    o2 = {r: list(map(int, t)) for r, t in eng.run().items()}
    eng.assert_quiescent()
    return {**o1, **o2}, seeded[0], _SPEC_DRAFT_REUSE.value() - r0


def test_radix_hit_seeds_draft(model, monkeypatch):
    """With reuse on, the adopted span's draft re-feed is skipped:
    ``draft_cur`` starts past the shared prefix and the counter rises by
    the same amount; with ``PT_DRAFT_REUSE=0`` it starts at 0 — and the
    outputs are identical either way (reuse changes speed, never
    tokens)."""
    out_on, seeded_on, reuse_on = _two_phase(model,
                                             np.random.RandomState(3))
    assert seeded_on == reuse_on >= 16      # two whole shared blocks
    monkeypatch.setenv("PT_DRAFT_REUSE", "0")
    out_off, seeded_off, reuse_off = _two_phase(model,
                                                np.random.RandomState(3))
    assert seeded_off == reuse_off == 0
    assert list(out_on.values()) == list(out_off.values())


def test_unrelated_prompt_reuses_nothing(model):
    """No shared prefix -> no radix adoption -> the seeding stays at 0
    even though the slot's resident draft cache is warm."""
    rs = np.random.RandomState(4)
    eng = LLMEngine(model, **_reuse_kw(model))
    _run(eng, [rs.randint(0, 64, (24,))])
    r0 = _SPEC_DRAFT_REUSE.value()
    _run(eng, [rs.randint(0, 64, (24,))])
    assert _SPEC_DRAFT_REUSE.value() == r0


def test_reuse_with_unrelated_draft_model(model, draft):
    """A near-zero-acceptance draft stresses the rollback/snapshot path:
    resident snapshots must track the COMMITTED prefix, so the second
    request still reuses and still matches the spec-less outputs."""
    out_on, seeded, reuse = _two_phase(model, np.random.RandomState(5),
                                       draft_model=draft)
    assert seeded == reuse > 0
    rs = np.random.RandomState(5)
    shared = rs.randint(0, 64, (24,))
    p1 = np.concatenate([shared, rs.randint(0, 64, (4,))])
    p2 = np.concatenate([shared, rs.randint(0, 64, (4,))])
    plain = LLMEngine(model, **{**_reuse_kw(model), "draft_model": None})
    base = {**_run(plain, [p1], max_new=8), **_run(plain, [p2], max_new=8)}
    assert list(out_on.values()) == list(base.values())
