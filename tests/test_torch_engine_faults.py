"""The port's engine under the reference's chaos schedules.

Ports the chaos runs of ``tests/test_serving_robustness.py`` (seeded
allocator failures, induced preemption, tick exceptions, deadlines under
allocator pressure) to ``paddle_tpu_torch.serving.LLMEngine``: every
injected failure goes through the same recovery as the reference's, the
run drains with no leaked block, and every greedy stream equals the
un-faulted run's and the reference engine's (same weights, fp32). Also:
the ``serving.prefix_evict`` site leaves the radix trie, refcounts and
free list as they were; every fault site the port names is one of the
reference's ``SITES`` and the engine's sites fire; and the card-shape
refusal of the engine's constructor (:func:`card_shape_error`).
"""
import pathlib
import re

import numpy as np
import pytest

from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.paged import RadixPrefixBlockManager
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving.engine import card_shape_error
from paddle_tpu_torch.utils import faults
from paddle_tpu_torch.utils.faults import FAULTS, SITES, InjectedFault
from tests.test_torch_common import tiny_pair

pytestmark = pytest.mark.chaos

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
# the engine sites the reference fires around its tick and allocator
ENGINE_SITES = ("serving.alloc", "serving.tick", "serving.preempt",
                "serving.prefix_evict")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(autouse=True)
def _port_hygiene():
    """No port fault rule or metric series leaks across tests."""
    FAULTS.clear()
    METRICS.reset()
    yield
    FAULTS.clear()
    METRICS.reset()


class FakeClock:
    """Deterministic engine clock: tests advance it explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _prompts(seed, n, lo, hi):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 64, (int(k),)) for k in rs.randint(lo, hi, n)]


def _clean(eng_cls, req_cls, model, prompts, new, **kw):
    """Un-faulted streams of ``prompts`` (one engine, every request at
    once, greedy)."""
    eng = eng_cls(model, **kw)
    ids = [eng.add_request(req_cls(p, max_new_tokens=new)) for p in prompts]
    eng.run()
    eng.assert_quiescent()
    return [list(map(int, eng.requests[i].tokens)) for i in ids]


def _references(pair, prompts, new, **kw):
    """(the port's un-faulted streams, the reference engine's): they must
    agree before a chaos run is held to them."""
    jm, tm = pair
    port = _clean(LLMEngine, Request, tm, prompts, new, **kw)
    ref = _clean(JEngine, JRequest, jm, prompts, new, **kw)
    assert port == ref
    return port


def _step_through(eng, exc, clock=None, max_ticks=400):
    ticks = 0
    while eng.has_work():
        try:
            eng.step()
        except exc:
            # a transient injected failure raised before any mutation of
            # the tick: the supervisor retries the tick
            pass
        if clock is not None:
            clock.t += 1.0
        ticks += 1
        assert ticks < max_ticks, "livelock under chaos"


EKW = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=32,
           preemption=True)


def test_chaos_allocator_failures_no_leaks_exact_outputs(pair):
    """Seeded allocator-failure schedule under preemption: every injected
    MemoryError routes through preempt-and-retry; the run drains with no
    leaked block and every stream equals the un-faulted one."""
    prompts = _prompts(9, 6, 4, 12)
    want = _references(pair, prompts, 6, **EKW)
    FAULTS.schedule("serving.alloc", seed=42, p=0.25, horizon=200,
                    exc=MemoryError, times=20)
    eng = LLMEngine(pair[1], **EKW)
    ids = [eng.add_request(Request(p, max_new_tokens=6)) for p in prompts]
    _step_through(eng, MemoryError)
    assert FAULTS.log, "schedule never fired — test is vacuous"
    assert [list(map(int, eng.requests[i].tokens)) for i in ids] == want
    eng.assert_quiescent()
    snap = METRICS.snapshot()["counters"]
    assert snap['faults_injected_total{site="serving.alloc"}'] == \
        len(FAULTS.log)


def test_chaos_induced_preemption_exact_outputs(pair):
    """A serving.preempt rule calls engine._preempt() on a seeded cadence:
    victims re-queue with their progress and still produce the un-faulted
    greedy streams."""
    prompts = _prompts(10, 4, 4, 12)
    want = _references(pair, prompts, 6, **EKW)
    FAULTS.install("serving.preempt", every=5, times=6,
                   action=lambda ctx: ctx["engine"]._preempt())
    eng = LLMEngine(pair[1], **EKW)
    ids = [eng.add_request(Request(p, max_new_tokens=6)) for p in prompts]
    _step_through(eng, ())
    assert eng.stats["preemptions"] > 0
    assert [list(map(int, eng.requests[i].tokens)) for i in ids] == want
    eng.assert_quiescent()
    snap = METRICS.snapshot()["counters"]
    assert snap["serving_preemptions_total"] == eng.stats["preemptions"]
    assert snap['faults_injected_total{site="serving.preempt"}'] > 0


def test_chaos_tick_exception_engine_state_survives(pair):
    """An exception at the top of step() (before any mutation) leaves the
    engine resumable: catch it, keep stepping, finish exactly."""
    kw = dict(num_slots=1, block_size=4, max_prompt_len=16, max_seq_len=32)
    p = np.random.RandomState(11).randint(0, 64, (6,))
    want = _references(pair, [p], 6, **kw)
    FAULTS.install("serving.tick", on={2, 4}, exc=InjectedFault)
    eng = LLMEngine(pair[1], **kw)
    rid = eng.add_request(Request(p, max_new_tokens=6))
    _step_through(eng, InjectedFault, max_ticks=100)
    assert FAULTS.log == [("serving.tick", 2), ("serving.tick", 4)]
    assert [list(map(int, eng.requests[rid].tokens))] == want
    eng.assert_quiescent()


def test_chaos_deadlines_under_allocator_pressure(pair):
    """Deadlines + chaos together: timed-out requests report "timeout",
    survivors equal their un-faulted streams, nothing leaks."""
    clk = FakeClock()
    prompts = _prompts(12, 5, 4, 10)
    want = _references(pair, prompts, 8, **EKW)
    FAULTS.schedule("serving.alloc", seed=7, p=0.15, horizon=150,
                    exc=MemoryError, times=10)
    eng = LLMEngine(pair[1], clock=clk, **EKW)
    rids = [eng.add_request(Request(p, max_new_tokens=8,
                                    deadline_s=6.0 if i % 2 else None))
            for i, p in enumerate(prompts)]
    _step_through(eng, MemoryError, clock=clk)
    assert FAULTS.log
    timeouts = 0
    for i, rid in enumerate(rids):
        r = eng.requests[rid]
        assert r.done
        if r.finish_reason == "timeout":
            timeouts += 1
            continue
        assert list(map(int, r.tokens)) == want[i]
    assert timeouts > 0 and timeouts < len(rids)
    eng.assert_quiescent()


def _manager_state(mgr):
    """Everything an eviction mutates, as plain values."""
    trie = []
    stack = [(root, ()) for root in mgr._roots.values()]
    while stack:
        node, path = stack.pop()
        for j, ch in enumerate(node.children):
            key = path + (j,)
            trie.append((key, tuple(int(t) for t in ch.tokens),
                         tuple(ch.blocks), ch.touch))
            stack.append((ch, key))
    return dict(trie=sorted(trie), free=list(mgr._free),
                parked=set(mgr._parked), rc=dict(mgr._rc),
                in_trie=sorted(mgr._in_trie),
                tables={k: list(v) for k, v in mgr.tables.items()},
                epoch=mgr.cache_epoch, stats=dict(mgr.cache_stats),
                ledger=mgr.ledger.reconcile(mgr))


def test_prefix_evict_fault_leaves_trie_refcounts_and_free_list():
    """The site fires after the victim leaf is found and before any
    mutation: an injected exception leaves the trie, the refcounts, the
    parked set, the free list and the tables as they were, and the same
    allocation then evicts that leaf once the rule is gone."""
    mgr = RadixPrefixBlockManager(num_blocks=6, block_size=4)
    for rid, start in ((0, 0), (1, 100)):       # two parked 2-block spans
        toks = np.arange(start, start + 8, dtype=np.int32)
        mgr.allocate(rid, 8)
        mgr.commit_prefix(rid, toks)
        mgr.free(rid)
    mgr.allocate(2, 8)                          # the last two free blocks
    assert not mgr._free and len(mgr._parked) == 4
    before = _manager_state(mgr)
    with FAULTS.scope("serving.prefix_evict", exc=InjectedFault):
        with pytest.raises(InjectedFault):
            mgr.allocate(2, 12)                 # needs one eviction
    assert FAULTS.log == [("serving.prefix_evict", 0)]
    assert _manager_state(mgr) == before
    table = mgr.allocate(2, 12)
    assert len(table) == 3 and len(mgr._parked) == 3
    assert mgr.cache_stats["evictions"] == 1


def test_fault_sites_are_registered_and_the_engine_fires_them(pair):
    """The port's form of ``test_faults.py::test_sites_registry_matches_
    code``: every ``fault_point``/``fault_value`` site named in
    ``paddle_tpu_torch`` is one of the reference's ``SITES``, and the
    engine's sites — the four of the allocator, the tick, induced
    preemption and prefix eviction among them — are named in the code and
    fire in a run (rules that never match count the hits)."""
    pkg = pathlib.Path(faults.__file__).resolve().parents[1]
    pat = re.compile(r"fault_(?:point|value)\(\s*['\"]([a-z_.]+)['\"]")
    found = set()
    for py in pkg.rglob("*.py"):
        found |= set(pat.findall(py.read_text()))
    assert found <= set(SITES), sorted(found - set(SITES))
    assert set(ENGINE_SITES) | {"serving.moe_dispatch",
                                "serving.kv_quant"} <= found
    for site in ENGINE_SITES:
        FAULTS.install(site, on=set())
    # a pool of 10 blocks: finished prompts park their blocks in the
    # radix trie, later admissions evict them, growth preempts
    eng = LLMEngine(pair[1], num_slots=2, block_size=4, max_prompt_len=16,
                    max_seq_len=32, num_blocks=10, preemption=True)
    for p in _prompts(4, 6, 9, 14):
        eng.add_request(Request(p, max_new_tokens=8))
    eng.run()
    eng.assert_quiescent()
    assert eng.mgr.cache_stats["evictions"] > 0
    assert all(FAULTS.hits[s] > 0 for s in ENGINE_SITES), dict(FAULTS.hits)
    assert not FAULTS.log


@pytest.mark.parametrize("kw,what", [
    (dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4),
     "head dim 16"),
    (dict(hidden_size=2048, num_attention_heads=16, num_key_value_heads=1),
     "GQA group 16"),
    (dict(hidden_size=1280, num_attention_heads=16, num_key_value_heads=16),
     "head dim 80"),
    (dict(hidden_size=2048, num_attention_heads=16, num_key_value_heads=2),
     None),
    (dict(hidden_size=1024, num_attention_heads=16, num_key_value_heads=2),
     None),
    (dict(hidden_size=4096, num_attention_heads=16, num_key_value_heads=16),
     "head dim 256"),
], ids=["d16", "group16", "d80", "d128_group8", "d64_group8", "d256"])
def test_card_shape_error_names_the_refused_shape(kw, what):
    """The constructor's refusal on the card, as the pure function it
    calls: head dims outside 64/128 and GQA groups above 8 are named;
    the shapes the kernels take pass. Head dim 256 is refused too: the
    flash kernels (K2, K5) take it, the paged kernels (K3, K4) that the
    engine's decode runs do not, and the message names both families'
    head dims. On the CPU the engine still serves the refused shapes
    through the plain paths."""
    from paddle_tpu_torch.ops.cuda import flash_attention as _flash
    from paddle_tpu_torch.ops.cuda import paged_attention as _paged
    cfg = LlamaConfig.tiny(**kw)
    err = card_shape_error(cfg)
    if what is None:
        assert err is None
    else:
        assert err is not None and err.startswith(what)
    if what is not None and what.startswith("head dim"):
        assert str(_flash.HEAD_DIMS) in err and str(_paged.HEAD_DIMS) in err
    if what == "head dim 16":
        from paddle_tpu_torch.models.llama import LlamaForCausalLM
        eng = LLMEngine(LlamaForCausalLM(cfg, device="cpu"), num_slots=1,
                        block_size=4, max_prompt_len=8, max_seq_len=16)
        eng.add_request(Request(np.arange(1, 6), max_new_tokens=2))
        eng.run()
        eng.assert_quiescent()
