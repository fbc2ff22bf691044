"""Async pipelined decode in the port's engine (``LLMEngine(async_depth=K)``)
against its synchronous engine and the reference's.

Ports the cases of ``tests/test_async_decode.py`` that the port's
features reach: streams identical at depths 1-3 for greedy, temperature
and EOS, chunked prefill, induced preemption and radix adoption; the
device stop mask at the exact EOS boundary with no overrun (and the
generator rewound over masked ticks); ``serving.tick`` raised mid-window;
the ``PT_ASYNC_DECODE=0`` kill switch; depth validation; and the overrun
arithmetic of a cancel from a stream callback (counted in
``stats["async_overrun"]``: the goodput ledger is not ported yet). Each
async stream is held to the port's synchronous engine, and the greedy
ones also to the reference engine at the same depth (same weights,
fp32). The drain reasons ``growth`` and ``window`` are checked too, and
a cancel and an induced preemption while ticks are in flight.
"""
import numpy as np
import pytest

from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import executor as X
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import tiny_pair
from tests._torch_threads import one_torch_thread  # noqa: F401

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(autouse=True)
def _port_hygiene():
    FAULTS.clear()
    METRICS.reset()
    yield
    FAULTS.clear()
    METRICS.reset()


def _mk(model, cls=LLMEngine, **kw):
    args = dict(num_slots=3, block_size=4, max_prompt_len=16,
                max_seq_len=64, seed=7)
    args.update(kw)
    return cls(model, **args)


def _prompts(rs, n=6, lo=3, hi=14):
    return [rs.randint(2, 64, (int(k),)) for k in rs.randint(lo, hi, size=n)]


def _run(eng, prompts, new=10, req=Request, **rkw):
    for p in prompts:
        eng.add_request(req(p, max_new_tokens=new, **rkw))
    out = eng.run()
    eng.assert_quiescent()
    return {r: list(map(int, t)) for r, t in out.items()}


def _drains():
    c = METRICS.get("serving_async_drains_total")
    return {k[0]: v[0] for k, v in c._series.items()}


def _reference(pair, prompts, depth, new=10, **kw):
    """The reference engine's greedy streams at ``async_depth=depth``."""
    return _run(_mk(pair[0], JEngine, async_depth=depth, **kw), prompts,
                new, JRequest)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bit_identity_greedy_temperature_eos(pair, depth):
    tm = pair[1]
    prompts = _prompts(np.random.RandomState(3))
    for kw in (dict(), dict(temperature=0.8),
               dict(temperature=0.8, eos_token_id=1)):
        base = _run(_mk(tm, **kw), prompts)
        got = _run(_mk(tm, async_depth=depth, **kw), prompts)
        assert got == base, (depth, kw)
    assert _run(_mk(tm, async_depth=depth), prompts) == \
        _reference(pair, prompts, depth)
    # the pipeline engaged: windows drained, the depth gauge set
    assert sum(_drains().values()) > 0
    assert METRICS.get("serving_async_depth").value() == depth


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bit_identity_chunked_prefill(pair, depth):
    rs = np.random.RandomState(5)
    prompts = [rs.randint(2, 64, (40,)), rs.randint(2, 64, (9,)),
               rs.randint(2, 64, (25,))]
    kw = dict(num_slots=2, max_prompt_len=8)
    base = _run(_mk(pair[1], **kw), prompts, new=8)
    got = _run(_mk(pair[1], async_depth=depth, **kw), prompts, new=8)
    assert got == base
    assert got == _reference(pair, prompts, depth, new=8, **kw)


@pytest.mark.chaos
def test_bit_identity_preempt_replay_chaos(pair):
    prompts = _prompts(np.random.RandomState(3))

    def run(depth):
        FAULTS.clear()
        FAULTS.install("serving.preempt", every=4, times=3,
                       action=lambda ctx: ctx["engine"]._preempt())
        eng = _mk(pair[1], num_slots=2, max_seq_len=48, preemption=True,
                  async_depth=depth)
        out = _run(eng, prompts)
        FAULTS.clear()
        assert eng.stats["preemptions"] > 0
        return out

    base = run(0)
    for depth in (1, 2):
        assert run(depth) == base, depth


def test_bit_identity_radix_adoption(pair):
    """Two waves of shared-prefix prompts: the second wave adopts
    committed blocks from the radix trie between cruising windows."""
    rs = np.random.RandomState(11)
    stem = rs.randint(2, 64, (10,))
    waves = [np.concatenate([stem, rs.randint(2, 64, (int(k),))])
             for k in (3, 5, 2)]

    def run(cls, req, depth):
        eng = _mk(pair[1] if cls is LLMEngine else pair[0], cls,
                  prefix_caching=True, async_depth=depth)
        first = _run(eng, [stem], 6, req)
        second = {}
        for p in waves:
            rid = eng.add_request(req(p, max_new_tokens=6))
            second.update({r: list(map(int, t))
                           for r, t in eng.run().items() if r == rid})
        eng.assert_quiescent()
        return first, second, eng.mgr.cache_stats["token_hits"]

    b1, b2, bhits = run(LLMEngine, Request, 0)
    g1, g2, ghits = run(LLMEngine, Request, 2)
    assert (g1, g2) == (b1, b2)
    assert bhits > 0 and ghits == bhits          # adoption really happened
    j1, j2, _ = run(JEngine, JRequest, 2)
    assert (j1, j2) == (b1, b2)


def test_eos_stop_mask_exact_boundary_no_overrun(pair):
    """Lone slot, natural EOS: the device stop mask catches the boundary
    in the tick itself; over-dispatched ticks run fully masked (never
    counted as overrun) and the generator rewind leaves the noise stream
    where the synchronous loop leaves it — a sampled request served
    after the EOS one draws the synchronous engine's tokens."""
    tm = pair[1]
    rs = np.random.RandomState(9)
    p, q = rs.randint(2, 64, (7,)), rs.randint(2, 64, (5,))
    probe = _run(_mk(tm, num_slots=1), [p])
    eos = next(iter(probe.values()))[4]          # a token greedy emits

    def run(depth):
        eng = _mk(tm, num_slots=1, eos_token_id=eos, async_depth=depth)
        out = _run(eng, [p])
        (req,) = eng.requests.values()
        assert req.finish_reason == "eos"        # the boundary was hit
        after = _run(eng, [q], temperature=1.0)
        assert eng.stats["async_overrun"] == 0
        return out, after

    base = run(0)
    for depth in (1, 2, 3):
        assert run(depth) == base, depth
    assert _run(_mk(pair[0], JEngine, num_slots=1, eos_token_id=eos,
                    async_depth=2), [p], req=JRequest) == base[0]


@pytest.mark.chaos
def test_tick_chaos_mid_window_exception_atomic(pair):
    """A serving.tick fault raised while ticks are in flight drains the
    window first (why=exception): the request state when the fault
    surfaces — and after recovery — is the synchronous engine's, and the
    pool is clean."""
    prompts = _prompts(np.random.RandomState(3), n=2)

    def run(depth):
        FAULTS.clear()
        FAULTS.install("serving.tick", on={5}, exc=InjectedFault)
        eng = _mk(pair[1], num_slots=2, block_size=16, max_seq_len=64,
                  async_depth=depth)
        for p in prompts:
            eng.add_request(Request(p, max_new_tokens=10))
        mid = None
        try:
            while eng.has_work():
                eng.step()
        except InjectedFault:
            mid = {r: list(map(int, q.tokens))
                   for r, q in eng.requests.items()}
            while eng.has_work():
                eng.step()
        FAULTS.clear()
        eng.assert_quiescent()
        assert mid is not None                   # the fault really fired
        return mid, {r: list(map(int, q.tokens))
                     for r, q in eng.requests.items()}

    b_mid, b_out = run(0)
    for depth in (1, 2):
        g_mid, g_out = run(depth)
        assert g_mid == b_mid, depth
        assert g_out == b_out, depth
    assert _drains().get("exception", 0) > 0


def test_kill_switch_runs_the_synchronous_tick(pair, monkeypatch):
    """PT_ASYNC_DECODE=0 collapses async_depth at construction: the engine
    never dispatches an async tick and the streams are the synchronous
    engine's."""
    prompts = _prompts(np.random.RandomState(13), n=4)
    base = _run(_mk(pair[1]), prompts)
    calls = []
    orig = X.ModelExecutor.decode_tick_async

    def counted(self, *a):
        calls.append(1)
        return orig(self, *a)
    monkeypatch.setattr(X.ModelExecutor, "decode_tick_async", counted)
    assert _run(_mk(pair[1], async_depth=2), prompts) == base
    assert calls                                  # the pipeline ran
    monkeypatch.setenv("PT_ASYNC_DECODE", "0")
    calls.clear()
    before = sum(_drains().values())
    eng = _mk(pair[1], async_depth=2)
    assert eng.async_depth == 0
    assert _run(eng, prompts) == base
    assert not calls                              # the synchronous tick only
    assert sum(_drains().values()) == before      # no window ever formed


def test_async_depth_validation(pair):
    with pytest.raises(ValueError, match="async_depth"):
        _mk(pair[1], async_depth=-1)


def test_async_overrun_arithmetic_exact(pair):
    """Cancel fired from a stream callback mid-cruise: the ticks already
    dispatched keep computing the dead slot — exactly ``depth`` rows
    count as overrun, and the streams equal the synchronous engine's
    under the same callback."""
    rs = np.random.RandomState(8)
    pa, pb = rs.randint(2, 64, (4,)), rs.randint(2, 64, (5,))
    depth = 3

    def run(d):
        eng = _mk(pair[1], num_slots=2, block_size=16, max_seq_len=64,
                  async_depth=d)
        state = {}

        def cb(req, tok):
            if len(req.tokens) == 3:
                eng.cancel(state["rb"], reason="cancelled")

        eng.add_request(Request(pa, max_new_tokens=8, stream=cb))
        state["rb"] = eng.add_request(Request(pb, max_new_tokens=8))
        eng.run()
        eng.assert_quiescent()
        assert eng.requests[state["rb"]].finish_reason == "cancelled"
        return ({r: list(map(int, q.tokens))
                 for r, q in eng.requests.items()},
                eng.stats["async_overrun"])

    base, over0 = run(0)
    got, over = run(depth)
    assert got == base
    assert over0 == 0 and over == depth


def test_drain_reasons_growth_and_window(pair):
    """``growth``: a slot about to cross a block boundary within the
    window drains it, and the synchronous tick grows the table. ``window``:
    a sliding-window model recycles blocks every tick, so its ticks never
    cruise; its streams stay the synchronous engine's."""
    prompts = _prompts(np.random.RandomState(3), n=3)
    kw = dict(num_slots=3, block_size=4)
    base = _run(_mk(pair[1], **kw), prompts, new=14)
    assert _run(_mk(pair[1], async_depth=2, **kw), prompts, new=14) == base
    assert _drains().get("growth", 0) > 0

    cfg = MistralConfig.tiny(sliding_window=8, vocab_size=64)
    model = MistralForCausalLM(cfg, device="cpu")
    win_base = _run(_mk(model, **kw), prompts, new=14)
    eng = _mk(model, async_depth=2, **kw)
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=14))
    reasons = set()
    while eng.has_work():
        reasons.add(eng._async_block_reason())
        eng.step()
    eng.assert_quiescent()
    assert "window" in reasons and None not in reasons
    assert {r: list(map(int, q.tokens))
            for r, q in eng.requests.items()} == win_base


def test_cancel_between_steps_drains_the_window(pair):
    """``cancel`` mid-window lands the ticks in flight first: the cancelled
    request keeps exactly the tokens the synchronous engine had given it
    after the same steps, and the other request's stream is unchanged."""
    rs = np.random.RandomState(12)
    pa, pb = rs.randint(2, 64, (6,)), rs.randint(2, 64, (7,))

    def run(depth):
        eng = _mk(pair[1], num_slots=2, block_size=16, max_seq_len=64,
                  async_depth=depth)
        ra = eng.add_request(Request(pa, max_new_tokens=12))
        rb = eng.add_request(Request(pb, max_new_tokens=12))
        for _ in range(6):
            eng.step()
        if depth:
            assert eng._async_win                # ticks are in flight
        assert eng.cancel(rb)
        eng.run()
        eng.assert_quiescent()
        return [list(map(int, eng.requests[r].tokens)) for r in (ra, rb)]

    base = run(0)
    assert len(base[1]) < 12
    for depth in (1, 2, 3):
        assert run(depth) == base, depth
    assert _drains().get("cancel", 0) > 0


@pytest.mark.chaos
def test_induced_preemption_mid_window_drains_first(pair):
    """A preemption induced while ticks are in flight (two requests in two
    slots, so the pipeline cruises) lands them first (why=boundary): the
    victim's resume prompt holds every token it was given, and the
    streams are the synchronous engine's."""
    prompts = _prompts(np.random.RandomState(21), n=2)

    def run(depth):
        FAULTS.clear()
        FAULTS.install("serving.preempt", on={6, 13}, times=2,
                       action=lambda ctx: ctx["engine"]._preempt())
        eng = _mk(pair[1], num_slots=2, block_size=16, max_seq_len=64,
                  preemption=True, async_depth=depth)
        out = _run(eng, prompts, new=16)
        FAULTS.clear()
        assert eng.stats["preemptions"] == 2
        return out

    base = run(0)
    for depth in (1, 2, 3):
        assert run(depth) == base, depth
    assert _drains().get("boundary", 0) > 0
