"""The port's ``LLMEngine`` against ``paddle_tpu.serving.LLMEngine``.

Same weights, same request mix, greedy: the token streams must be
identical, token for token (fp32 tiny, with and without GQA). The mixes
mirror the reference's own engine tests: more requests than slots
(test_serving_engine), prompts longer than ``max_prompt_len``
(test_chunked_prefill), shared prefixes served from the radix trie
including a partial copy-on-write boundary block (test_serving_prefix),
and a pool too small for the mix under ``preemption=True``
(test_serving_preempt_fix). Both engines must end quiescent.
"""
import numpy as np
import pytest

from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.serving import LLMEngine, Request
from tests.test_torch_common import tiny_pair
from tests._torch_threads import one_torch_thread  # noqa: F401


def _mix(seed):
    rs = np.random.RandomState(seed)
    short = [rs.randint(0, 256, n) for n in (5, 8, 3)]
    long = [rs.randint(0, 256, n) for n in (14, 21)]
    # radix hits: a partial-block share of a short prompt (COW boundary)
    # and a multi-block share of a long one
    hits = [np.concatenate([short[1][:6], rs.randint(0, 256, 4)]),
            np.concatenate([long[1][:13], rs.randint(0, 256, 3)])]
    return short + long + hits


def _serve(engine_cls, req_cls, model, prompts, **kw):
    eng = engine_cls(model, **kw)
    ids = [eng.add_request(req_cls(p, max_new_tokens=6)) for p in prompts]
    eng.run()
    eng.assert_quiescent()
    return [list(map(int, eng.requests[i].tokens)) for i in ids], eng


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_greedy_streams_match_reference(nkv):
    jm, tm = tiny_pair(num_key_value_heads=nkv)
    prompts = _mix(0)
    kw = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=40)
    want, jeng = _serve(JEngine, JRequest, jm, prompts, **kw)
    got, teng = _serve(LLMEngine, Request, tm, prompts, **kw)
    assert got == want
    assert all(len(t) == 6 for t in got)
    # the mix really exercised the radix trie, partial COW included
    assert teng.mgr.cache_stats["token_hits"] > 0
    assert teng.mgr.cache_stats["partial_hits"] > 0
    assert teng.mgr.cache_stats == jeng.mgr.cache_stats


def test_preemption_tight_pool_matches_reference():
    jm, tm = tiny_pair()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, n) for n in (12, 17, 9, 20)]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=32,
              num_blocks=12, preemption=True)
    want, jeng = _serve(JEngine, JRequest, jm, prompts, **kw)
    got, teng = _serve(LLMEngine, Request, tm, prompts, **kw)
    assert jeng.stats["preemptions"] >= 1
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    assert got == want


def test_eos_cancel_drain_and_refusals():
    _, tm = tiny_pair()
    rs = np.random.RandomState(7)
    eng = LLMEngine(tm, num_slots=2, block_size=4, max_prompt_len=8,
                    max_seq_len=32)
    a = eng.add_request(Request(rs.randint(0, 256, 6), max_new_tokens=20))
    b = eng.add_request(Request(rs.randint(0, 256, 6), max_new_tokens=20))
    c = eng.add_request(Request(rs.randint(0, 256, 6), max_new_tokens=20))
    eng.step()
    assert eng.cancel(a) and eng.cancel(c)      # decoding / still queued
    assert not eng.cancel(a)
    first = eng.requests[b].tokens[0]
    out = eng.drain()
    assert eng.requests[a].finish_reason == "cancelled"
    assert eng.requests[c].finish_reason == "cancelled"
    assert len(out[b]) == 20
    eng.assert_quiescent()
    # EOS stops a request at its first EOS token
    eng2 = LLMEngine(tm, num_slots=2, block_size=4, max_prompt_len=8,
                     max_seq_len=32, eos_token_id=first)
    r = eng2.add_request(Request(eng.requests[b].prompt, max_new_tokens=20))
    eng2.run()
    assert eng2.requests[r].tokens == [first]
    assert eng2.requests[r].finish_reason == "eos"
    eng2.assert_quiescent()
    # tenants are served; a prefill-only replica stops after prefill and
    # its sequence is extractable; context parallelism is still refused
    # by name
    rt = eng2.add_request(Request([1, 2], max_new_tokens=3, tenant_id="t0"))
    eng2.run()
    assert len(eng2.requests[rt].tokens) <= 3
    eng2.assert_quiescent()
    pre = LLMEngine(tm, num_slots=2, block_size=4, max_prompt_len=8,
                    max_seq_len=32, prefill_only=True)
    rp = pre.add_request(Request(eng.requests[b].prompt, max_new_tokens=20))
    pre.step()
    pre.step()
    assert pre.requests[rp].tokens == eng.requests[b].tokens[:1]
    assert pre.stats["ticks"] == 0 and pre.active.any()
    payload = pre.extract_sequence(rp)
    assert payload.gen == 1 and payload.cur == len(eng.requests[b].prompt)
    assert not pre.has_work()
    pre.assert_quiescent()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LLMEngine(tm, cp=2)


def test_sampled_streams_are_seeded_and_mixed_with_greedy():
    """Temperature/top-p rows draw from the engine's seeded generator:
    the same seed replays the same streams, another seed does not, and
    a greedy row in the same batch keeps its greedy stream."""
    _, tm = tiny_pair()
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 256, n) for n in (6, 11, 4)]

    def serve(seed):
        eng = LLMEngine(tm, num_slots=3, block_size=4, max_prompt_len=8,
                        max_seq_len=40, seed=seed)
        ids = [eng.add_request(Request(p, max_new_tokens=12,
                                       temperature=t, top_p=tp))
               for p, t, tp in zip(prompts, (1.0, 0.0, 0.8),
                                   (0.9, 1.0, 1.0))]
        eng.run()
        eng.assert_quiescent()
        return [eng.requests[i].tokens for i in ids]

    a, b, c = serve(0), serve(0), serve(1)
    assert a == b
    assert a != c
    assert a[1] == c[1]                       # the greedy row
    assert all(0 <= t < 256 for s in a for t in s)
