"""MoE serving through the port's ``LLMEngine`` against
``paddle_tpu.serving.LLMEngine``.

Mixtral-tiny and Qwen2-MoE-tiny (fp32, the same weights), the prompts and
engine geometry of ``tests/test_serving_moe.py``: the greedy streams must be
identical token for token, with whole-prompt and with chunked prefill, and
with the dense capacity path behind ``PT_GROUPED_GEMM=0``. The
``serving.moe_dispatch`` fault site aborts one tick atomically and the
streams equal a clean run; a dense Llama never fires it.
"""
import numpy as np
import pytest

from paddle_tpu.models.paged import is_moe_model as j_is_moe_model
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models import paged as P
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import moe_pair, tiny_pair

EKW = dict(num_slots=4, block_size=8, max_prompt_len=16, max_seq_len=48)


def _prompts(vocab, n=3, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (int(l),))
            for l in rs.randint(3, 12, size=n)]


def _run(engine_cls, req_cls, model, prompts, max_new=10, **kw):
    eng = engine_cls(model, **{**EKW, **kw})
    ids = [eng.add_request(req_cls(p, max_new_tokens=max_new))
           for p in prompts]
    eng.run()
    eng.assert_quiescent()
    return [list(map(int, eng.requests[i].tokens)) for i in ids]


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_greedy_streams_match_reference(family):
    jm, tm, vocab = moe_pair(family)
    prompts = _prompts(vocab, n=5)             # more requests than slots
    want = _run(JEngine, JRequest, jm, prompts)
    got = _run(LLMEngine, Request, tm, prompts)
    assert got == want
    assert all(len(t) == 10 for t in got)


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_chunked_prefill_streams_match_reference(family):
    """Prompts longer than ``max_prompt_len`` stream in through the chunked
    prefill, MoE layers included."""
    jm, tm, vocab = moe_pair(family)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, vocab, n) for n in (21, 7, 30)]
    want = _run(JEngine, JRequest, jm, prompts, max_new=8)
    got = _run(LLMEngine, Request, tm, prompts, max_new=8)
    assert got == want


def test_dense_capacity_path_gives_the_same_streams(monkeypatch):
    _, tm, vocab = moe_pair("mixtral")
    prompts = _prompts(vocab, n=4)
    on = _run(LLMEngine, Request, tm, prompts)
    monkeypatch.setenv("PT_GROUPED_GEMM", "0")
    assert _run(LLMEngine, Request, tm, prompts) == on


def test_moe_model_detection():
    for family in ("mixtral", "qwen2_moe", "moe_llm"):
        jm, tm, _ = moe_pair(family)
        assert P.is_moe_model(tm) and j_is_moe_model(jm)
    jm, tm = tiny_pair()
    assert not P.is_moe_model(tm) and not j_is_moe_model(jm)
    assert P.moe_prefill_paged is P.llama_prefill_paged
    assert P.moe_decode_step_paged is P.llama_decode_step_paged
    assert P.moe_decode_tick is P.llama_decode_tick


def test_moe_llm_is_served_with_its_base_config():
    """``MoEForCausalLM`` keeps the Llama fields in ``cfg.base``; the
    engine reads them there. Its capacity factor drops routing choices, so
    a padded batch is not held to the reference here: every request
    finishes and the engine ends quiescent."""
    _, tm, vocab = moe_pair("moe_llm")
    out = _run(LLMEngine, Request, tm, _prompts(vocab, n=3), max_new=6)
    assert all(len(t) == 6 and all(0 <= x < vocab for x in t) for t in out)


def test_moe_dispatch_fault_aborts_the_tick_atomically():
    _, tm, vocab = moe_pair("mixtral")
    prompts = _prompts(vocab)
    clean = _run(LLMEngine, Request, tm, prompts, max_new=8)
    eng = LLMEngine(tm, **EKW)
    ids = [eng.add_request(Request(p, max_new_tokens=8)) for p in prompts]
    fired = 0
    try:
        with FAULTS.scope("serving.moe_dispatch", on={1}, exc=InjectedFault):
            while eng.has_work():
                try:
                    eng.step()
                except InjectedFault:
                    fired += 1
    finally:
        FAULTS.clear()
    assert fired == 1
    assert [list(map(int, eng.requests[i].tokens)) for i in ids] == clean
    eng.assert_quiescent()


def test_moe_dispatch_site_never_fires_for_a_dense_model():
    _, tm = tiny_pair()
    eng = LLMEngine(tm, **EKW)
    eng.add_request(Request(np.array([1, 2, 3]), max_new_tokens=4))
    try:
        with FAULTS.scope("serving.moe_dispatch", exc=InjectedFault):
            eng.run()
        eng.assert_quiescent()
        assert FAULTS.hits["serving.moe_dispatch"] == 0
    finally:
        FAULTS.clear()
