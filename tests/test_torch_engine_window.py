"""The port's ``LLMEngine`` serving sliding-window and dynamic-NTK models,
against ``paddle_tpu.serving.LLMEngine``.

Same weights, same requests, greedy, fp32 tiny: the token streams must be
identical, token for token. The configurations are the reference's own:
the window-recycling engine of ``tests/test_serving_engine.py``
(``test_engine_sliding_window_recycles_blocks``: live blocks per sequence
stay O(window)), the windowed growth of
``tests/test_serving_preempt_fix.py`` (``test_windowed_growth_preemption_
no_storm``: a long table of recycled placeholders must not preempt), and a
dynamic-NTK model decoding past its trained window, with and without a
preemption (the resume's rope bases follow the resume prompt's length on
both sides). Both engines turn prefix caching off and refuse chunked
prefill for these models.
"""
import numpy as np
import pytest

from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.serving import LLMEngine, Request
from tests.test_torch_common import tiny_pair

# test_serving_engine.py::test_engine_sliding_window_recycles_blocks
WINDOW_CFG = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=64, sliding_window=6)
# weights 15x the default scale, so that a rope base that grows past the
# trained window of 8 changes greedy tokens (at 0.02 it changes none)
DYN_CFG = dict(max_position_embeddings=8, initializer_range=0.3,
               rope_scaling={"type": "dynamic", "factor": 2.0})


def _serve(engine_cls, req_cls, model, prompts, new, **kw):
    """Run the mix; returns (streams, engine, peak live blocks of any
    sequence after any tick)."""
    eng = engine_cls(model, **kw)
    ids = [eng.add_request(req_cls(p, max_new_tokens=new)) for p in prompts]
    peak = 0
    while eng.has_work():
        eng.step()
        for s in range(eng.num_slots):
            if eng.slot_req[s] >= 0:
                peak = max(peak, eng.kv.live_blocks(int(eng.slot_req[s])))
    eng.assert_quiescent()
    return [list(map(int, eng.requests[i].tokens)) for i in ids], eng, peak


def test_window_recycling_streams_match_reference():
    jm, tm = tiny_pair(**WINDOW_CFG)
    rs = np.random.RandomState(9)
    prompts = [rs.randint(0, 64, (n,)) for n in (10, 4)]
    kw = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=32)
    want, jeng, jpeak = _serve(JEngine, JRequest, jm, prompts, 16, **kw)
    got, teng, peak = _serve(LLMEngine, Request, tm, prompts, 16, **kw)
    assert got == want
    assert all(len(t) == 16 for t in got)
    # window 6 at block size 4: the live span is at most window + 2 * bs
    # tokens = 4 blocks; without recycling row 0 would hold ceil(26 / 4) = 7
    assert peak <= 4 and peak == jpeak
    assert not teng.prefix_caching and not jeng.prefix_caching


def test_windowed_growth_does_not_preempt_and_matches_reference():
    jm, tm = tiny_pair(**{**WINDOW_CFG, "sliding_window": 8})
    p = np.random.RandomState(13).randint(0, 64, (6,))
    kw = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=64,
              num_blocks=6, preemption=True)
    want, jeng, _ = _serve(JEngine, JRequest, jm, [p], 40, **kw)
    got, teng, peak = _serve(LLMEngine, Request, tm, [p], 40, **kw)
    assert teng.stats["preemptions"] == 0 == jeng.stats["preemptions"]
    assert len(got[0]) == 40 and got == want
    assert peak <= 4          # 6 + 40 tokens would need 12 blocks


@pytest.mark.parametrize("lens,max_prompt,num_blocks", [
    ((15, 12, 3, 9), 16, 11), ((22, 20, 9, 13), 24, 10)],
    ids=["recycle", "relaxed_reservation"])
def test_window_recycling_under_pool_pressure_matches_reference(
        lens, max_prompt, num_blocks):
    """Four windowed requests into a pool too small for their unrecycled
    worst cases: admissions, streams and tick counts as the reference's.
    ``recycle``: the pool fits them only because the long prompts' dead
    blocks are recycled. ``relaxed_reservation``: prompts longer than the
    window's live bound (window + 2 blocks) reserve that bound, not their
    prompt's blocks, once prefill has recycled; without the relaxation
    the fourth request waits for a slot's whole stream (57 ticks, not
    39)."""
    jm, tm = tiny_pair(**WINDOW_CFG)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 64, (n,)) for n in lens]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=max_prompt,
              max_seq_len=48, num_blocks=num_blocks)
    want, jeng, jpeak = _serve(JEngine, JRequest, jm, prompts, 20, **kw)
    got, teng, peak = _serve(LLMEngine, Request, tm, prompts, 20, **kw)
    assert got == want and peak == jpeak <= 4
    assert teng.stats["ticks"] == jeng.stats["ticks"]


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_dynamic_ntk_streams_match_reference(nkv):
    """Trained window 8, factor 2: every prompt and every decode step past
    position 8 rotates with a grown base, per row."""
    jm, tm = tiny_pair(num_key_value_heads=nkv, **DYN_CFG)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 12, 7)]
    kw = dict(num_slots=2, block_size=4, max_prompt_len=16, max_seq_len=40)
    want, jeng, _ = _serve(JEngine, JRequest, jm, prompts, 14, **kw)
    got, teng, _ = _serve(LLMEngine, Request, tm, prompts, 14, **kw)
    assert got == want
    assert not teng.prefix_caching and not jeng.prefix_caching
    # the scaling bites: the same weights under plain rope decode otherwise
    _, fixed = tiny_pair(num_key_value_heads=nkv,
                         initializer_range=DYN_CFG["initializer_range"])
    assert _serve(LLMEngine, Request, fixed, prompts, 14, **kw)[0] != got


def test_dynamic_ntk_preempted_resume_matches_reference():
    """A tight pool under preemption: the victim resumes from prompt +
    tokens so far, one plain prefill whose bases follow that length, as
    in the reference."""
    jm, tm = tiny_pair(**DYN_CFG)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, (n,)) for n in (6, 9, 4)]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=24, max_seq_len=24,
              num_blocks=9, preemption=True)
    want, jeng, _ = _serve(JEngine, JRequest, jm, prompts, 12, **kw)
    got, teng, _ = _serve(LLMEngine, Request, tm, prompts, 12, **kw)
    assert jeng.stats["preemptions"] >= 1
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    assert got == want


@pytest.mark.parametrize("cfg,vocab", [(WINDOW_CFG, 64), (DYN_CFG, 256)],
                         ids=["window", "ntk"])
def test_long_resume_is_not_preemptible_like_the_reference(cfg, vocab):
    """A resume (prompt + tokens so far) longer than ``max_prompt_len``
    would need the chunk path, which these models refuse: such a slot is
    no preemption victim. Both engines end alike on a tight pool: the
    windowed model (window 6 recycles its blocks) finishes with the same
    streams, the dynamic-NTK one cannot grow its last slot and raises the
    reference's MemoryError instead of wedging a chunked resume."""
    jm, tm = tiny_pair(**cfg)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, vocab, (n,)) for n in (3, 7, 5)]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=24,
              num_blocks=6, preemption=True)
    ends = []
    for eng_cls, req_cls, m in ((JEngine, JRequest, jm),
                                (LLMEngine, Request, tm)):
        try:
            got, eng, _ = _serve(eng_cls, req_cls, m, prompts, 12, **kw)
            ends.append((got, eng.stats["preemptions"]))
        except MemoryError as e:
            ends.append(("MemoryError", "not preemptible" in str(e)))
    assert ends[0] == ends[1]
    if cfg is DYN_CFG:
        assert ends[1] == ("MemoryError", True)


@pytest.mark.parametrize("cfg", [WINDOW_CFG, DYN_CFG], ids=["window", "ntk"])
def test_chunked_prefill_refused_like_the_reference(cfg):
    jm, tm = tiny_pair(**cfg)
    long = np.arange(20) % 64
    kw = dict(num_slots=2, block_size=4, max_prompt_len=8, max_seq_len=40)
    for eng_cls, req_cls, m in ((JEngine, JRequest, jm),
                                (LLMEngine, Request, tm)):
        eng = eng_cls(m, **kw)
        with pytest.raises(NotImplementedError, match="chunked prefill"):
            eng.add_request(req_cls(long, max_new_tokens=4))
        eng.add_request(req_cls(long[:8], max_new_tokens=4))   # fits: served
        eng.run()
        eng.assert_quiescent()
