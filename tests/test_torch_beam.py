"""Beam search and cached generation of the port against the JAX package.

Same weights (``models/convert.py`` ``load_jax_state_dict``), same
inputs made with numpy from a seed, fp32 on the CPU, so every kernel
wrapper runs its plain version:

* ``models.decoding.generate`` equals the reference's token for token —
  greedy, EOS finishing, the repetition penalty and ``min_new_tokens``;
* ``beam_search`` equals the reference's in tokens, with scores within
  1e-5 relative; ``num_beams=1`` is greedy;
* ``models.paged.paged_beam_search`` equals the reference's and the
  port's own dense-cache beam search;
* the serving engine's beam groups equal the reference engine's on the
  specs of ``tests/test_serving_beam.py``: a lone beam request, beams
  riding with greedy traffic under oversubscription (over a pool of the
  model's type and over an int8 pool), preemption of the greedy rows
  around a group, shared prompt blocks, cancel and drain, the async
  engine's cruise blocked while a group lives, and validation.

Tolerance: tokens exactly; beam scores within 1e-5 relative (fp32 sums
of log-probs whose per-op order differs between XLA and ATen).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models import decoding as JD
from paddle_tpu.models.paged import paged_beam_search as j_paged_beam
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu_torch.models import decoding as TD
from paddle_tpu_torch.models.paged import paged_beam_search
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving.grammar import TokenMaskAutomaton
from tests.test_torch_common import tiny_pair
from tests._torch_threads import one_torch_thread  # noqa: F401

SCORE_REL = 1e-5
TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
ENG = dict(num_slots=3, block_size=4, max_prompt_len=16, max_seq_len=24,
           eos_token_id=1)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def wide():
    """The default tiny Llama (vocab 256, hidden 64) for the dense API."""
    return tiny_pair()


@pytest.fixture(autouse=True)
def _port_metrics():
    METRICS.reset()
    yield
    METRICS.reset()


# ------------------------------------------------------------ dense cache
@pytest.mark.parametrize("kw", [
    dict(),
    dict(eos_token_id=30),
    dict(repetition_penalty=1.3),
    dict(eos_token_id=5, min_new_tokens=3, repetition_penalty=1.2),
], ids=["greedy", "eos", "penalty", "eos_min_new_penalty"])
def test_generate_matches_reference(wide, kw):
    jm, tm = wide
    ids = np.random.RandomState(0).randint(0, 256, (3, 7))
    want = np.asarray(JD.generate(jm, ids, max_new_tokens=9, **kw))
    got = TD.generate(tm, ids, max_new_tokens=9, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_generate_stops_rows_at_eos(wide):
    """A row that emits EOS repeats it; min_new_tokens masks EOS first."""
    _, tm = wide
    ids = np.random.RandomState(1).randint(0, 256, (2, 5))
    first = int(TD.generate(tm, ids, max_new_tokens=1).numpy()[0, 5])
    out = TD.generate(tm, ids, max_new_tokens=6, eos_token_id=first).numpy()
    assert (out[0, 5:] == first).all()
    late = TD.generate(tm, ids, max_new_tokens=6, eos_token_id=first,
                       min_new_tokens=3).numpy()
    assert (late[0, 5:8] != first).all()


@pytest.mark.parametrize("beams,eos,lp", [
    (3, None, 1.0), (4, 30, 1.0), (2, None, 0.6), (4, 7, 1.5),
], ids=["k3", "k4_eos", "k2_lp0.6", "k4_eos_lp1.5"])
def test_beam_search_matches_reference(wide, beams, eos, lp):
    jm, tm = wide
    ids = np.random.RandomState(2).randint(0, 256, (2, 6))
    want, w_score = JD.beam_search(jm, ids, max_new_tokens=7,
                                   num_beams=beams, length_penalty=lp,
                                   eos_token_id=eos)
    got, g_score = TD.beam_search(tm, ids, max_new_tokens=7,
                                  num_beams=beams, length_penalty=lp,
                                  eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(g_score.numpy(), np.asarray(w_score),
                               rtol=SCORE_REL)


def test_one_beam_is_greedy(wide):
    _, tm = wide
    ids = np.random.RandomState(3).randint(0, 256, (2, 5))
    seq, _ = TD.beam_search(tm, ids, max_new_tokens=6, num_beams=1)
    np.testing.assert_array_equal(
        seq.numpy(), TD.generate(tm, ids, max_new_tokens=6).numpy())


def test_beam_select_keeps_lax_top_k_tie_order():
    """Ties between candidates resolve to the lower index, as lax.top_k
    does: the first select from one live beam picks K distinct tokens of
    beam 0 even though the dead beams tie at -1e9."""
    v, k = 8, 3
    logp = torch.log_softmax(torch.arange(v, dtype=torch.float32),
                             -1)[None, None].expand(1, k, v)
    run, seqs, fin, fs, _ = TD.beam_init(torch.zeros(1, v),
                                         torch.zeros(1, 2, dtype=torch.int64),
                                         k, 3)
    out = TD.beam_select(run, seqs, fin, fs, logp, 0, 2, None, 1.0)
    assert out[4].tolist() == [[0, 0, 0]]
    assert out[5].tolist() == [[7, 6, 5]]


# ------------------------------------------------------------ paged beams
@pytest.mark.parametrize("eos,bs", [(None, 4), (30, 4), (None, 16)],
                         ids=["bs4", "bs4_eos", "bs16"])
def test_paged_beam_search_matches_reference(wide, eos, bs):
    jm, tm = wide
    prompt = np.random.RandomState(4).randint(0, 256, (9,))
    want, w_score = j_paged_beam(jm, prompt, max_new_tokens=7, num_beams=4,
                                 eos_token_id=eos, block_size=bs,
                                 num_blocks=16)
    got, g_score = paged_beam_search(tm, prompt, max_new_tokens=7,
                                     num_beams=4, eos_token_id=eos,
                                     block_size=bs, num_blocks=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(g_score), float(w_score),
                               rtol=SCORE_REL)
    # the paged beam equals the port's dense-cache beam search
    dense, d_score = TD.beam_search(tm, prompt[None], max_new_tokens=7,
                                    num_beams=4, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), dense.numpy()[0])
    np.testing.assert_allclose(float(g_score), float(d_score[0]),
                               rtol=SCORE_REL)


# ---------------------------------------------------------------- engine
def _serve(cls, req_cls, model, reqs, **kw):
    eng = cls(model, **{**ENG, **kw})
    ids = [eng.add_request(req_cls(p, **rk)) for p, rk in reqs]
    eng.run()
    eng.assert_quiescent()
    assert eng.mgr.free_blocks == eng.mgr.num_blocks
    return ([list(map(int, eng.requests[i].tokens)) for i in ids],
            [eng.requests[i].beam_score for i in ids],
            [eng.requests[i].finish_reason for i in ids], eng)


def _match(pair, reqs, **kw):
    jm, tm = pair
    want = _serve(JEngine, JRequest, jm, reqs, **kw)
    got = _serve(LLMEngine, Request, tm, reqs, **kw)
    assert got[0] == want[0]
    assert got[2] == want[2]
    for g, w in zip(got[1], want[1]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, rtol=SCORE_REL)
    return got


def test_engine_lone_beam_matches_reference_and_paged_beam(pair):
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, 64, (7,))
    toks, scores, reasons, _ = _match(
        pair, [(prompt, dict(max_new_tokens=6, num_beams=3))], num_slots=4)
    assert reasons == ["beam"]
    seq, score = paged_beam_search(pair[1], prompt, max_new_tokens=6,
                                   num_beams=3, eos_token_id=1,
                                   block_size=4)
    assert toks[0] == seq.numpy()[len(prompt):].tolist()
    np.testing.assert_allclose(scores[0], float(score), rtol=SCORE_REL)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_beams_ride_with_greedy_traffic(pair, kv_dtype):
    """A beam request between greedy ones, in 3 slots for 6 requests
    (oversubscribed): every stream equals the reference engine's, over a
    pool of the model's type and over an int8 pool."""
    rs = np.random.RandomState(4)
    g = [rs.randint(0, 64, (int(n),)) for n in rs.randint(3, 12, size=5)]
    b = rs.randint(0, 64, (6,))
    reqs = ([(p, dict(max_new_tokens=5)) for p in g[:2]]
            + [(b, dict(max_new_tokens=5, num_beams=2))]
            + [(p, dict(max_new_tokens=5)) for p in g[2:]])
    toks, _, reasons, eng = _match(pair, reqs, kv_dtype=kv_dtype)
    assert reasons[2] == "beam" and len(toks[2]) == 5
    assert bool(eng.cache.k_scale_store) == (kv_dtype == "int8")


def test_engine_two_groups_and_preemption_match_reference(pair):
    """Two beam groups and greedy rows on a tight pool with preemption:
    greedy rows are preempted around the groups (never a beam slot) and
    every stream still equals the reference engine's."""
    rs = np.random.RandomState(6)
    reqs = [(rs.randint(0, 64, (9,)), dict(max_new_tokens=6, num_beams=2)),
            (rs.randint(0, 64, (5,)), dict(max_new_tokens=8)),
            (rs.randint(0, 64, (11,)), dict(max_new_tokens=7)),
            (rs.randint(0, 64, (6,)), dict(max_new_tokens=5, num_beams=3)),
            (rs.randint(0, 64, (4,)), dict(max_new_tokens=8))]
    kw = dict(num_slots=4, num_blocks=24, preemption=True)
    _match(pair, reqs, **kw)


def test_engine_beam_blocks_shared_not_duplicated(pair):
    _, tm = pair
    prompt = np.random.RandomState(5).randint(0, 64, (12,))
    eng = LLMEngine(tm, **{**ENG, "num_slots": 4, "max_seq_len": 32})
    rid = eng.add_request(Request(prompt, max_new_tokens=8, num_beams=4))
    eng.step()                            # prefill + first select
    g = eng.groups[rid]
    live = eng._group_live_blocks(g)
    assert live < 4 * eng.mgr.blocks_needed(len(prompt) + 1)
    assert live <= eng.mgr.blocks_needed(len(prompt)) + 2 * 4
    assert eng.is_beam.sum() == 4
    eng.run()
    eng.assert_quiescent()


def test_engine_beam_cancel_and_drain(pair):
    _, tm = pair
    rs = np.random.RandomState(8)
    eng = LLMEngine(tm, **{**ENG, "num_slots": 4})
    b = eng.add_request(Request(rs.randint(0, 64, (6,)), max_new_tokens=8,
                                num_beams=3))
    g = eng.add_request(Request(rs.randint(0, 64, (5,)), max_new_tokens=8))
    eng.step()
    eng.step()
    assert b in eng.groups
    assert eng.cancel(b)
    assert eng.requests[b].finish_reason == "cancelled"
    assert not eng.is_beam.any() and b not in eng.groups
    out = eng.drain()
    assert len(out[g]) >= 1
    eng.assert_quiescent()


def test_async_engine_blocks_cruise_for_beams(pair):
    """async_depth=2 with a beam group admitted mid-cruise: the window
    drains before the admission, no tick cruises while the group lives
    (block reason ``beam``), and every stream equals the synchronous
    engine's."""
    _, tm = pair
    rs = np.random.RandomState(9)
    reqs = [(rs.randint(0, 64, (5,)), dict(max_new_tokens=12)),
            (rs.randint(0, 64, (7,)), dict(max_new_tokens=12)),
            (rs.randint(0, 64, (6,)), dict(max_new_tokens=5, num_beams=2))]

    def run(depth):
        eng = LLMEngine(tm, **{**ENG, "num_slots": 4, "async_depth": depth})
        ids = [eng.add_request(Request(p, **k)) for p, k in reqs[:2]]
        for _ in range(4):
            eng.step()
        ids.append(eng.add_request(Request(reqs[2][0], **reqs[2][1])))
        reasons = set()
        while eng.has_work():
            if depth:
                reasons.add(eng._async_block_reason())
            eng.step()
        eng.assert_quiescent()
        return [eng.requests[i].tokens for i in ids], reasons

    want, _ = run(0)
    got, reasons = run(2)
    assert got == want
    assert "beam" in reasons and None in reasons


def test_engine_beam_validation(pair):
    _, tm = pair
    eng = LLMEngine(tm, **{**ENG, "num_slots": 2})
    with pytest.raises(ValueError, match="num_beams"):
        eng.add_request(Request([1, 2], num_beams=0))
    with pytest.raises(ValueError, match="exceeds num_slots"):
        eng.add_request(Request([1, 2], num_beams=3))
    with pytest.raises(ValueError, match="streaming"):
        eng.add_request(Request([1, 2], num_beams=2,
                                stream=lambda r, t: None))
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng.add_request(Request(np.arange(20) % 64, num_beams=2,
                                max_new_tokens=2))
    aut = TokenMaskAutomaton("[ab]*", vocab=[chr(97 + i % 26)
                                             for i in range(64)])
    with pytest.raises(NotImplementedError, match="beam"):
        eng.add_request(Request([1, 2], num_beams=2, grammar=aut,
                                max_new_tokens=2))
    wm = tiny_pair(**TINY, sliding_window=8)[1]
    weng = LLMEngine(wm, **{**ENG, "num_slots": 4})
    with pytest.raises(NotImplementedError, match="sliding-window"):
        weng.add_request(Request([1, 2], num_beams=2, max_new_tokens=2))
