"""Grammar-constrained decoding of the port against the JAX package.

* ``serving.grammar`` is a copy of the reference's: on the patterns of
  ``tests/test_grammar.py`` (and two JSON schemas) both automata reach
  the same states, with the same masks, biases and ``advance`` results;
* the engine's greedy grammar streams equal the reference engine's token
  for token — alone, mixed with free rows (whose streams are those of a
  run with no grammar row), under speculative decoding (equal to the
  non-speculative stream too), through chunked prefill and through
  preemption (the mask state replays the emitted tokens);
* sampled grammar rows are checked on what the draw is made from: the
  filtered, biased logits of ``_sample_rows`` equal the reference's (as
  ``tests/test_torch_sampling.py`` does), and every sampled token is
  mask-legal;
* the async engine never cruises with a grammar row; validation.

Same weights, fp32, CPU (every kernel wrapper runs its plain version).
Tolerance: tokens and masks exactly; filtered logits within 1e-6
relative.
"""
import re
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import decoding as JD
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import grammar as JG
from paddle_tpu_torch.models.decoding import filter_rows
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import grammar as TG
from paddle_tpu_torch.serving.telemetry import _GRAMMAR_SPEC_REJECTS
from tests.test_torch_common import tiny_pair

# 63 single-char tokens + one empty-string EOS token = vocab_size 64
CHARS = (string.digits + string.ascii_lowercase
         + string.ascii_uppercase[:19] + '{}":,-._')
VOCAB = list(CHARS) + [""]
EOS = 63
TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
ENG = dict(num_slots=3, block_size=4, max_prompt_len=16, max_seq_len=24,
           eos_token_id=EOS)
PATTERNS = ["ab|ac", "a(b|c)*d", "[a-c]{2,3}", "a?b+c*", "\\d+",
            "-?\\d+(\\.\\d+)?", "[^ab]c", "(ab){2}", "a{2,}b", "[ab]{3}",
            "(ab|ba){4}", "a~"]
SCHEMAS = [{"type": "object",
            "properties": {"a": {"type": "integer"},
                           "b": {"enum": ["x", "y"]},
                           "ok": {"type": "boolean"}}},
           {"type": "number"}]


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(autouse=True)
def _port_metrics():
    METRICS.reset()
    yield
    METRICS.reset()


def _auts(pattern=None, schema=None):
    kw = dict(vocab=VOCAB, eos_token_id=EOS)
    if schema is not None:
        return (JG.TokenMaskAutomaton(json_schema=schema, **kw),
                TG.TokenMaskAutomaton(json_schema=schema, **kw))
    return (JG.TokenMaskAutomaton(pattern, **kw),
            TG.TokenMaskAutomaton(pattern, **kw))


# ------------------------------------------------------------- automaton
@pytest.mark.parametrize("spec", PATTERNS + [f"schema{i}" for i in
                                             range(len(SCHEMAS))])
def test_automaton_matches_reference(spec):
    """Breadth-first over the states both automata reach (up to 40): the
    masks, biases, accepting flags and every legal token's destination
    agree, and an illegal advance raises on both sides."""
    if spec.startswith("schema"):
        ja, ta = _auts(schema=SCHEMAS[int(spec[6:])])
        assert ta.pattern == ja.pattern
    else:
        ja, ta = _auts(spec)
    assert ta.start_state == ja.start_state
    seen, todo = {ta.start_state}, [ta.start_state]
    while todo and len(seen) < 40:
        sid = todo.pop(0)
        np.testing.assert_array_equal(ta.mask(sid), ja.mask(sid))
        np.testing.assert_array_equal(ta.bias(sid), ja.bias(sid))
        assert ta.bias(sid).dtype == np.float32
        assert ta.accepting(sid) == ja.accepting(sid)
        for tok in np.nonzero(ta.mask(sid))[0]:
            nxt = ta.advance(sid, int(tok))
            assert nxt == ja.advance(sid, int(tok))
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        bad = np.nonzero(~ta.mask(sid))[0]
        if len(bad) and int(bad[0]) != EOS:
            with pytest.raises(ValueError, match="illegal"):
                ta.advance(sid, int(bad[0]))
            with pytest.raises(ValueError, match="illegal"):
                ja.advance(sid, int(bad[0]))


def test_json_schema_regex_and_escape_match_reference():
    for schema in SCHEMAS:
        assert TG.json_schema_regex(schema) == JG.json_schema_regex(schema)
    assert TG.regex_escape('a.b{c}"d-e') == JG.regex_escape('a.b{c}"d-e')
    with pytest.raises(ValueError):
        TG.json_schema_regex({"type": "array"})


# ------------------------------------------------------------------ engine
def _legal(aut, tokens):
    sid = aut.start_state
    for t in tokens:
        assert aut.mask(sid)[int(t)], (t, VOCAB[int(t)])
        sid = aut.advance(sid, int(t))
    return sid


def _serve(cls, req_cls, aut_mod, model, reqs, **kw):
    """``reqs``: (prompt, request kwargs, pattern or None)."""
    eng = cls(model, **{**ENG, **kw})
    auts, ids = [], []
    for p, rk, pat in reqs:
        aut = (None if pat is None else
               aut_mod.TokenMaskAutomaton(pat, vocab=VOCAB,
                                          eos_token_id=EOS))
        auts.append(aut)
        ids.append(eng.add_request(req_cls(p, grammar=aut, **rk)))
    eng.run()
    eng.assert_quiescent()
    return ([list(map(int, eng.requests[i].tokens)) for i in ids],
            [eng.requests[i].finish_reason for i in ids], auts, eng)


def _match(pair, reqs, **kw):
    jm, tm = pair
    want = _serve(JEngine, JRequest, JG, jm, reqs, **kw)
    got = _serve(LLMEngine, Request, TG, tm, reqs, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    for toks, aut in zip(got[0], got[2]):
        if aut is not None:
            _legal(aut, toks)
    return got


def test_engine_greedy_grammar_matches_reference(pair):
    p = np.arange(1, 6, dtype=np.int32)
    toks, reasons, auts, eng = _match(
        pair, [(p, dict(max_new_tokens=6), "[ab]{3}")])
    assert reasons == ["eos"]
    assert re.fullmatch("[ab]{3}", "".join(VOCAB[t] for t in toks[0]))
    assert eng.stats["grammar_ticks"] > 0
    free = _serve(LLMEngine, Request, TG, pair[1],
                  [(p, dict(max_new_tokens=6), None)])[0]
    assert free[0] != toks[0]                     # the mask bound


def test_engine_mixed_free_and_grammar_rows(pair):
    """Grammar rows and free rows in the same ticks: the grammar streams
    equal the reference's, and the free rows equal a run with no grammar
    row present (their bias row is an exact 0)."""
    rs = np.random.RandomState(2)
    reqs = [(rs.randint(0, 63, (5,)), dict(max_new_tokens=6), "[ab]{8}"),
            (rs.randint(0, 63, (7,)), dict(max_new_tokens=6), None),
            (rs.randint(0, 63, (4,)), dict(max_new_tokens=8),
             "\\d+(\\.\\d+)?"),
            (rs.randint(0, 63, (6,)), dict(max_new_tokens=5), None)]
    toks = _match(pair, reqs)[0]
    free = _serve(LLMEngine, Request, TG, pair[1],
                  [r for r in reqs if r[2] is None])[0]
    assert [toks[1], toks[3]] == free


def test_engine_spec_grammar_matches_reference_and_nonspec(pair):
    """Speculative decoding under a grammar (the target as its own
    draft): equal to the reference's speculative engine and to the
    non-speculative grammar stream, token for token."""
    jm, tm = pair
    p = np.arange(3, 9, dtype=np.int32)
    reqs = [(p, dict(max_new_tokens=6), "(ab|ba){4}"),
            (p[::-1].copy(), dict(max_new_tokens=6), None)]
    plain = _serve(LLMEngine, Request, TG, tm, reqs)[0]
    jeng = _serve(JEngine, JRequest, JG, jm, reqs, draft_model=jm,
                  spec_k=4)[0]
    before = _GRAMMAR_SPEC_REJECTS.value()
    got = _serve(LLMEngine, Request, TG, tm, reqs, draft_model=tm,
                 spec_k=4)
    assert got[0] == jeng == plain
    assert got[3].stats["spec_ticks"] > 0
    assert _GRAMMAR_SPEC_REJECTS.value() >= before


def test_engine_grammar_spec_rejects_a_bad_draft(pair):
    """A draft model of other weights proposes illegal tokens: the mask
    rejects them before the accept rule (the counter rises) and the
    stream is still the non-speculative one."""
    jm, tm = pair
    draft = tiny_pair(seed=5, **TINY)[1]
    p = np.arange(2, 8, dtype=np.int32)
    reqs = [(p, dict(max_new_tokens=8), "[ab]{2}c[0-9]{3}")]
    plain = _serve(LLMEngine, Request, TG, tm, reqs)[0]
    got = _serve(LLMEngine, Request, TG, tm, reqs, draft_model=draft,
                 spec_k=3)
    assert got[0] == plain
    assert _GRAMMAR_SPEC_REJECTS.value() > 0


def test_engine_grammar_through_chunked_prefill_and_preemption(pair):
    """A long grammar prompt (chunked prefill: its first token sampled
    under the mask after the last chunk) and grammar rows preempted on a
    tight pool (the state replays the emitted tokens on resume): the
    streams equal the reference engine's."""
    rs = np.random.RandomState(7)
    reqs = [(rs.randint(0, 63, (20,)), dict(max_new_tokens=8), "[a-e]{6}"),
            (rs.randint(0, 63, (9,)), dict(max_new_tokens=10), "[0-9]{9}"),
            (rs.randint(0, 63, (11,)), dict(max_new_tokens=10), None),
            (rs.randint(0, 63, (6,)), dict(max_new_tokens=10), "x(yz)*")]
    kw = dict(max_prompt_len=8, max_seq_len=32, num_blocks=14,
              preemption=True)
    toks, _, _, eng = _match(pair, reqs, **kw)
    assert eng.stats["preemptions"] > 0


def test_sampled_grammar_rows_filter_like_reference(monkeypatch):
    """The distribution a sampled grammar row draws from: the reference's
    ``_sample_rows`` with the mask bias (its categorical captured) and
    the port's ``filter_rows`` with the same bias agree; greedy rows pick
    the same legal token."""
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(4, 64)).astype(np.float32)
    ja, ta = _auts("[a-f]{2}")
    s1 = ta.advance(ta.start_state, VOCAB.index("c"))
    bias = np.stack([ta.bias(ta.start_state), ta.bias(s1),
                     np.zeros(64, np.float32), ta.bias(ta.start_state)])
    temps = np.array([0.0, 0.8, 1.0, 1.3], np.float32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.7], np.float32)
    seen = {}

    def capture(key, scaled, axis=-1):
        seen["scaled"] = np.array(scaled)
        return jnp.argmax(scaled, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    want = np.asarray(JD._sample_rows(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(temps),
        jnp.asarray(top_ps), None, bias=jnp.asarray(bias)))
    got = filter_rows(torch.as_tensor(logits), torch.as_tensor(temps),
                      torch.as_tensor(top_ps), None,
                      torch.as_tensor(bias)).numpy()
    live = (got > -1e29) & (seen["scaled"] > -1e29)
    np.testing.assert_array_equal(got[[0, 1, 3]] > -1e29,
                                  seen["scaled"][[0, 1, 3]] > -1e29)
    np.testing.assert_allclose(got[live], seen["scaled"][live], rtol=1e-6)
    # every kept entry of a masked row is mask-legal
    assert ((got[1] > -1e29) <= ta.mask(s1)).all()
    assert want[0] == int(np.argmax(logits[0] + bias[0]))


def test_engine_sampled_grammar_rows_stay_legal(pair):
    _, tm = pair
    p = np.arange(2, 8, dtype=np.int32)
    aut = TG.TokenMaskAutomaton("[ab]{8}", vocab=VOCAB, eos_token_id=EOS)
    eng = LLMEngine(tm, **ENG)
    rids = [eng.add_request(Request(p, max_new_tokens=5, grammar=aut,
                                    temperature=1.0, top_p=0.9))
            for _ in range(3)]
    out = eng.run()
    eng.assert_quiescent()
    for rid in rids:
        _legal(aut, out[rid])
        assert len(out[rid]) == 5                # never accepting: no EOS


def test_async_engine_never_cruises_with_a_grammar_row(pair):
    _, tm = pair
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, 63, (5,)), dict(max_new_tokens=10), None),
            (rs.randint(0, 63, (6,)), dict(max_new_tokens=10), "[ab]{9}")]
    want = _serve(LLMEngine, Request, TG, tm, reqs, num_slots=4)[0]
    eng = LLMEngine(tm, **{**ENG, "num_slots": 4, "async_depth": 2})
    aut = TG.TokenMaskAutomaton("[ab]{9}", vocab=VOCAB, eos_token_id=EOS)
    ids = [eng.add_request(Request(reqs[0][0], **reqs[0][1])),
           eng.add_request(Request(reqs[1][0], grammar=aut, **reqs[1][1]))]
    reasons = []
    while eng.has_work():
        reasons.append(eng._async_block_reason())
        eng.step()
    eng.assert_quiescent()
    assert [eng.requests[i].tokens for i in ids] == want
    assert "grammar" in reasons and not eng._async_win


def test_add_request_validates_grammar(pair):
    _, tm = pair
    eng = LLMEngine(tm, **ENG)
    short = TG.TokenMaskAutomaton("[ab]*", vocab=VOCAB[:32],
                                  eos_token_id=31)
    with pytest.raises(ValueError, match="vocab"):
        eng.add_request(Request(np.arange(3), grammar=short,
                                max_new_tokens=4))
    with pytest.raises(ValueError, match="TokenMaskAutomaton"):
        eng.add_request(Request(np.arange(3), grammar="[ab]*",
                                max_new_tokens=4))
    aut = TG.TokenMaskAutomaton("[ab]*", vocab=VOCAB, eos_token_id=EOS)
    with pytest.raises(NotImplementedError, match="beam"):
        eng.add_request(Request(np.arange(3), grammar=aut, num_beams=2,
                                max_new_tokens=4))
