"""The standalone speculative API of the port against the reference.

Ports the speculative cases of ``tests/test_longctx_spec.py`` and the two
cases of ``tests/test_speculative_sampling.py`` to ``paddle_tpu_torch``
(``models/speculative.py``: ``speculative_generate``,
``speculative_generate_batched``, ``speculative_sample``). Same weights on
both sides (the JAX models' ``state_dict()`` loaded into the port), fp32
on the CPU: the greedy streams equal the port's own ``generate()`` and the
JAX functions' streams token for token, and ``speculative_sample`` draws
the reference's tokens at the same seed. The statistical case holds the
sampled second token's marginal to the exact target marginal (total
variation below 0.12, and below the draft's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models import speculative as jspec
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.decoding import generate
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.speculative import (
    speculative_generate, speculative_generate_batched, speculative_sample)
from tests._torch_threads import one_torch_thread  # noqa: F401

CFG = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=64)


def _model(seed, **kw):
    """(JAX model, port model) of ``LlamaConfig.tiny(**kw)``, same weights
    (fp32)."""
    pt.seed(seed)
    jm = JLlama(JLlamaConfig.tiny(**kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _pair(**kw):
    """(target, draft) pairs: a 2-layer target (seed 0) and an unrelated
    1-layer draft (seed 1), as the reference's ``_pair``."""
    cfg = {**CFG, **kw}
    jt, tt = _model(0, **cfg)
    jd, td = _model(1, **{**cfg, "num_hidden_layers": 1})
    return (jt, jd), (tt, td)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_speculative_equals_target_greedy(pair):
    """Whatever the draft proposes, the output is exactly the target's own
    greedy decode, and the reference's speculative stream."""
    (jt, jd), (tt, td) = pair
    ids = np.random.RandomState(2).randint(0, 64, (1, 8))
    got, stats = speculative_generate(tt, td, torch.as_tensor(ids),
                                      max_new_tokens=10, gamma=3)
    np.testing.assert_array_equal(_np(got), _np(generate(tt, ids, 10)))
    want, jstats = jspec.speculative_generate(jt, jd, jnp.asarray(ids),
                                              max_new_tokens=10, gamma=3)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert stats["rounds"] >= 1 and 0.0 <= stats["acceptance_rate"] <= 1.0
    assert {k: stats[k] for k in jstats} == jstats


def test_speculative_perfect_draft_accepts_everything(pair):
    """Draft == target: every proposal is accepted, so the target runs
    about max_new / (gamma + 1) verifications."""
    (jt, _), (tt, _) = pair
    ids = np.random.RandomState(3).randint(0, 64, (1, 8))
    new, gamma = 12, 3
    got, stats = speculative_generate(tt, tt, ids, max_new_tokens=new,
                                      gamma=gamma)
    np.testing.assert_array_equal(_np(got), _np(generate(tt, ids, new)))
    assert stats["acceptance_rate"] == 1.0
    assert stats["rounds"] <= -(-new // (gamma + 1)) + 1
    want, jstats = jspec.speculative_generate(jt, jt, jnp.asarray(ids),
                                              max_new_tokens=new,
                                              gamma=gamma)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert stats["rounds"] == jstats["rounds"]


def test_speculative_eos_matches_generate_exactly(pair):
    """With an EOS token the buffer equals generate()'s, zero padding
    after the first EOS included, and the reference's."""
    (jt, jd), (tt, td) = pair
    ids = np.random.RandomState(5).randint(0, 64, (1, 8))
    eos = int(_np(generate(tt, ids, 10))[0, 8 + 1])
    ref = generate(tt, ids, 10, eos_token_id=eos)
    got, _ = speculative_generate(tt, td, ids, max_new_tokens=10, gamma=3,
                                  eos_token_id=eos)
    np.testing.assert_array_equal(_np(got), _np(ref))
    want, _ = jspec.speculative_generate(jt, jd, jnp.asarray(ids),
                                         max_new_tokens=10, gamma=3,
                                         eos_token_id=eos)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_speculative_batched_ragged_equals_solo_greedy(pair):
    """Batched speculation: every ragged row's output is its solo greedy
    decode (rows advancing at their own acceptance), and the reference's
    batched stream."""
    (jt, jd), (tt, td) = pair
    rs = np.random.RandomState(5)
    lens = [8, 5, 11, 3]
    new = 9
    padded = np.zeros((len(lens), max(lens)), np.int64)
    rows = []
    for i, n in enumerate(lens):
        rows.append(rs.randint(0, 64, (n,)))
        padded[i, :n] = rows[-1]
    got, stats = speculative_generate_batched(
        tt, td, padded, prompt_lens=np.asarray(lens), max_new_tokens=new,
        gamma=3)
    got = _np(got)
    for i, r in enumerate(rows):
        ref = _np(generate(tt, r[None], new))[0]
        np.testing.assert_array_equal(got[i, : lens[i] + new], ref,
                                      err_msg=f"row {i}")
    want, jstats = jspec.speculative_generate_batched(
        jt, jd, padded, prompt_lens=np.asarray(lens), max_new_tokens=new,
        gamma=3)
    np.testing.assert_array_equal(got, _np(want))
    assert stats["rounds"] == jstats["rounds"] >= 1


def test_speculative_batched_eos_per_row(pair):
    """Rows reach EOS at different rounds: finished rows freeze (zeros
    past EOS) while the others go on exactly."""
    (jt, jd), (tt, td) = pair
    rs = np.random.RandomState(6)
    b, s, new = 3, 6, 8
    ids = rs.randint(0, 64, (b, s))
    refs = [_np(generate(tt, ids[i][None], new))[0] for i in range(b)]
    eos = int(refs[0][s + 1])
    got, _ = speculative_generate_batched(tt, td, ids, max_new_tokens=new,
                                          gamma=3, eos_token_id=eos)
    got = _np(got)
    for i in range(b):
        gen = refs[i][s:]
        stop = np.nonzero(gen == eos)[0]
        keep = int(stop[0]) + 1 if len(stop) else new
        np.testing.assert_array_equal(got[i, s: s + keep], gen[:keep],
                                      err_msg=f"row {i}")
        assert (got[i, s + keep:] == 0).all()
    want, _ = jspec.speculative_generate_batched(
        jt, jd, ids, max_new_tokens=new, gamma=3, eos_token_id=eos)
    np.testing.assert_array_equal(got, _np(want))


def test_speculative_dynamic_ntk_stays_lossless():
    """Under dynamic NTK the verify chunks rotate each position with its
    own length and the prefill with the prompt's (``chunk_end_len``):
    single, batched and long-prompt ragged streams equal generate() past
    the trained window, and the reference's streams."""
    (jt, jd), (tt, td) = _pair(
        max_position_embeddings=8,
        rope_scaling={"type": "dynamic", "factor": 2.0})
    rs = np.random.RandomState(13)
    new = 10
    ids = rs.randint(0, 64, (1, 6))
    ref = _np(generate(tt, ids, new))
    got, _ = speculative_generate(tt, td, ids, max_new_tokens=new, gamma=3)
    np.testing.assert_array_equal(_np(got), ref)
    gotb, _ = speculative_generate_batched(tt, td, ids, max_new_tokens=new,
                                           gamma=3)
    np.testing.assert_array_equal(_np(gotb), ref)
    # a long prompt (12 > trained 8) prefills with the chunk-end base
    ids_long = rs.randint(0, 64, (1, 12))
    got_l, _ = speculative_generate(tt, td, ids_long, max_new_tokens=new,
                                    gamma=3)
    np.testing.assert_array_equal(_np(got_l),
                                  _np(generate(tt, ids_long, new)))
    want_l, _ = jspec.speculative_generate(jt, jd, jnp.asarray(ids_long),
                                           max_new_tokens=new, gamma=3)
    np.testing.assert_array_equal(_np(got_l), _np(want_l))
    # ragged long rows prefill with the base of their own lengths
    idsb = np.zeros((2, 12), np.int64)
    idsb[0] = ids_long[0]
    idsb[1, :9] = rs.randint(0, 64, (9,))
    lens = np.asarray([12, 9])
    gotb_l, _ = speculative_generate_batched(tt, td, idsb, prompt_lens=lens,
                                             max_new_tokens=new, gamma=3)
    for r in range(2):
        sol = _np(generate(tt, idsb[r:r + 1, :lens[r]], new))[0]
        np.testing.assert_array_equal(_np(gotb_l)[r, :len(sol)], sol)
    wantb_l, _ = jspec.speculative_generate_batched(
        jt, jd, idsb, prompt_lens=lens, max_new_tokens=new, gamma=3)
    np.testing.assert_array_equal(_np(gotb_l), _np(wantb_l))


# ------------------------------------------------- speculative sampling
def _sampling_models(vocab=16, sharpen=False):
    """The reference's ``_models``: a 2-layer target and a 1-layer draft
    with untied heads; ``sharpen`` peaks the target and flattens the draft
    (both tiny random models are near-uniform)."""
    kw = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=vocab,
              tie_word_embeddings=False)
    jt, tt = _model(0, **kw)
    jd, td = _model(1, **{**kw, "num_hidden_layers": 1})
    if sharpen:
        with torch.no_grad():
            tt.lm_head.mul_(24.0)
            td.lm_head.mul_(0.5)
        jt.lm_head = jt.lm_head * 24.0
        jd.lm_head = jd.lm_head * 0.5
    return (jt, jd), (tt, td)


def test_temperature_zero_falls_back_to_lossless_greedy():
    (_, _), (tt, td) = _sampling_models()
    ids = np.random.RandomState(0).randint(0, 16, (1, 5))
    ref, _ = speculative_generate(tt, td, ids, max_new_tokens=6, gamma=2)
    got, _ = speculative_sample(tt, td, ids, max_new_tokens=6, gamma=2,
                                temperature=0.0)
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_sampled_tokens_are_the_references_at_one_seed():
    """The host RandomState draws over the same float32 probabilities:
    the port's tokens equal the reference's at each seed, and a seed
    repeats itself."""
    (jt, jd), (tt, td) = _sampling_models(sharpen=True)
    ids = np.random.RandomState(1).randint(0, 16, (1, 5))
    for seed in (3, 7):
        got, stats = speculative_sample(tt, td, ids, max_new_tokens=8,
                                        gamma=3, seed=seed)
        again, _ = speculative_sample(tt, td, ids, max_new_tokens=8,
                                      gamma=3, seed=seed)
        want, jstats = jspec.speculative_sample(jt, jd, jnp.asarray(ids),
                                                max_new_tokens=8, gamma=3,
                                                seed=seed)
        np.testing.assert_array_equal(_np(got), _np(again))
        np.testing.assert_array_equal(_np(got), _np(want))
        assert {k: stats[k] for k in jstats} == jstats


def test_sampling_matches_target_distribution():
    """1200 seeds: the second sampled token's empirical marginal is within
    total variation 0.12 of the exact target marginal and closer to it
    than to the draft's (the power check)."""
    vocab = 16
    (_, _), (tt, td) = _sampling_models(vocab, sharpen=True)
    ids = np.random.RandomState(0).randint(0, vocab, (1, 5))

    @torch.no_grad()
    def dist(model, prefix):
        lg = model(torch.as_tensor(prefix)).float()[0, -1]
        return torch.softmax(lg, -1).double().numpy()

    p1, q1 = dist(tt, ids), dist(td, ids)
    p_marg, q_marg = np.zeros(vocab), np.zeros(vocab)
    for t1 in range(vocab):
        ext = np.concatenate([ids, [[t1]]], axis=1)
        p_marg += p1[t1] * dist(tt, ext)
        q_marg += q1[t1] * dist(td, ext)
    n = 1200
    counts = np.zeros(vocab)
    for seed in range(n):
        out, _ = speculative_sample(tt, td, ids, max_new_tokens=2, gamma=2,
                                    seed=seed)
        counts[int(out[0, ids.shape[1] + 1])] += 1
    emp = counts / n
    tv_target = 0.5 * np.abs(emp - p_marg).sum()
    tv_draft = 0.5 * np.abs(emp - q_marg).sum()
    ref_gap = 0.5 * np.abs(p_marg - q_marg).sum()
    assert ref_gap > 0.15, "power check needs distinguishable models"
    assert tv_target < 0.12, (tv_target, ref_gap)
    assert tv_target < tv_draft, (tv_target, tv_draft)
