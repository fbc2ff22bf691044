"""The port's ``paged_generate`` (``paddle_tpu_torch.models.paged``) against
the reference's (``paddle_tpu.models.paged.paged_generate``) on the same
weights and numpy prompts, through the reference's own specs
(``tests/test_paged_decode.py``, ``tests/test_weight_only.py:131``,
``tests/test_longctx_spec.py:143-160`` and ``:224-238``).

Tolerances: greedy rows token for token (fp32 on the CPU, the same
algorithm on both sides; a tie between two logits would show as a
mismatch, none occurs at these seeds); the filtered, scaled logits that a
sampled step draws from within rtol 1e-5 / atol 1e-5 (two fp32 forwards
of a 2-layer model), the cut entries exactly -1e30 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.paged import paged_generate as jpaged_generate
from paddle_tpu_torch.models import decoding as tdec
from paddle_tpu_torch.models.paged import paged_generate
from paddle_tpu_torch.quantization import quantize_llama_weights
from tests.test_torch_common import tiny_pair

SMALL = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
             num_key_value_heads=2, vocab_size=64)


def _pair(**kw):
    return tiny_pair(0, **{**SMALL, **kw})


def _padded(rs, lens, vocab=64):
    out = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        out[i, :n] = rs.randint(0, vocab, (n,))
    return out


def _both(jm, tm, ids, lens, **kw):
    want, _ = jpaged_generate(jm, jnp.asarray(ids), np.asarray(lens), **kw)
    got, cache = paged_generate(tm, ids, np.asarray(lens), **kw)
    return np.asarray(want), got.numpy(), cache


# test_paged_decode.py's cases: (config overrides, prompt lengths, new
# tokens, numpy seed)
CASES = {
    "uniform": ({}, [12, 12], 8, 1),
    "ragged": ({}, [10, 6, 3], 6, 2),
    "sliding_window": ({"sliding_window": 6}, [10, 10], 8, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_rows_match_reference(case):
    """Greedy rows token for token with the reference's ``paged_generate``,
    and each row with the port's dense-cache ``generate`` of that row
    alone (the reference's own rule: ragged rows equal solo decodes)."""
    over, lens, new, seed = CASES[case]
    jm, tm = _pair(**over)
    ids = _padded(np.random.RandomState(seed), lens)
    want, got, _ = _both(jm, tm, ids, lens, max_new_tokens=new, block_size=4)
    np.testing.assert_array_equal(got, want)
    for i, n in enumerate(lens):
        solo = tdec.generate(tm, ids[i:i + 1, :n], max_new_tokens=new)
        np.testing.assert_array_equal(got[i, :n + new], solo[0].numpy())


def test_eos_frees_blocks_and_pads_the_tail():
    """A row that emits EOS stops, is padded with it and frees its blocks;
    a pool at the ragged bound still serves the other row unchanged."""
    jm, tm = _pair()
    b, s, new = 2, 8, 6
    ids = np.random.RandomState(4).randint(0, 64, (b, s))
    ref = tdec.generate(tm, ids, max_new_tokens=new).numpy()
    eos = int(ref[0, s])
    want, got, _ = _both(jm, tm, ids, [s, s], max_new_tokens=new,
                         block_size=4, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, s:] == eos).all()
    stop = np.nonzero(ref[1, s:] == eos)[0]
    upto = s + (stop[0] + 1 if len(stop) else new)
    np.testing.assert_array_equal(got[1, :upto], ref[1, :upto])


def test_pool_is_the_ragged_bound():
    """The pool holds the sum of each row's blocks, not B x max_len."""
    jm, tm = _pair()
    lens, new, bs = [40, 4, 4, 4], 4, 4
    ids = _padded(np.random.RandomState(3), lens)
    want, got, cache = _both(jm, tm, ids, lens, max_new_tokens=new,
                             block_size=bs)
    np.testing.assert_array_equal(got, want)
    ragged = sum(-(-(n + new) // bs) * bs for n in lens)
    assert cache.num_blocks * cache.block_size == ragged
    assert ragged < len(lens) * (max(lens) + new)


def test_weight_only_model():
    """test_weight_only.py:131, its own rule: a weight-only int8 model
    through ``paged_generate`` equals its dense-cache ``generate``."""
    _, tm = _pair()
    qt = quantize_llama_weights(tm, "weight_only_int8")
    b, s, new = 2, 10, 5
    ids = np.random.RandomState(5).randint(0, 64, (b, s))
    got, _ = paged_generate(qt, ids, np.full((b,), s), max_new_tokens=new,
                            block_size=4)
    np.testing.assert_array_equal(
        got.numpy(), tdec.generate(qt, ids, max_new_tokens=new).numpy())


def test_dynamic_ntk_past_the_trained_window():
    """test_longctx_spec.py:224-238: dynamic-NTK rope through the paged
    decode well past max_position_embeddings equals the reference."""
    jm, tm = _pair(max_position_embeddings=8,
                   rope_scaling={"type": "dynamic", "factor": 2.0})
    b, s, new = 2, 6, 10
    ids = np.random.RandomState(11).randint(0, 64, (b, s))
    want, got, _ = _both(jm, tm, ids, [s, s], max_new_tokens=new,
                         block_size=4)
    np.testing.assert_array_equal(got, want)


SAMPLE_KW = dict(max_new_tokens=6, block_size=4, temperature=0.8, top_k=8,
                 top_p=0.9)


def test_sampling_reproducible_under_one_generator():
    """test_longctx_spec.py:143-160 with ``torch.Generator`` in place of
    the PRNG key: one seed repeats its stream, another draws another."""
    _, tm = _pair()
    b, s = 2, 8
    ids = np.random.RandomState(4).randint(0, 64, (b, s))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return paged_generate(tm, ids, np.full((b,), s), generator=gen,
                              **SAMPLE_KW)[0].numpy()
    out1, out2, out3 = run(7), run(7), run(8)
    np.testing.assert_array_equal(out1, out2)
    assert not np.array_equal(out1, out3)
    assert out1.max() < 64 and out1.min() >= 0


def test_sampled_steps_draw_from_the_reference_logits(monkeypatch):
    """Every sampled step's filtered, scaled logits equal the reference's
    (its ``_sample`` hands them to ``jax.random.categorical``): both
    draws replaced by the argmax, so both sides walk one stream."""
    seen_j, seen_t = [], []

    def j_draw(key, logits, axis=-1):
        seen_j.append(np.asarray(logits))
        return jnp.argmax(logits, axis)

    def t_draw(logits, gen):
        seen_t.append(logits.numpy().copy())
        return torch.argmax(logits, -1)
    monkeypatch.setattr(jax.random, "categorical", j_draw)
    monkeypatch.setattr(tdec, "_gumbel_max", t_draw)
    jm, tm = _pair()
    b, s = 2, 8
    ids = np.random.RandomState(4).randint(0, 64, (b, s))
    want, got, _ = _both(jm, tm, ids, [s, s], **SAMPLE_KW)
    np.testing.assert_array_equal(got, want)
    assert len(seen_t) == len(seen_j) == SAMPLE_KW["max_new_tokens"]
    for a, r in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a <= -1e29, r <= -1e29)
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-5)
