"""Row sampling of the port against ``paddle_tpu.models.decoding``.

``jax.random.categorical`` bits cannot be reproduced by a
``torch.Generator``, so the parity is on what the draw is made from: the
filtered, scaled logits (temperature, top-k, per-row top-p) are captured
on the JAX side and compared with ``filter_rows``; greedy rows must pick
the same token; and the port's draws must stay inside the filtered set
and follow its softmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import decoding as JD
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.models.decoding import _sample_rows, filter_rows


@pytest.mark.parametrize("top_k", [None, 5])
def test_filtered_logits_and_greedy_rows_match(monkeypatch, top_k):
    rs = np.random.RandomState(0)
    logits = (3 * rs.randn(4, 32)).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.3, 0.5], np.float32)
    top_ps = np.array([1.0, 0.9, 0.5, 1.0], np.float32)
    seen = {}

    def capture(key, scaled, axis=-1):
        seen["scaled"] = np.array(scaled)
        return jnp.argmax(scaled, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    want = np.asarray(JD._sample_rows(jnp.asarray(logits),
                                      jax.random.PRNGKey(0),
                                      jnp.asarray(temps), jnp.asarray(top_ps),
                                      top_k))
    got = filter_rows(torch.as_tensor(logits), torch.as_tensor(temps),
                      torch.as_tensor(top_ps), top_k).numpy()
    # rows with a nucleus cut (top_p < 1) cut the same entries (-1e30)
    # and scale the kept ones alike
    cut = top_ps < 1.0
    np.testing.assert_array_equal(got[cut] <= -1e29,
                                  seen["scaled"][cut] <= -1e29)
    keep = (got > -1e29) & (seen["scaled"] > -1e29)
    np.testing.assert_allclose(got[keep], seen["scaled"][keep], rtol=1e-6)
    # top_p = 1 rows: where the fp32 cumulative sum reaches 1.0 differs in
    # the last ulp between XLA and ATen, so tokens of probability ~1e-8
    # may be cut on one side only; the distributions drawn from agree
    np.testing.assert_allclose(
        torch.softmax(torch.as_tensor(got), -1).numpy(),
        torch.softmax(torch.as_tensor(seen["scaled"]), -1).numpy(),
        atol=1e-6)
    toks = _sample_rows(torch.as_tensor(logits),
                        generator(0, device="cpu"),
                        torch.as_tensor(temps), torch.as_tensor(top_ps),
                        top_k).numpy()
    assert toks[0] == want[0] == logits[0].argmax()     # greedy row


def test_draws_stay_in_the_nucleus_and_follow_its_softmax():
    rs = np.random.RandomState(1)
    logits = torch.as_tensor(rs.randn(1, 8).astype(np.float32)).repeat(4000, 1)
    temps = torch.full((4000,), 0.7)
    top_ps = torch.full((4000,), 0.8)
    scaled = filter_rows(logits, temps, top_ps)[0]
    probs = torch.softmax(scaled, -1).numpy()
    toks = _sample_rows(logits, generator(3, device="cpu"), temps,
                        top_ps).numpy()
    assert set(toks) <= set(np.nonzero(probs > 0)[0])
    freq = np.bincount(toks, minlength=8) / len(toks)
    np.testing.assert_allclose(freq, probs, atol=0.03)
