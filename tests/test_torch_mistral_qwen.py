"""Mistral and Qwen2 in the port against the JAX models.

``MistralConfig.tiny`` (sliding window 16) and ``Qwen2Config.tiny``
(biased fused QKV, tied embeddings) with the same weights (the JAX
model's ``state_dict()`` through ``load_jax_state_dict``) and the same
numpy batch: logits, the loss and every gradient, fp32 on the CPU, where
each kernel wrapper runs its plain version. Tolerances as in
``test_torch_train.py``: the two sides differ only in the summation
order of XLA's and ATen's matmuls and reductions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import mistral as jmistral
from paddle_tpu.models import qwen as jqwen
from paddle_tpu_torch.models import (MistralConfig, MistralForCausalLM,
                                     Qwen2Config, Qwen2ForCausalLM)
from paddle_tpu_torch.models.convert import load_jax_state_dict
from tests.test_torch_common import F32_TOL, to_np

FAMILIES = {
    "mistral": (jmistral.MistralConfig.tiny, jmistral.MistralForCausalLM,
                MistralConfig.tiny, MistralForCausalLM),
    "qwen2": (jqwen.Qwen2Config.tiny, jqwen.Qwen2ForCausalLM,
              Qwen2Config.tiny, Qwen2ForCausalLM),
}


def _pair(family, seed=0, **kw):
    jcfg, jcls, tcfg, tcls = FAMILIES[family]
    pt.seed(seed)
    jm = jcls(jcfg(**kw))
    tm = tcls(tcfg(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm


def _batch(b=2, s=40, vocab=256, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    return ids, labels


def test_configs_match_the_reference():
    for name in ("mistral_7b", "tiny"):
        j = getattr(jmistral.MistralConfig, name)()
        t = getattr(MistralConfig, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rope_theta", "sliding_window"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    for name in ("qwen2_7b", "qwen2_0_5b", "tiny"):
        j = getattr(jqwen.Qwen2Config, name)()
        t = getattr(Qwen2Config, name)()
        for f in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "rope_theta", "attention_bias",
                  "tie_word_embeddings"):
            assert getattr(t, f) == getattr(j, f), (name, f)


@pytest.mark.parametrize("family", ["mistral", "qwen2"])
def test_logits_loss_and_every_grad_match_reference(family):
    jm, tm = _pair(family)
    if family == "qwen2":
        assert tm.lm_head is None and tm.model.layers[0].self_attn.qkv_bias \
            is not None
    # 40 tokens: past Mistral-tiny's window of 16, so the band is exercised
    ids, labels = _batch()
    np.testing.assert_allclose(
        to_np(tm(torch.as_tensor(ids))), np.asarray(jm(jnp.asarray(ids))),
        **F32_TOL)
    jloss, jgrads = value_and_grad(lambda m, i, lab: m.loss(i, lab))(
        jm, jnp.asarray(ids), jnp.asarray(labels))
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = jgrads.state_dict()
    got = {n: to_np(p.grad) for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, np.asarray(want[name], np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_mistral_window_changes_output():
    """The counterpart of ``test_mistral_qwen.py``'s: with window 4 and one
    layer, a change at token 0 cannot reach position 23, but does reach
    position 2 — on both sides alike."""
    jm, tm = _pair("mistral", sliding_window=4, num_hidden_layers=1)
    ids = np.random.RandomState(0).randint(0, 256, (1, 24))
    ids2 = ids.copy()
    ids2[0, 0] = (ids[0, 0] + 1) % 256
    with torch.no_grad():
        out1, out2 = (tm(torch.as_tensor(i)) for i in (ids, ids2))
    np.testing.assert_allclose(to_np(out1[0, -1]), to_np(out2[0, -1]),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(to_np(out1[0, 2]), to_np(out2[0, 2]))
    np.testing.assert_allclose(to_np(out2), np.asarray(jm(jnp.asarray(ids2))),
                               **F32_TOL)
