"""The three MoE model families of the port against ``paddle_tpu``.

``MixtralForCausalLM``, ``Qwen2MoeForCausalLM`` and ``MoEForCausalLM`` at
their ``tiny`` configurations, fp32, on the CPU (the grouped GEMM runs its
plain version): the same weights (``load_jax_state_dict``, a name-for-name
copy) and the same numpy batch on both sides. Tolerances: logits 1e-4 and
loss 1e-5 (the same algorithm in another summation order), gradients 1e-4
relative to each gradient's largest element (a router's gradient has
elements near zero), parameters after 3 AdamW steps within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.nn import functional as JF
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import mixtral as tmix
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.train import init_state, make_train_step
from tests.test_torch_common import MOE_FAMILIES, moe_pair, to_np

def _batch(vocab, seed=0, b=2, s=24):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    return ids, labels


def _loss_fn(m, ids, labels):
    return m.loss(ids, labels)


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("family", sorted(MOE_FAMILIES))
def test_logits_loss_and_every_grad_match_reference(family):
    jm, tm, vocab = moe_pair(family)
    ids, labels = _batch(vocab)
    # the reference under one jax.jit each (eager JAX compiles every op of
    # the MoE forward and backward apart, most of this test's time)
    want = _logits(jax.jit(lambda m, i: m(i))(jm, jnp.asarray(ids)))
    got = _logits(tm(torch.as_tensor(ids)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    jloss, jgrads = jax.jit(value_and_grad(_loss_fn))(
        jm, jnp.asarray(ids), jnp.asarray(labels))
    loss = tm.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = jgrads.state_dict()
    params = dict(tm.named_parameters())
    assert set(params) == set(ref)
    for name, p in params.items():
        g = np.asarray(ref[name], np.float32)
        np.testing.assert_allclose(to_np(p.grad), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max() + 1e-9,
                                   err_msg=name)
    # the router learns: its gradient is not identically zero
    gate = next(n for n in params if n.endswith("gate_w"))
    assert float(params[gate].grad.abs().max()) > 0


def test_qwen2_moe_layer_choice_and_bias():
    """``decoder_sparse_step`` / ``mlp_only_layers`` pick the sparse
    layers, the others carry a dense MLP; the fused QKV has a bias."""
    jm, tm, vocab = moe_pair("qwen2_moe", num_hidden_layers=4,
                             decoder_sparse_step=2, mlp_only_layers=(3,))
    assert [lyr.sparse for lyr in tm.layers] == [False, True, False, False]
    assert [lyr.sparse for lyr in jm.layers] == [False, True, False, False]
    assert "layers.0.self_attn.qkv_bias" in dict(tm.named_parameters())
    ids, _ = _batch(vocab, 1)
    want = jax.jit(lambda m, i: m(i))(jm, jnp.asarray(ids))
    np.testing.assert_allclose(to_np(tm(torch.as_tensor(ids))),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_moe_llm_really_drops_at_its_capacity_factor():
    _, tm, vocab = moe_pair("moe_llm")
    assert tm.cfg.capacity_factor == 1.25
    ids, _ = _batch(vocab, 2, b=2, s=64)
    lyr = tm.layers[1]
    x = tm.embed_tokens[torch.as_tensor(ids)]
    _, _, metrics = lyr.moe(x, return_metrics=True)
    assert float(metrics["drop_rate"]) > 0


def test_three_adamw_steps_of_mixtral_match_reference():
    """Three AdamW steps (lr 3e-4, decay 0.1, clip 1.0) of Mixtral-tiny
    through both packages' ``make_train_step``: loss = LM + aux, the fp32
    gate weight trained beside the rest."""
    jm, tm, vocab = moe_pair("mixtral")
    ids, labels = _batch(vocab, 3)
    kw = dict(learning_rate=3e-4, weight_decay=0.1)
    jo = jopt.AdamW(grad_clip=jopt.ClipGradByGlobalNorm(1.0), **kw)
    to = topt.AdamW(grad_clip=topt.ClipGradByGlobalNorm(1.0), **kw)
    jstate = j_init_state(jm, jo)
    jstep = j_make_train_step(_loss_fn, jo, donate=False)
    state = init_state(tm, to)
    step = make_train_step(_loss_fn, to)
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        state, loss = step(state, torch.as_tensor(ids),
                           torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
    want = jstate.model.state_dict()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(to_np(p), np.asarray(want[name],
                                                        np.float32),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_fp32_gate_in_a_bf16_model_is_its_own_master():
    """``gate_w`` stays fp32 inside a bf16 model: under ``multi_precision``
    the optimizer keeps fp32 masters for the bf16 parameters only and
    updates the gate in place; the loss falls over a few steps."""
    tm = tmix.MixtralForCausalLM(
        tmix.MixtralConfig.tiny(dtype=torch.bfloat16), device="cpu")
    ids, labels = _batch(128, 4)
    opt = topt.AdamW(learning_rate=3e-3, weight_decay=0.1,
                     grad_clip=topt.ClipGradByGlobalNorm(1.0),
                     multi_precision=True)
    state = init_state(tm, opt)
    gates = [n for n, _ in tm.named_parameters() if n.endswith("gate_w")]
    assert len(gates) == 2
    for name, p in tm.named_parameters():
        if name in gates:
            assert p.dtype == torch.float32
            assert state.opt_state["master"][name] is None
        else:
            assert p.dtype == torch.bfloat16
            assert state.opt_state["master"][name].dtype == torch.float32
    before = {n: dict(tm.named_parameters())[n].detach().clone()
              for n in gates}
    step = make_train_step(_loss_fn, opt)
    losses = []
    for _ in range(4):
        state, loss = step(state, torch.as_tensor(ids),
                           torch.as_tensor(labels))
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    after = dict(tm.named_parameters())
    for n in gates:
        assert after[n].dtype == torch.float32
        assert not torch.equal(after[n], before[n])


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_reference(reduction, smoothing):
    rs = np.random.RandomState(5)
    logits = (3 * rs.randn(3, 7, 50)).astype(np.float32)
    labels = rs.randint(0, 50, (3, 7))
    labels[0, :2] = -100                       # ignored positions
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            reduction=reduction, label_smoothing=smoothing)
    got = TF.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                           reduction=reduction, label_smoothing=smoothing)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_entropy_weight_and_soft_labels_match_reference():
    rs = np.random.RandomState(6)
    logits = rs.randn(5, 11).astype(np.float32)
    labels = rs.randint(0, 11, (5,))
    w = rs.rand(11).astype(np.float32)
    np.testing.assert_allclose(
        to_np(TF.cross_entropy(torch.as_tensor(logits),
                               torch.as_tensor(labels),
                               weight=torch.as_tensor(w), reduction="none")),
        np.asarray(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    weight=jnp.asarray(w),
                                    reduction="none")), rtol=1e-5, atol=1e-6)
    soft = rs.dirichlet(np.ones(11), 5).astype(np.float32)
    np.testing.assert_allclose(
        float(TF.cross_entropy(torch.as_tensor(logits),
                               torch.as_tensor(soft), soft_label=True)),
        float(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(soft),
                               soft_label=True)), rtol=1e-5)
