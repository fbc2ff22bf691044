"""The port's train step against ``paddle_tpu.train.make_train_step``.

Same weights (the JAX model's ``state_dict()`` through
``load_jax_state_dict``), the same numpy batch (labels = ids shifted by
one, ending in -100) and the same optimizer settings on both sides, at
``LlamaConfig.tiny()`` on the CPU, where every kernel wrapper of the port
runs its plain version. Tolerances, fp32: both sides run the same
algorithm and differ only in the summation order of XLA's and ATen's
matmuls and reductions, a few ulp per op through a 2-layer model; the
loss is one reduction of those (rtol 1e-5), a gradient element a sum of
products of them (rtol 1e-4, atol 1e-6 for elements near zero), and
after 3 AdamW steps of lr 3e-4 a parameter moves by ~1e-3, so its
rounding differences stay far below atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.distributed.tensor_parallel import (
    parallel_cross_entropy as j_parallel_cross_entropy)
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import num_flops_per_token as j_flops
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.train import make_train_step as j_make_train_step
from paddle_tpu.train.step import init_state as j_init_state
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           num_flops_per_token)
from paddle_tpu_torch.nn.functional import parallel_cross_entropy
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.train import init_state, make_train_step
from tests.test_torch_common import tiny_pair, to_np


def _batch(seed=0, b=2, s=32, vocab=256):
    ids = np.random.RandomState(seed).randint(0, vocab, (b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    return ids, labels


def _loss_fn(m, ids, labels):
    return m.loss(ids, labels)


def _port_grads(tm, ids, labels):
    tm.zero_grad(set_to_none=True)
    loss = tm.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    return float(loss.detach()), {n: to_np(p.grad)
                                  for n, p in tm.named_parameters()}


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_first_step_loss_and_every_grad_match_reference(nkv):
    jm, tm = tiny_pair(num_key_value_heads=nkv)
    ids, labels = _batch()
    # the reference under one jax.jit (eager JAX compiles every op apart)
    jloss, jgrads = jax.jit(value_and_grad(_loss_fn))(
        jm, jnp.asarray(ids), jnp.asarray(labels))
    loss, grads = _port_grads(tm, ids, labels)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    want = jgrads.state_dict()
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g, np.asarray(want[name], np.float32),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _optimizers(kind, mod):
    """The same optimizer settings, built from ``mod`` (either package)."""
    if kind == "adamw_clip":             # the bench.py headline's settings
        return mod.AdamW(learning_rate=3e-4, weight_decay=0.1,
                         grad_clip=mod.ClipGradByGlobalNorm(1.0))
    if kind == "adam_coupled_decay":
        return mod.Adam(learning_rate=1e-3, weight_decay=0.01)
    # a warm-up schedule and name-masked decoupled decay
    sched = mod.LinearWarmup(1e-3, warmup_steps=2, start_lr=1e-4)
    return mod.AdamW(learning_rate=sched, weight_decay=0.1,
                     apply_decay_param_fun=lambda n: "norm" not in n)


@pytest.mark.parametrize("kind", ["adamw_clip", "adam_coupled_decay",
                                  "adamw_warmup_masked"])
def test_three_steps_match_reference(kind):
    jm, tm = tiny_pair(num_key_value_heads=2)
    ids, labels = _batch(1)
    jopt_ = _optimizers(kind, jopt)
    jstate = j_init_state(jm, jopt_)
    jstep = j_make_train_step(_loss_fn, jopt_, donate=False)
    topt_ = _optimizers(kind, topt)
    state = init_state(tm, topt_)
    step = make_train_step(_loss_fn, topt_)
    t_ids, t_labels = torch.as_tensor(ids), torch.as_tensor(labels)
    for i in range(3):
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        state, loss = step(state, t_ids, t_labels)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg=f"step {i}")
    assert state.step == int(jstate.step) == 3
    want = jstate.model.state_dict()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(to_np(p), np.asarray(want[name],
                                                        np.float32),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_remat_gives_the_same_grads():
    """remat recomputes each layer in backward: the same arithmetic on
    the CPU, so the same gradients to rounding."""
    _, tm = tiny_pair(num_key_value_heads=2)
    tr = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=2,
                                           remat=True), device="cpu")
    tr.load_state_dict(tm.state_dict())
    ids, labels = _batch(2)
    loss, grads = _port_grads(tm, ids, labels)
    loss_r, grads_r = _port_grads(tr, ids, labels)
    assert loss_r == loss
    for name, g in grads.items():
        np.testing.assert_allclose(grads_r[name], g, rtol=1e-6, atol=1e-8,
                                   err_msg=name)


def test_bf16_multi_precision_run_tracks_reference():
    """bf16 params with fp32 master weights on both sides. The two round
    to bf16 at different places (the port's fused norm and attention
    cast once where the reference's XLA path casts per op), so the losses
    agree to bf16 precision over the run: 2e-2 relative."""
    pt.seed(0)
    jm = JLlama(JLlamaConfig.tiny(dtype=jnp.bfloat16))
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.bfloat16),
                          device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    ids, labels = _batch(3)
    kw = dict(learning_rate=3e-3, weight_decay=0.1, multi_precision=True)
    jo = jopt.AdamW(grad_clip=jopt.ClipGradByGlobalNorm(1.0), **kw)
    to = topt.AdamW(grad_clip=topt.ClipGradByGlobalNorm(1.0), **kw)
    jstate = j_init_state(jm, jo)
    jstep = j_make_train_step(_loss_fn, jo, donate=False)
    state = init_state(tm, to)
    step = make_train_step(_loss_fn, to)
    losses = []
    for _ in range(4):
        jstate, jloss = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        state, loss = step(state, torch.as_tensor(ids),
                           torch.as_tensor(labels))
        losses.append(float(loss))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert losses[-1] < losses[0]
    for name, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16, name
        assert state.opt_state["master"][name].dtype == torch.float32, name
        np.testing.assert_array_equal(
            to_np(p), to_np(state.opt_state["master"][name].bfloat16()))


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_parallel_cross_entropy_matches_reference(smoothing):
    rs = np.random.RandomState(4)
    logits = (3 * rs.randn(3, 7, 50)).astype(np.float32)
    labels = rs.randint(0, 50, (3, 7))
    want = j_parallel_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    label_smoothing=smoothing)
    t = torch.as_tensor(logits, dtype=torch.float64).float().requires_grad_()
    got = parallel_cross_entropy(t, torch.as_tensor(labels),
                                 label_smoothing=smoothing)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # its gradient is softmax - onehot (smoothed): rows sum to zero
    got.sum().backward()
    np.testing.assert_allclose(to_np(t.grad).sum(-1), 0.0, atol=1e-6)


def _schedulers(mod):
    return {
        "noam": mod.NoamDecay(64, 4, learning_rate=0.5),
        "exp": mod.ExponentialDecay(0.1, 0.9),
        "natural_exp": mod.NaturalExpDecay(0.1, 0.2),
        "inverse_time": mod.InverseTimeDecay(0.1, 0.5),
        "poly": mod.PolynomialDecay(0.1, 7, end_lr=0.01, power=2.0),
        "poly_cycle": mod.PolynomialDecay(0.1, 4, cycle=True),
        "piecewise": mod.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
        "cosine": mod.CosineAnnealingDecay(0.1, 8, eta_min=0.001),
        "warmup_const": mod.LinearWarmup(0.1, 3, start_lr=0.01),
        "warmup_cosine": mod.LinearWarmup(
            mod.CosineAnnealingDecay(0.1, 6), 3, start_lr=0.0),
        "step": mod.StepDecay(0.1, 3, gamma=0.5),
        "multistep": mod.MultiStepDecay(0.1, [2, 5], gamma=0.3),
        "lambda": mod.LambdaDecay(0.1, lambda s: 1.0 / (1.0 + s)),
        "one_cycle": mod.OneCycleLR(0.1, 10),
        "cyclic": mod.CyclicLR(0.01, 0.1, 3, step_size_down=2),
    }


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_matches_reference(name):
    want, got = _schedulers(jlr)[name], _schedulers(tlr)[name]
    for step in range(13):
        # the reference evaluates in fp32
        np.testing.assert_allclose(got.value_at(step),
                                   float(want.value_at(jnp.asarray(step))),
                                   rtol=2e-6, atol=1e-9, err_msg=str(step))
    for _ in range(3):
        want.step()
        got.step()
    assert got.get_lr() == pytest.approx(want.get_lr(), rel=2e-6)


def test_set_lr_and_flops_match_reference():
    o = topt.AdamW(learning_rate=1e-3)
    state = o.init(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu"))
    state = o.set_lr(5e-4, state)
    assert o.get_lr(state) == 5e-4 and state["step"] == 0
    for cfg_kw in ({}, {"num_key_value_heads": 4, "num_hidden_layers": 3}):
        assert num_flops_per_token(LlamaConfig.tiny(**cfg_kw), 128) == \
            j_flops(JLlamaConfig.tiny(**cfg_kw), 128)
