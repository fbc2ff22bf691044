"""The fake-quant and QAT/PTQ half of ``quantization.py`` in the port
against the JAX package.

Ports the five cases of ``tests/test_quantization.py``: ``fake_quant``'s
values and straight-through gradient, ``quantize_weight``'s codes and
scales, ``QuantizedLinear``'s exact int8 x int8 -> int32 product, a QAT
model trained 5 SGD steps beside the reference's run from the same
weights, PTQ's conversion and the absmax observer. Same inputs on both
sides, made with numpy from a seed, fp32 on the CPU. Tolerances: codes,
scales and int32 accumulators bit for bit; fake-quant values and
gradients exactly (the same IEEE operations in the same order); the QAT
losses within 1e-6 (XLA's and ATen's fp32 matmul/softmax summation
orders differ by a few ulp).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
import paddle_tpu.quantization as JQ
from paddle_tpu.core.module import combine, partition_trainable
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.models.convert import load_jax_state_dict


def test_fake_quant_values_and_ste():
    """Values on the 127-level grid clipped to [-128/127, 1], equal to the
    reference's; the STE passes the gradient where |x / scale| <= 1 and
    blocks it outside, none reaching the scale."""
    xs = np.asarray([-1.5, -0.5, 0.0, 0.4, 0.9, 2.0], np.float32)
    x = torch.tensor(xs, requires_grad=True)
    scale = torch.tensor(1.0, requires_grad=True)
    y = TQ.fake_quant(x, scale)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.clip(np.round(xs * 127) / 127, -128 / 127, 1.0), atol=1e-6)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0, 1, 1, 1, 1, 0])
    assert float(scale.grad) == 0.0
    # the reference's values and gradient on seeded data, at 8 and 4 bits
    r = (2.5 * np.random.RandomState(0).randn(64)).astype(np.float32)
    for bits in (8, 4):
        t = torch.tensor(r, requires_grad=True)
        got = TQ.fake_quant(t, torch.tensor(1.7), bits)
        got.sum().backward()
        want = JQ.fake_quant(jnp.asarray(r), jnp.asarray(1.7), bits)
        jg = jax.grad(lambda v: JQ.fake_quant(v, jnp.asarray(1.7),
                                              bits).sum())(jnp.asarray(r))
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("axis", [1, 0, None])
def test_quantize_weight_roundtrip(axis):
    rs = np.random.RandomState(0)
    w = rs.randn(32, 16).astype(np.float32)
    q, scale = TQ.quantize_weight(torch.as_tensor(w), axis=axis)
    jq, js = JQ.quantize_weight(jnp.asarray(w), axis=axis)
    assert q.dtype == torch.int8
    if axis == 1:
        assert scale.shape == (1, 16)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    back = TQ.dequantize(q, scale)
    assert float((back - torch.as_tensor(w)).abs().max()) < \
        float(np.abs(w).max()) / 100


def _jax_int_product(qlin, x):
    """The reference QuantizedLinear's int32 accumulator and row scale."""
    qmax = 2.0 ** (qlin.bits - 1) - 1
    xs = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True),
                     1e-8) / qmax
    qx = jnp.clip(jnp.round(x / xs), -qmax - 1, qmax).astype(jnp.int8)
    acc = lax.dot_general(qx, qlin.qweight,
                          dimension_numbers=(((qx.ndim - 1,), (0,)),
                                             ((), ())),
                          preferred_element_type=jnp.int32)
    return acc, xs


def test_quantized_linear_close_to_fp():
    """PTQ weight-only linear: the int32 product equals the reference's bit
    for bit before the rescale (and stays exact past 2^24, where an fp32
    accumulation would not), the output matches the reference's and sits
    within 2% of the float layer."""
    pt.seed(0)
    jlin = jnn.Linear(64, 32, dtype=jnp.float32)
    lin = tnn.Linear(64, 32, device="cpu")
    load_jax_state_dict(lin, jlin.state_dict())
    jq = JQ.quant_linear(jlin)
    tq = TQ.quant_linear(lin)
    np.testing.assert_array_equal(tq.qweight.numpy(), np.asarray(jq.qweight))
    np.testing.assert_array_equal(tq.wscale.numpy(), np.asarray(jq.wscale))
    x = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    acc, xs = tq.int_product(torch.as_tensor(x))
    jacc, jxs = _jax_int_product(jq, jnp.asarray(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    got = tq(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jq(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    want = lin(torch.as_tensor(x)).detach().numpy()
    assert np.abs(got - want).mean() / np.abs(want).mean() < 0.02
    # extreme codes over K = 4096: sums past 2^24 stay exact in int32
    big = torch.full((2, 4096), 127, dtype=torch.int8)
    assert int(TQ.int8_matmul(big, big.T.contiguous())[0, 0]) == \
        127 * 127 * 4096


def test_qat_trains_and_ptq_converts():
    """QAT on Sequential(Linear(16, 32), ReLU(), Linear(32, 4)): 5 SGD
    steps through fake-quantized weights lower the loss, each step's loss
    within 1e-6 of the reference's run from the same weights; PTQ turns
    the Linears into int8 QuantizedLinears that give finite outputs."""
    pt.seed(0)
    jmodel = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(),
                            jnn.Linear(32, 4))
    model = tnn.Sequential(tnn.Linear(16, 32, device="cpu"), tnn.ReLU(),
                           tnn.Linear(32, 4, device="cpu"))
    load_jax_state_dict(model, jmodel.state_dict())
    x = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    y = np.arange(8) % 4

    jqat = JQ.QAT().quantize(jmodel)
    qat = TQ.QAT().quantize(model)
    assert isinstance(qat.layers[0], TQ.QATLinear)
    assert isinstance(model.layers[0], tnn.Linear)   # the pass copies

    def jloss(m):
        return jnn.functional.cross_entropy(m(jnp.asarray(x)),
                                            jnp.asarray(y))

    params, skel = partition_trainable(jqat)
    jsgd = jopt.SGD(learning_rate=0.1)
    jstate = jsgd.init(params)
    sgd = topt.SGD(learning_rate=0.1)
    state = sgd.init(qat)
    jlosses, losses = [], []
    for _ in range(6):
        jl, g = jax.value_and_grad(lambda p: jloss(combine(p, skel)))(params)
        params, jstate = jsgd.step(params, g, jstate)
        qat.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(qat(torch.as_tensor(x)),
                                                 torch.as_tensor(y))
        loss.backward()
        qat, state = sgd.step(qat, None, state)
        jlosses.append(float(jl))
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-6)
    assert losses[-1] < losses[0]      # STE gradients train through it

    ptq = TQ.PTQ().quantize(model)
    assert isinstance(ptq.layers[0], TQ.QuantizedLinear)
    assert ptq.layers[0].qweight.dtype == torch.int8
    out = ptq(torch.as_tensor(x))
    assert out.shape == (8, 4) and bool(torch.isfinite(out).all())
    jout = JQ.PTQ().quantize(jmodel)(jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)


def test_absmax_observer():
    obs = TQ.AbsmaxObserver(momentum=0.5)
    obs.observe(torch.tensor([1.0, -2.0]))
    assert obs.scale == 2.0
    obs.observe(torch.tensor([4.0]))
    assert np.isclose(obs.scale, 3.0)        # 0.5 * 2 + 0.5 * 4
    layer = TQ.quanter.FakeQuanterWithAbsMax(init_scale=obs.scale,
                                             device="cpu")
    x = torch.linspace(-4, 4, 9)
    np.testing.assert_array_equal(
        layer(x).numpy(),
        np.asarray(JQ.FakeQuantLayer(init_scale=3.0)(jnp.asarray(x.numpy()))))
