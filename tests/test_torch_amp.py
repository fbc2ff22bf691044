"""The port's mixed precision (``paddle_tpu_torch.amp``): the policy and
the scaler against ``paddle_tpu.amp`` (``tests/test_train_infra.py``
``test_amp_policy_and_scaler`` / ``test_amp_debugging``), and fp8
(``tests/test_fp8.py``) against ``paddle_tpu.amp.fp8`` on the same numpy
inputs.

Tolerances: the scaler's states are exact (powers of two, integer
counters). ``fp8_matmul`` on the CPU quantizes exactly as the reference
does (the same fp32 scale product, clamp and round-to-nearest-even cast),
so its forward and gradients differ from the reference's only by the
fp32 summation order: rtol 1e-5, atol 1e-6; its rolled histories are
equal. The tiny fp8 Llama's losses over 6 AdamW steps stay within rtol
1e-4 of the reference's fp8 run, and within the reference's own bound
0.15 |a| + 0.05 of the port's fp32 run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.amp import fp8 as jfp8
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.amp import debugging as D
from paddle_tpu_torch.amp import fp8
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import init_state, make_train_step
from tests.test_torch_common import to_np


# --------------------------------------------------------------- policy

def test_policy_casts_a_copy_and_auto_cast_sets_the_default():
    m = Linear(4, 4, device="cpu")
    m16 = amp.O2().cast_to_param(m)
    assert m16.weight.dtype == torch.bfloat16
    assert m.weight.dtype == torch.float32          # the caller's module
    assert amp.decorate(m, level="O2").weight.dtype == torch.bfloat16
    assert amp.decorate(m, level="O1") is m
    assert m.weight.dtype == torch.float32
    tree = amp.O1().cast_to_compute({"a": torch.ones(2), "i": torch.ones(
        2, dtype=torch.int64), "n": None})
    assert tree["a"].dtype == torch.bfloat16 and tree["i"].dtype == \
        torch.int64 and tree["n"] is None
    assert amp.O1().param_dtype == torch.float32
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert torch.ones(1).dtype == torch.bfloat16
    assert torch.get_default_dtype() == torch.float32
    with amp.auto_cast(enable=False, level="O2"):
        assert torch.ones(1).dtype == torch.float32


def test_supported_helpers():
    assert amp.is_bfloat16_supported() is True
    assert amp.is_float16_supported("cpu") is True
    # every kernel of the card has a float16 instantiation
    assert amp.is_float16_supported("cuda") is True
    assert amp.is_float16_supported() is True          # None: the card


# --------------------------------------------------------------- scaler

def test_grad_scaler_matches_reference_states():
    kw = dict(enable=True, init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    sc, jsc = amp.GradScaler(**kw), jamp.GradScaler(**kw)
    st, jst = sc.init("cpu"), jsc.init()
    assert float(sc.scale(torch.tensor(2.0), st)) == 16.0
    np.testing.assert_allclose(
        sc.unscale({"w": torch.tensor([8.0])}, st)["w"].numpy(), [1.0])
    for inf in (True, True, False, False, False, True, False):
        st = sc.update(st, torch.tensor(inf))
        jst = jsc.update(jst, jnp.asarray(inf))
        for k in st:
            assert st[k].item() == float(jst[k]), (k, inf)
    assert bool(sc.found_inf({"a": torch.tensor([float("inf")]),
                              "b": torch.ones(2)}))
    assert not bool(sc.found_inf([torch.tensor([1.0])]))
    old = {"w": torch.zeros(2)}
    new = {"w": torch.ones(2)}
    assert torch.equal(sc.step_or_skip(old, new, torch.tensor(True))["w"],
                       old["w"])
    assert torch.equal(sc.step_or_skip(old, new, torch.tensor(False))["w"],
                       new["w"])
    off = amp.GradScaler(enable=False)
    loss = torch.tensor(3.0)
    assert off.scale(loss, st) is loss
    assert off.update(st, torch.tensor(True)) is st


def test_grad_scaler_skips_an_inf_step_and_halves():
    """The reference's recipe on a port model: an inf gradient halves the
    scale, and step_or_skip keeps the old parameters."""
    m = Linear(4, 2, device="cpu")
    sc = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    st = sc.init("cpu")
    x = torch.ones(3, 4)
    sc.scale((m(x) ** 2).mean(), st).backward()
    grads = sc.unscale({n: p.grad for n, p in m.named_parameters()}, st)
    grads["weight"][0, 0] = float("inf")
    found = sc.found_inf(grads)
    old = {n: p.detach().clone() for n, p in m.named_parameters()}
    new = {n: p - 0.1 * grads[n] for n, p in old.items()}
    kept = sc.step_or_skip(old, new, found)
    st = sc.update(st, found)
    assert float(st["scale"]) == 2.0 ** 9
    for n in old:
        assert torch.equal(kept[n], old[n])


# ------------------------------------------------------------ debugging

def test_amp_debugging():
    assert D.check_numerics({"a": torch.ones(3)}) is True
    with pytest.raises(FloatingPointError, match="1 NaN"):
        D.check_numerics({"a": torch.tensor([1.0, float("nan")])})
    assert D.check_numerics([torch.tensor([float("inf")])],
                            raise_on_error=False) is False
    assert D.count_nonfinite({"a": torch.tensor([float("nan"), float("inf"),
                                                 -float("inf")])}) == (1, 2)
    stats = D.collect_operator_stats(
        lambda x, w: (x @ w).to(torch.bfloat16) @ w.T.to(torch.bfloat16),
        torch.ones(4, 8), torch.ones(8, 8), print_fn=None)
    mms = {k: v for k, v in stats.items() if k[0] == "mm"}
    assert sum(mms.values()) == 2
    assert ("mm", "bf16") in mms and ("mm", "f32") in mms
    ok, rep = D.compare_accuracy(
        lambda x: x * 2.0,
        lambda x: (x.to(torch.bfloat16) * 2.0).float(),
        torch.linspace(0, 1, 16), print_fn=None)
    assert ok and len(rep) == 1


# ------------------------------------------------------------------ fp8

def _xw(seed, m, k, n):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, k).astype(np.float32),
            rs.randn(k, n).astype(np.float32))


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["cold", "calibrated"])
def test_fp8_matmul_forward_and_backward_match_reference(calibrated):
    x, w = _xw(1, 8, 16, 4)
    meta = fp8.new_fp8_meta(device="cpu")
    jmeta = jfp8.new_fp8_meta()
    if calibrated:
        meta.amax_x[0] = float(np.abs(x).max())
        meta.amax_w[0] = float(np.abs(w).max())
        meta.amax_g[0] = 1.5
        jmeta = {"amax_x": jmeta["amax_x"].at[0].set(np.abs(x).max()),
                 "amax_w": jmeta["amax_w"].at[0].set(np.abs(w).max()),
                 "amax_g": jmeta["amax_g"].at[0].set(1.5)}
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    y = fp8.fp8_matmul(xt, wt, meta)
    (y ** 2).sum().backward()

    def loss(x, w, m):
        return jnp.sum(jfp8.fp8_matmul(x, w, m) ** 2)

    jy = jfp8.fp8_matmul(jnp.asarray(x), jnp.asarray(w), jmeta)
    dx, dw, dmeta = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jmeta)
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(xt.grad), np.asarray(dx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to_np(wt.grad), np.asarray(dw), rtol=1e-5,
                               atol=1e-6)
    for r in ("x", "w", "g"):
        np.testing.assert_allclose(getattr(meta, f"amax_{r}").numpy(),
                                   np.asarray(dmeta[f"amax_{r}"]), rtol=1e-6)
    # e4m3 keeps ~2 mantissa bits: within 0.35 of the fp32 product's max
    ref = x @ w
    assert np.abs(to_np(y) - ref).max() < 0.35 * np.abs(ref).max()


def test_plain_products_switch_is_scoped():
    """``plain_products`` routes every fp8_matmul of its block to the
    upcast products and is restored on exit, an exception included; on
    the CPU both routes are the same function."""
    x, w = _xw(4, 6, 16, 8)
    meta = fp8.new_fp8_meta(device="cpu")
    y = fp8.fp8_matmul(torch.tensor(x), torch.tensor(w), meta)
    with pytest.raises(RuntimeError, match="inside"):
        with fp8.plain_products():
            assert fp8._PLAIN[0]
            yp = fp8.fp8_matmul(torch.tensor(x), torch.tensor(w), meta)
            raise RuntimeError("inside")
    assert not fp8._PLAIN[0]
    assert torch.equal(y, yp)


def test_fp8_meta_is_buffers_outside_the_optimizer_and_clip():
    """The histories are buffers: SGD with a crushing global-norm clip
    updates the weight by < 1e-5 while the histories roll with the real
    amaxes, untouched by the clip or the lr."""
    layer = fp8.Fp8Linear(8, 4, dtype=torch.float32, device="cpu",
                          gen=torch.Generator().manual_seed(0))
    assert {n for n, _ in layer.named_parameters()} == {"weight", "bias"}
    assert "fp8_meta.amax_x" in dict(layer.named_buffers())
    o = topt.SGD(learning_rate=0.1, grad_clip=topt.ClipGradByGlobalNorm(1e-6))
    st = o.init(layer)
    x = torch.tensor(np.random.RandomState(2).randn(16, 8).astype(np.float32))
    w0 = layer.weight.detach().clone()
    (layer(x) ** 2).mean().backward()
    o.step(layer, None, st)
    assert float(layer.fp8_meta.amax_x[0]) == pytest.approx(
        float(x.abs().max()), rel=1e-6)
    delta = float((layer.weight - w0).abs().max())
    assert 0 < delta < 1e-5


def test_fp8_llama_loss_trace_matches_reference_and_fp32():
    """cfg.fp8: the tiny Llama's 6-step AdamW loss trace against the
    reference's fp8 run (same weights and batch) and the port's fp32 run
    (the reference's bound); the trace falls; the histories roll once a
    step (6 entries filled)."""
    import paddle_tpu as pt
    from paddle_tpu.models.llama import LlamaConfig as JConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
    from paddle_tpu.train import make_train_step as j_make_train_step
    from paddle_tpu.train.step import init_state as j_init_state
    kw = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=64)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 64, (4, 16))
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
    pt.seed(0)
    jm = JLlama(JConfig.tiny(fp8=True, **kw))
    jo = jopt.AdamW(learning_rate=1e-3)
    jstate = j_init_state(jm, jo)
    jstep = j_make_train_step(lambda m, i, l: m.loss(i, l), jo)
    jtrace = []
    for _ in range(6):
        jstate, loss = jstep(jstate, jnp.asarray(ids), jnp.asarray(labels))
        jtrace.append(float(loss))
    # both port models take the reference fp8 model's initial weights
    pt.seed(0)
    init = JLlama(JConfig.tiny(fp8=True, **kw)).state_dict()
    out, models = {}, {}
    for use_fp8 in (False, True):
        tm = LlamaForCausalLM(LlamaConfig.tiny(fp8=use_fp8, **kw),
                              device="cpu")
        names = {n for n, _ in tm.named_parameters()}
        load_jax_state_dict(tm, {k: v for k, v in init.items()
                                 if k in names})
        o = topt.AdamW(learning_rate=1e-3)
        state = init_state(tm, o)
        step = make_train_step(lambda m, i, l: m.loss(i, l), o)
        trace = []
        for _ in range(6):
            state, loss = step(state, torch.as_tensor(ids),
                               torch.as_tensor(labels))
            trace.append(float(loss))
        out[use_fp8], models[use_fp8] = trace, tm
    np.testing.assert_allclose(out[True], jtrace, rtol=1e-4)
    assert out[True][-1] < out[True][0]
    for a, b in zip(out[False], out[True]):
        assert abs(a - b) < 0.15 * abs(a) + 0.05, (out[False], out[True])
    meta = models[True].model.layers[0].self_attn.fp8_meta["qkv"]
    assert int((meta.amax_x > 0).sum()) == 6
    with pytest.raises(NotImplementedError, match="scan_layers"):
        LlamaForCausalLM(LlamaConfig.tiny(fp8=True, scan_layers=True),
                         device="cpu")


def test_fp8_model_refuses_weight_only_quantization():
    """The reference's refusal (``quantization.py`` quantize_llama_weights):
    an fp8-trained model is not quantized in place."""
    from paddle_tpu_torch.quantization import quantize_llama_weights
    m = LlamaForCausalLM(LlamaConfig.tiny(fp8=True), device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        quantize_llama_weights(m)
