"""GPTQ and calibrated smoothing in the port against the JAX package.

``quantization.gptq_quantize`` on a CPU tensor is the reference's float64
loop: its codes and scales equal the reference's bit for bit (int8 and
int4, an odd in-dim included) and it beats round-to-nearest on the
calibration set. ``quantize_llama_weights`` calibrates every projection
from one capture forward (``_capture_calib``, which honours a sliding
window) and the GPTQ models generate the JAX models' greedy tokens;
``serving.quant.quantize_for_serving("gptq_int4", calib_ids=...)`` serves
the JAX engine's streams; calibrated smoothing keeps the function (within
1e-4) and folds the reference's weights; MoE models are refused as the
reference refuses them. Ports ``tests/test_weight_only.py`` (:43, :107)
and ``tests/test_serving_quant.py`` (:458-510). fp32 on the CPU.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import quantization as JQW
from paddle_tpu.models.decoding import generate as jgenerate
from paddle_tpu.models.mistral import MistralConfig as JMistralConfig
from paddle_tpu.models.mistral import MistralForCausalLM as JMistral
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import quant as JQ
from paddle_tpu_torch import quantization as TQW
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.decoding import generate
from paddle_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from paddle_tpu_torch.quantization import QuantizedWeight
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import quant as TQ
from tests.test_torch_common import F32_TOL, moe_pair, tiny_pair, to_np

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _codes(qw):
    """(int8 codes [K, N], fp32 scale [1, N]) of a QuantizedWeight of
    either package."""
    return np.asarray(to_np(qw.unpack())), np.asarray(to_np(qw.scale))


@pytest.mark.parametrize("bits,k", [(8, 48), (4, 48), (4, 33)])
def test_gptq_codes_and_scales_are_the_references(bits, k):
    """Seeded [K, N] weights and correlated [M, K] activations: the same
    packed codes and scales as the reference's gptq_quantize."""
    rs = np.random.RandomState(bits * 100 + k)
    x = (rs.randn(256, 6) @ rs.randn(6, k) + 0.1 * rs.randn(256, k))
    w = rs.randn(k, 24).astype(np.float32)
    x = x.astype(np.float32)
    got = TQW.gptq_quantize(_t(w), _t(x), bits=bits)
    want = JQW.gptq_quantize(jnp.asarray(w), jnp.asarray(x), bits=bits)
    assert got.bits == bits and got.k == k and got.q.is_contiguous()
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # the same packing and scales as round-to-nearest
    rtn = TQW.weight_quantize(_t(w), f"weight_only_int{bits}")
    assert got.q.shape == rtn.q.shape
    np.testing.assert_array_equal(got.scale.numpy(), rtn.scale.numpy())


def test_gptq_beats_rtn_on_calibration():
    """Error feedback beats round-to-nearest on the calibration
    distribution (correlated features make the difference visible)."""
    rs = np.random.RandomState(2)
    m, k, n = 512, 64, 32
    x = rs.randn(m, 8) @ rs.randn(8, k) + 0.1 * rs.randn(m, k)
    w = rs.randn(k, n)
    xt, wt = _t(x.astype(np.float32)), _t(w.astype(np.float32))
    ref = xt @ wt
    rtn = TQW.weight_quantize(wt, "weight_only_int4")
    gptq = TQW.gptq_quantize(wt, xt, bits=4)
    err_rtn = float(((TQW.weight_only_linear(xt, rtn) - ref) ** 2).mean())
    err_gptq = float(((TQW.weight_only_linear(xt, gptq) - ref) ** 2).mean())
    assert err_gptq < err_rtn, (err_gptq, err_rtn)


@pytest.mark.parametrize("algo", ["gptq_int4", "gptq_int8"])
def test_llama_gptq_generates_the_references_tokens(algo):
    """quantize_llama_weights(gptq) on the same weights and calibration
    ids: the codes and scales of every projection are the reference's,
    and the greedy tokens and logits follow the JAX model's."""
    jm, tm = tiny_pair(**TINY)
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 64, (2, 12))
    timings = {}
    TQW.quantize_llama_weights(tm, algo, calib_ids=_t(ids), timings=timings)
    JQW.quantize_llama_weights(jm, algo, calib_ids=jnp.asarray(ids))
    assert set(timings) == {"capture", "hessian", "recursion"}
    for li in range(2):
        for owner, name in (("self_attn", "qkv_proj"), ("self_attn",
                                                         "o_proj"),
                            ("mlp", "gate_up_proj"), ("mlp", "down_proj")):
            got = getattr(getattr(tm.model.layers[li], owner), name)
            want = getattr(getattr(jm.model.layers[li], owner), name)
            assert isinstance(got, QuantizedWeight)
            for a, b in zip(_codes(got), _codes(want)):
                np.testing.assert_array_equal(a, b, err_msg=f"{li} {name}")
    for a, b in zip(_codes(tm.lm_head), _codes(jm.lm_head)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(to_np(tm(_t(ids))), to_np(jm(jnp.asarray(
        ids))), **F32_TOL)
    np.testing.assert_array_equal(
        to_np(generate(tm, ids, 6)).astype(np.int64),
        np.asarray(jgenerate(jm, jnp.asarray(ids), max_new_tokens=6)))


def test_gptq_for_serving_streams_match_reference():
    """quantize_for_serving("gptq_int4", calib_ids=...) on both sides, then
    the engines' greedy streams token for token."""
    jm, tm = tiny_pair(**TINY)
    rs = np.random.RandomState(16)
    calib = rs.randint(1, 64, size=(2, 12))
    tq = TQ.quantize_for_serving(tm, "gptq_int4", calib_ids=_t(calib))
    jq = JQ.quantize_for_serving(jm, "gptq_int4",
                                 calib_ids=jnp.asarray(calib))
    assert tq._wo_bits == jq._wo_bits == 4
    assert isinstance(tq.model.layers[0].self_attn.qkv_proj, QuantizedWeight)
    assert TQ.quantized_weight_bytes(tq) == JQ.quantized_weight_bytes(jq)
    prompts = [rs.randint(1, 64, n) for n in (5, 9, 3, 14)]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=32)
    out = []
    for eng, req in ((LLMEngine(tq, device="cpu", **kw), Request),
                     (JEngine(jq, **kw), JRequest)):
        rids = [eng.add_request(req(p, max_new_tokens=6)) for p in prompts]
        eng.run()
        eng.assert_quiescent()
        out.append([list(map(int, eng.requests[i].tokens)) for i in rids])
    assert out[0] == out[1]
    assert all(len(t) == 6 for t in out[0])


def test_calibrated_smoothing_keeps_function_and_is_the_references():
    """smooth_for_serving(calib_ids=...): the function within 1e-4, every
    folded weight the reference's; then quantized on top (smooth=True) it
    tracks the unsmoothed model."""
    jm, tm = tiny_pair(**TINY)
    ids = np.random.RandomState(17).randint(1, 64, size=(2, 10))
    ref = to_np(tm(_t(ids)))
    sm = TQ.smooth_for_serving(copy.deepcopy(tm), calib_ids=_t(ids))
    assert sm._smoothed
    np.testing.assert_allclose(to_np(sm(_t(ids))), ref, rtol=0, atol=1e-4)
    jsm = JQ.smooth_for_serving(copy.deepcopy(jm),
                                calib_ids=jnp.asarray(ids))
    for name, w in jsm.state_dict().items():
        np.testing.assert_allclose(to_np(sm.get_parameter(name)),
                                   np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    q = TQ.quantize_for_serving(copy.deepcopy(tm), "weight_only_int8",
                                smooth=True, calib_ids=_t(ids))
    assert TQ.quant_quality(ref, q(_t(ids)))["greedy_match_rate"] >= 0.9


@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_gptq_and_calibrated_smoothing_refuse_moe(family):
    """An MoE model is refused by GPTQ and by calibrated smoothing (the
    capture forward is the dense family's), with nothing changed."""
    _, mm, vocab = moe_pair(family, 4)
    before = {n: p.clone() for n, p in mm.named_parameters()}
    calib = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dense Llama-family"):
        TQ.quantize_for_serving(mm, "gptq_int8", calib_ids=calib)
    with pytest.raises(NotImplementedError, match="calib_ids"):
        TQ.smooth_for_serving(mm, calib_ids=calib)
    assert all(torch.equal(p, before[n]) for n, p in mm.named_parameters())


def test_capture_honours_the_sliding_window():
    """Mistral with a window shorter than the calibration rows: every
    record of the capture forward equals the reference's, and the
    attention records differ from a capture without the window."""
    kw = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=64, sliding_window=4)
    pt.seed(0)
    jm = JMistral(JMistralConfig.tiny(**kw))
    tm = MistralForCausalLM(MistralConfig.tiny(**kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    ids = np.random.RandomState(8).randint(0, 64, (2, 12))
    got = TQW._capture_calib(tm, _t(ids))
    want = JQW._capture_calib(jm, jnp.asarray(ids))
    for li, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == torch.float32
            np.testing.assert_allclose(to_np(g[key]), w[key], **F32_TOL,
                                       err_msg=f"layer {li} {key}")
    full = copy.deepcopy(tm)
    for lyr in full.model.layers:
        lyr.self_attn.window = None
    assert not np.allclose(to_np(TQW._capture_calib(full, _t(ids))[0]["o"]),
                           to_np(got[0]["o"]))
