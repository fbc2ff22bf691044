"""Quantized serving in the port against the JAX package: the int8 KV
pool's quantize-on-write codes and scales, the plain int8 modes of K3
and K4 against the interpreted Pallas kernels and the XLA paths,
weight-only int8/int4 (``QuantizedWeight``, ``QuantizedExpertStack``,
``quantize_for_serving``, smoothing, the quality probe), the bytes model
at the stored types, and the two repairs of the attention and norm
dispatch (``scaled_dot_product_attention`` routing, ``fused_rms_norm``
without a weight).

Same inputs on both sides, made with numpy from a seed; fp32 unless a
case says bf16. The specs are the reference's own tests
(``tests/test_serving_quant.py``).
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import paged as JP
from paddle_tpu.observability import roofline as JR
from paddle_tpu.ops import fused_rms_norm as j_fused_rms_norm
from paddle_tpu.ops.attention import scaled_dot_product_attention as j_sdpa
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.quantization import weight_quantize as j_weight_quantize
from paddle_tpu.serving import quant as JQ
from paddle_tpu_torch.models import paged as TP
from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.ops import fused_rms_norm, scaled_dot_product_attention
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.quantization import QuantizedWeight, weight_quantize
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import quant as TQ
from paddle_tpu_torch.serving.kv import cache_block_bytes
from tests.test_torch_common import F32_TOL, moe_pair, tiny_pair, to_np

# the reference's own bound for the dequantizing attention paths
DEQ_TOL = 2e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------ int8 KV: codes, scales
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_codes_and_scales_are_the_references(dtype):
    """Quantize-on-write gives the reference's codes and scales bit for
    bit, from fp32 and from bf16 K/V (with an all-zero padding row)."""
    rs = np.random.RandomState(0)
    x = (3 * rs.randn(3, 5, 2, 16)).astype(np.float32)
    x[1, 2] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = JP._quantize_kv(jx)
    tq, ts = TP._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _quantize_pool(rs, n, bs, h_kv, d):
    f = rs.normal(size=(n, bs, h_kv, d)).astype(np.float32)
    scale = (np.maximum(np.abs(f).max(axis=-1), 1e-8) / 127.0).astype(
        np.float32)
    q = np.clip(np.round(f / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


N, BS, MB = 24, 8, 5


def _int8_pools(rs, hkv, d=16):
    """int8 K/V pools with their scales, and three table rows whose
    unused slots hold the sentinel N."""
    kq, ks = _quantize_pool(rs, N, BS, hkv, d)
    vq, vs = _quantize_pool(rs, N, BS, hkv, d)
    perm = rs.permutation(N)
    tables = np.full((3, MB), N, np.int32)
    tables[0, :5] = perm[:5]
    tables[1, :3] = perm[5:8]
    tables[2, :4] = perm[8:12]
    return kq, ks, vq, vs, tables


CASES = {"mha": (4, 4, None), "gqa": (4, 2, None), "gqa4_window": (8, 2, 5)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_int8_decode_matches_pallas_and_xla(case):
    """K4's plain int8 mode against the interpreted Pallas kernel and the
    reference's XLA path over the same codes and scales (sentinel table
    slots, GQA, a window)."""
    h, hkv, window = CASES[case]
    rs = np.random.RandomState(1)
    kq, ks, vq, vs, tables = _int8_pools(rs, hkv)
    q = rs.randn(3, h, 16).astype(np.float32)
    lens = np.array([37, 9, 26], np.int32)
    args = [jnp.asarray(a) for a in (q, kq, vq, tables, lens)]
    sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = JPA.paged_decode_attention_pallas(*args, window=window,
                                             interpret=True, **sc)
    xla = JPA.paged_decode_attention_xla(*args, window=window, **sc)
    got = TPA.paged_decode_attention(
        *(_t(a) for a in (q, kq, vq, tables, lens)), window=window,
        k_scale=_t(ks), v_scale=_t(vs))
    for ref in (want, xla):
        np.testing.assert_allclose(to_np(got), to_np(ref), rtol=0,
                                   atol=DEQ_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_int8_chunk_matches_pallas_and_xla(case):
    """K3's plain int8 mode against the interpreted Pallas kernel and the
    XLA path on the live chunk rows (a dead row included)."""
    h, hkv, window = CASES[case]
    rs = np.random.RandomState(2)
    kq, ks, vq, vs, tables = _int8_pools(rs, hkv)
    q = rs.randn(3, 6, h, 16).astype(np.float32)
    offs = np.array([31, 17, 0], np.int32)
    cls = np.array([6, 4, 0], np.int32)
    args = [jnp.asarray(a) for a in (q, kq, vq, tables, offs, cls)]
    sc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = JPA.paged_chunk_attention_pallas(*args, window=window,
                                            interpret=True, **sc)
    xla = JPA.paged_chunk_attention_xla(*args, window=window, **sc)
    got = TPA.paged_chunk_attention(
        *(_t(a) for a in (q, kq, vq, tables, offs, cls)), window=window,
        k_scale=_t(ks), v_scale=_t(vs))
    for ref in (want, xla):
        for i, c in enumerate(cls):
            np.testing.assert_allclose(to_np(got)[i, :c], to_np(ref)[i, :c],
                                       rtol=0, atol=DEQ_TOL)


def test_int8_mode_checks_its_arguments():
    """Scales need int8 pools and both scale pools, of [N, bs, Hkv] fp32;
    partials, once refused here, run over int8 pools too: with every
    live entry owned the triple normalises to the output."""
    rs = np.random.RandomState(3)
    kq, ks, vq, vs, tables = _int8_pools(rs, 2, d=64)
    q = _t(rs.randn(3, 4, 64).astype(np.float32))
    lens = _t(np.array([5, 5, 5], np.int32))
    sc = dict(k_scale=_t(ks), v_scale=_t(vs))
    acc, m, l = TPA.paged_decode_attention(q, _t(kq), _t(vq), _t(tables),
                                           lens, partials=True, **sc)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    want = TPA.paged_decode_attention(q, _t(kq), _t(vq), _t(tables), lens,
                                      **sc)
    np.testing.assert_allclose(to_np(acc / l[..., None]), to_np(want),
                               **F32_TOL)
    # the argument checks are the card route's; the plain route computes
    with pytest.raises(TypeError):
        TPA._check_pool(q, _t(kq).float(), _t(vq).float(), _t(ks), _t(vs),
                        "decode")
    with pytest.raises(ValueError):
        TPA._check_pool(q, _t(kq), _t(vq), _t(ks)[:, :4], _t(vs), "decode")
    assert TPA._check_pool(q, _t(kq), _t(vq), _t(ks), _t(vs),
                           "decode") == (N, BS, 2)


# ---------------------------------------------------------- cache init

def test_cache_init_int8_geometry():
    c = TP.PagedKVCache.init(2, 8, 4, 2, 16, 3, 4, torch.float32,
                             kv_dtype="int8", device="cpu")
    assert all(p.dtype == torch.int8 for p in (*c.k_pools, *c.v_pools))
    assert len(c.k_scales) == 2 and len(c.v_scales) == 2
    # one fp32 scale per (block, position, kv-head), plus the sink block
    assert c.k_scales[0].shape == (8, 4, 2)
    assert c.k_scale_store[0].shape == (9, 4, 2)
    assert c.k_scales[0].dtype == torch.float32
    bf = TP.PagedKVCache.init(2, 8, 4, 2, 16, 3, 4, torch.float32,
                              device="cpu")
    assert not bf.k_scales and not bf.k_scale_store


def test_cache_init_rejects_unsupported_kv_dtype():
    with pytest.raises(ValueError):
        TP.PagedKVCache.init(2, 8, 4, 2, 16, 3, 4, torch.float32,
                             kv_dtype="int4", device="cpu")


def test_cache_block_bytes_counts_the_stored_types():
    """At head_dim 64 the int8 pool (1 B codes + 4 B per-head scale) is
    ~0.53x the bf16 pool, as the reference's bytes count says."""
    bf16 = TP.PagedKVCache.init(2, 8, 16, 2, 64, 3, 4, torch.bfloat16,
                                device="cpu")
    int8 = TP.PagedKVCache.init(2, 8, 16, 2, 64, 3, 4, torch.bfloat16,
                                kv_dtype="int8", device="cpu")
    assert cache_block_bytes(bf16) == 2 * 2 * 16 * 2 * 64 * 2
    assert cache_block_bytes(int8) == 2 * 2 * 16 * 2 * (64 + 4)
    assert cache_block_bytes(int8) / cache_block_bytes(bf16) <= 0.55


# ------------------------------------------------- weight-only int8/int4

@pytest.mark.parametrize("algo,k", [("weight_only_int8", 12),
                                    ("weight_only_int4", 12),
                                    ("weight_only_int4", 7)])
def test_weight_codes_and_scales_are_the_references(algo, k):
    rs = np.random.RandomState(4)
    w = rs.randn(k, 9).astype(np.float32)
    w[:, 3] = 0.0                                # an all-zero channel
    want = j_weight_quantize(jnp.asarray(w), algo)
    got = weight_quantize(_t(w), algo)
    assert got.bits == want.bits and got.shape == want.shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.unpack().numpy(),
                                  np.asarray(want.unpack()))
    np.testing.assert_array_equal(to_np(got.dequantize()),
                                  to_np(want.dequantize()))


@pytest.mark.parametrize("algo,k", [("weight_only_int8", 8),
                                    ("weight_only_int4", 8),
                                    ("weight_only_int4", 5)])
def test_expert_stack_codes_and_scales_are_the_references(algo, k):
    rs = np.random.RandomState(5)
    w = rs.randn(3, k, 8).astype(np.float32)
    want = JQ.expert_stack_quantize(jnp.asarray(w), algo)
    got = TQ.expert_stack_quantize(_t(w), algo)
    assert got.shape == want.shape and got.q.shape == want.q.shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(to_np(got.dequantize()),
                                  to_np(want.dequantize()))


def test_expert_stack_int4_odd_k_roundtrip():
    rs = np.random.RandomState(19)
    w = torch.as_tensor(rs.normal(size=(3, 5, 8)).astype(np.float32))
    qs = TQ.expert_stack_quantize(w, "weight_only_int4")
    assert qs.bits == 4 and tuple(qs.q.shape) == (3, 3, 8)   # packed K
    err = float((qs.dequantize() - w).abs().max())
    assert err < float(w.abs().max()) / 7 + 1e-6             # 4-bit grid


def _pair(family, seed=0):
    if family == "llama":
        jm, tm = tiny_pair(seed, num_hidden_layers=2)
        return jm, tm, 256
    return moe_pair(family, seed)


@pytest.mark.parametrize("family,algo,smooth", [
    ("llama", "weight_only_int8", False),
    ("llama", "weight_only_int4", False),
    ("llama", "weight_only_int8", True),
    ("mixtral", "weight_only_int8", False),
    ("mixtral", "weight_only_int4", True)])
def test_quantized_logits_match_reference(family, algo, smooth):
    """The same weights quantized on both sides give the same codes, so
    the logits of the quantized models agree to fp32 rounding."""
    jm, tm, vocab = _pair(family)
    ids = np.random.RandomState(6).randint(0, vocab, (2, 9))
    jq = JQ.quantize_for_serving(jm, algo, smooth=smooth)
    tq = TQ.quantize_for_serving(tm, algo, smooth=smooth)
    assert tq is tm and tq._wo_bits == jq._wo_bits
    np.testing.assert_allclose(to_np(tq(_t(ids))), to_np(jq(jnp.asarray(ids))),
                               **F32_TOL)


def test_weight_only_roundtrip_and_quality():
    _, model = tiny_pair(0)
    ids = _t(np.random.RandomState(15).randint(1, 256, size=(2, 10)))
    ref = model(ids)
    m8 = TQ.quantize_for_serving(copy.deepcopy(model), "weight_only_int8")
    m4 = TQ.quantize_for_serving(copy.deepcopy(model), "weight_only_int4")
    assert m8._wo_bits == 8 and m4._wo_bits == 4
    att = m8.model.layers[0].self_attn
    assert isinstance(att.qkv_proj, QuantizedWeight)
    assert "qkv_proj" not in dict(att.named_parameters())
    assert "qkv_proj.q" in att.state_dict()
    q8 = TQ.quant_quality(ref, m8(ids))
    q4 = TQ.quant_quality(ref, m4(ids))
    assert q8["logit_mse"] < q4["logit_mse"]       # int8 strictly tighter
    assert q8["greedy_match_rate"] >= 0.9
    assert METRICS.get("serving_quant_logit_mse").value() == \
        q4["logit_mse"]
    assert METRICS.get("serving_quant_weight_bits").value() == 4
    # int8: one byte a parameter plus a 4-byte scale per out channel
    projs = [w for n, w in model.named_parameters()
             if n.endswith(("_proj", "lm_head"))]
    assert TQ.quantized_weight_bytes(m8) == sum(w.numel() + 4 * w.shape[1]
                                                for w in projs)
    assert TQ.quantized_weight_bytes(m4) == sum(w.numel() // 2
                                                + 4 * w.shape[1]
                                                for w in projs)


def test_weights_kill_switch_identity(monkeypatch):
    _, model = tiny_pair(0)
    monkeypatch.setenv("PT_QUANT_WEIGHTS", "0")
    assert not TQ.weights_quant_enabled()
    m = TQ.quantize_for_serving(copy.deepcopy(model), "weight_only_int8")
    assert getattr(m, "_wo_bits", None) is None
    assert not isinstance(m.model.layers[0].self_attn.qkv_proj,
                          QuantizedWeight)


@pytest.mark.parametrize("family", ["llama", "mixtral", "qwen2_moe"])
def test_smooth_fold_is_function_preserving(family):
    """Weight-balancing smoothing leaves the function unchanged (router
    and shared expert folded with the experts); the reference's fold of
    the same weights gives the same logits. Calibrated smoothing
    (``calib_ids``) smooths the dense family by the measured activation
    absmax, the function kept and the folded weights the reference's; the
    MoE families raise as the reference's does."""
    jm, tm, vocab = _pair(family)
    ids = np.random.RandomState(17).randint(1, vocab, size=(2, 10))
    ref = to_np(tm(_t(ids)))
    sm = TQ.smooth_for_serving(copy.deepcopy(tm))
    np.testing.assert_allclose(to_np(sm(_t(ids))), ref, rtol=0, atol=1e-4)
    if family != "qwen2_moe":      # the reference cannot fold this block
        jsm = JQ.smooth_for_serving(copy.deepcopy(jm))
        np.testing.assert_allclose(to_np(sm(_t(ids))),
                                   to_np(jsm(jnp.asarray(ids))), **F32_TOL)
    if family != "llama":
        with pytest.raises(NotImplementedError, match="calib_ids"):
            TQ.smooth_for_serving(copy.deepcopy(tm), calib_ids=_t(ids))
        return
    cal = TQ.smooth_for_serving(copy.deepcopy(tm), calib_ids=_t(ids))
    np.testing.assert_allclose(to_np(cal(_t(ids))), ref, rtol=0, atol=1e-4)
    jcal = JQ.smooth_for_serving(copy.deepcopy(jm),
                                 calib_ids=jnp.asarray(ids))
    for name, w in jcal.state_dict().items():
        np.testing.assert_allclose(
            to_np(cal.get_parameter(name)), np.asarray(w), rtol=1e-5,
            atol=1e-6, err_msg=name)


def test_quantize_moe_expert_stacks():
    """Mixtral's expert stacks become QuantizedExpertStacks (the fp32
    router stays), the model tracks the unquantized one, and it serves
    through the paged engine over an int8 KV pool."""
    _, mm, vocab = moe_pair("mixtral", 3)
    rs = np.random.RandomState(18)
    ids = _t(rs.randint(0, vocab, size=(2, 8)))
    ref = mm(ids)
    mq = TQ.quantize_for_serving(copy.deepcopy(mm), "weight_only_int8",
                                 smooth=True)
    ex = mq.layers[0].moe.experts
    assert isinstance(ex.gate_up, TQ.QuantizedExpertStack)
    assert ex.gate_up.q.dtype == torch.int8
    assert mq.layers[0].moe.gate_w.dtype == torch.float32    # router: never
    assert TQ.quant_quality(ref, mq(ids))["greedy_match_rate"] >= 0.75
    eng = LLMEngine(mq, num_slots=4, block_size=4, max_prompt_len=16,
                    max_seq_len=48, kv_dtype="int8", device="cpu")
    ids = [eng.add_request(Request(rs.randint(1, vocab, (n,)),
                                   max_new_tokens=8)) for n in (4, 9, 13)]
    eng.run()
    eng.assert_quiescent()
    assert all(len(eng.requests[i].tokens) == 8 for i in ids)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_gptq_refuses_by_name(family):
    """GPTQ for serving quantizes the dense family (every projection and
    the untied head a QuantizedWeight of the algo's bits) and refuses an
    MoE model by name, leaving it untouched, as the reference does."""
    _, tm, vocab = _pair(family)
    calib = torch.as_tensor(np.random.RandomState(16).randint(
        1, vocab, size=(2, 12)))
    for algo, bits in (("gptq_int8", 8), ("gptq_int4", 4)):
        if family == "llama":
            m = TQ.quantize_for_serving(copy.deepcopy(tm), algo,
                                        calib_ids=calib)
            assert m._wo_bits == bits
            for w in (m.model.layers[0].self_attn.qkv_proj,
                      m.model.layers[1].mlp.down_proj, m.lm_head):
                assert isinstance(w, QuantizedWeight) and w.bits == bits
            continue
        with pytest.raises(NotImplementedError, match="dense Llama-family"):
            TQ.quantize_for_serving(tm, algo, calib_ids=calib)
    assert not isinstance(tm.lm_head, QuantizedWeight)   # left untouched


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cache_block_bytes_match_reference_bytes_model(kv_dtype):
    """One block's bytes are the reference's bytes model of a position
    (``roofline.kv_bytes_per_position`` at the stored types) times the
    block size."""
    layers, bs, h_kv, d = 2, 16, 2, 64
    cache = TP.PagedKVCache.init(layers, 8, bs, h_kv, d, 3, 4,
                                 torch.bfloat16, kv_dtype=kv_dtype,
                                 device="cpu")
    q = dict(kv_dtype_bytes=1, kv_scale_bytes=4) if kv_dtype else {}
    geom = JR.ModelGeometry(num_layers=layers, hidden=128, intermediate=256,
                            vocab=64, heads=2, kv_heads=h_kv, head_dim=d,
                            dtype_bytes=2, **q)
    assert cache_block_bytes(cache) == bs * JR.kv_bytes_per_position(geom)


# ------------------------------------------- repairs: sdpa, fused norm

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("per_row", [False, True], ids=["h", "bh"])
def test_sdpa_with_alibi_matches_reference(causal, per_row):
    """ALiBi goes to the flash kernel (its plain version on the CPU, the
    bias K2 adds on the card) and agrees with the reference's attention;
    no gradient reaches the slopes."""
    rs = np.random.RandomState(20)
    q, k, v = (rs.randn(2, 8, 4, 16).astype(np.float32) for _ in range(3))
    slopes = (rs.rand(2, 4) if per_row else rs.rand(4)).astype(np.float32)
    want = j_sdpa(*(jnp.asarray(a) for a in (q, k, v)), is_causal=causal,
                  alibi_slopes=jnp.asarray(slopes))
    ts = _t(slopes).requires_grad_()
    tq = _t(q).requires_grad_()
    got = scaled_dot_product_attention(tq, _t(k), _t(v), is_causal=causal,
                                       alibi_slopes=ts)
    np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL)
    got.sum().backward()
    assert ts.grad is None and tq.grad is not None


def test_sdpa_windowed_decode_with_kv_lens_matches_reference():
    """A window with kv_lens and Sq != Sk (decode against a padded cache)
    takes the eager path: query rows end-aligned to each row's length."""
    rs = np.random.RandomState(21)
    q = rs.randn(2, 1, 4, 16).astype(np.float32)
    k, v = (rs.randn(2, 12, 2, 16).astype(np.float32) for _ in range(2))
    lens = np.array([12, 7], np.int32)
    want = j_sdpa(*(jnp.asarray(a) for a in (q, k, v)), is_causal=True,
                  window=4, kv_lens=jnp.asarray(lens))
    got = scaled_dot_product_attention(*(_t(a) for a in (q, k, v)),
                                       is_causal=True, window=4,
                                       kv_lens=_t(lens))
    np.testing.assert_allclose(to_np(got), to_np(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rms_norm_without_weight_matches_reference(dtype):
    x = np.random.RandomState(22).randn(3, 5, 64).astype(np.float32)
    want = j_fused_rms_norm(jnp.asarray(x, getattr(jnp, dtype)),
                            epsilon=1e-5)
    got = fused_rms_norm(_t(x).to(getattr(torch, dtype)), epsilon=1e-5)
    assert got.dtype == getattr(torch, dtype)
    # bf16: one cast of the fp32 result on both sides, so at most one
    # bf16 step apart where the fp32 sums round differently
    tol = F32_TOL if dtype == "float32" else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)
