"""float16 parity: the port's plain versions, models and loss scaler at
float16 against the JAX package run at ``jnp.float16`` on the CPU (the
Pallas kernels in interpret mode, as the reference's own tests run them),
on the same numpy inputs and, for the models, the same weights
(``models.convert.load_jax_state_dict``).

Tolerances, all |port - reference| <= tol * (1 + |reference|), stated
against float16's step of 2**-11 relative:
  * K1 and K7 (one fp32 computation, one rounding to float16 on each
    side; the sums of squares in another order): 2e-3, four steps.
  * K2, K3, K4 forward (the probabilities rounded to float16 before P V
    at different places): 1e-2.
  * K2 backward, K6a / K6b (float16 products of 16-80 terms; the Pallas
    dq kernel rounds dS to float16 where the plain version keeps fp32):
    2e-2, bf16's card tolerance, which float16 meets with room.
  * the tiny Llama (two layers) and MoE (one) (float16 rounding after
    every op, in another order on each side): logits 2e-2, the loss 1e-2
    relative, each gradient within 5e-2 of its largest element.
Padded query rows (past kv_lens), rows with no live key and a chunk's
padding rows are left out of the comparison, where the reference leaves
them unspecified (the parity rule of ``test_torch_kernels.py``); a row
with no live key has a log-sum-exp of exactly 0 in the port, which the
backward reads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.core.module import value_and_grad
from paddle_tpu.models import qwen2_moe as jqwen
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.ops.pallas import flash_attention as JF
from paddle_tpu.ops.pallas import norms as JN
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.ops.pallas.grouped_matmul import grouped_matmul as j_gmm
from paddle_tpu.ops.pallas.rope import fused_rope as j_rope
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import qwen2_moe as tqwen
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.cuda import flash_attention as TF
from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
from paddle_tpu_torch.ops.cuda import norms as TN
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.ops.cuda import rope as TR
from tests.test_torch_common import to_np

F16 = jnp.float16


def _pair(*arrays):
    """Each numpy array as (float16 torch tensor, float16 jax array) of the
    same float16 values."""
    out = []
    for a in arrays:
        h = np.asarray(a, np.float16)
        out.append((torch.from_numpy(h.copy()), jnp.asarray(h)))
    return out


def _close(got, want, tol, mask=None):
    g, w = to_np(got), to_np(want)
    if mask is not None:
        g, w = g[mask], w[mask]
    err = np.abs(g - w) / (1 + np.abs(w))
    assert float(err.max()) <= tol, float(err.max())


def _rs(seed):
    return np.random.RandomState(seed)


# ------------------------------------------------------------- K1, K7
@pytest.mark.parametrize("wdt", ["f16", "f32"])
def test_rms_norm_float16(wdt):
    """K1's plain version at float16 x under a float16 weight and under an
    fp32 weight (O1's policy keeps norms in fp32) against the Pallas
    kernel: fp32 math, one rounding to float16."""
    rs = _rs(0)
    (x, jx), = _pair(3 * rs.randn(7, 256))
    w = (1 + 0.1 * rs.randn(256)).astype(np.float32)
    tw = torch.from_numpy(w) if wdt == "f32" else torch.from_numpy(
        w.astype(np.float16))
    got = TN.rms_norm(x, tw, 1e-5)
    want = JN.rms_norm(jx, jnp.asarray(tw.numpy()), 1e-5, True)
    assert got.dtype == torch.float16
    _close(got, want, 2e-3)


def test_rope_float16():
    rs = _rs(1)
    (x, jx), = _pair(rs.randn(2, 16, 4, 64))
    ang = rs.rand(16, 32).astype(np.float32) * 20
    c, s = np.cos(ang), np.sin(ang)
    got = TR.fused_rope(x, torch.from_numpy(c), torch.from_numpy(s))
    want = j_rope(jx, jnp.asarray(c), jnp.asarray(s), interpret=True)
    assert got.dtype == torch.float16
    _close(got, want, 2e-3)


# ---------------------------------------------------------------- K2
def test_flash_forward_and_backward_float16():
    """K2 (causal, GQA 4/2, kv_lens with a padded row) and K5 through
    ``jax.grad`` of the interpreted Pallas kernels at float16; padded query
    rows get a zero cotangent, as callers give them."""
    rs = _rs(2)
    b, s, h, hkv, d = 2, 37, 4, 2, 16
    lens = np.array([37, 20], np.int32)
    live = np.arange(s)[None, :] < lens[:, None]
    g = rs.randn(b, s, h, d) * live[:, :, None, None]
    (q, jq), (k, jk), (v, jv), (gt, jg) = _pair(
        rs.randn(b, s, h, d), rs.randn(b, s, hkv, d), rs.randn(b, s, hkv, d),
        g)

    def jf(q, k, v):
        return JF.flash_attention(q, k, v, causal=True,
                                  kv_lens=jnp.asarray(lens), block_q=8,
                                  block_k=8, interpret=True)
    # one compiled program: the output and the gradients
    want, want_g = jax.jit(lambda *a: (jf(*a), jax.grad(lambda *b: jnp.sum(
        jf(*b).astype(jnp.float32) * jg.astype(jnp.float32)),
        argnums=(0, 1, 2))(*a)))(jq, jk, jv)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    got = TF.flash_attention(qt, kt, vt, causal=True,
                             kv_lens=torch.from_numpy(lens))
    assert got.dtype == torch.float16
    _close(got, want, 1e-2, live)
    (got.float() * gt.float()).sum().backward()
    for a, r in zip((qt.grad, kt.grad, vt.grad), want_g):
        assert a.dtype == torch.float16
        _close(a, r, 2e-2)


def test_flash_rows_without_a_live_key_float16():
    """Five query rows end-aligned to 70 keys with kv_lens 3: the rows
    past it have no live key; the reference leaves them unspecified, the
    port's LSE is 0 there; the live rows match the reference."""
    rs = _rs(3)
    b, s, sk, h, d = 2, 5, 70, 4, 16
    lens = np.array([70, 3], np.int32)
    (q, jq), (k, jk), (v, jv) = _pair(rs.randn(b, s, h, d),
                                      rs.randn(b, sk, h, d),
                                      rs.randn(b, sk, h, d))
    want = JF.flash_attention(jq, jk, jv, causal=True,
                              kv_lens=jnp.asarray(lens), block_q=8,
                              block_k=8, interpret=True)
    got, lse = TF.flash_attention_fwd_plain(q, k, v, causal=True,
                                            kv_lens=torch.from_numpy(lens))
    live = (lens[:, None] - s + np.arange(s)[None, :] >= 0) & (lens[:, None]
                                                              > 0)
    assert (~live).any()
    _close(got, want, 1e-2, live)
    assert not to_np(lse).transpose(0, 2, 1)[~live].any()


# ------------------------------------------------------------- K3, K4
def _pools(rs, hkv, d=16):
    nb, bs = 8, 8
    kp, vp = rs.randn(nb, bs, hkv, d), rs.randn(nb, bs, hkv, d)
    tables = np.full((3, 4), nb, np.int32)
    perm = rs.permutation(nb)
    tables[0, :3], tables[1, :2], tables[2, :2] = perm[:3], perm[3:5], \
        perm[5:7]
    return kp, vp, tables


def test_paged_kernels_float16():
    """K3 (a dead row: chunk length 0, left out) and K4 over float16 pools
    against the interpreted Pallas kernels at float16."""
    rs = _rs(4)
    kp, vp, tables = _pools(rs, 2)
    (tk, jk), (tv, jv), (qc, jqc), (qd, jqd) = _pair(
        kp, vp, rs.randn(3, 8, 4, 16), rs.randn(3, 4, 16))
    offs = np.array([0, 5, 9], np.int32)
    cls = np.array([8, 3, 0], np.int32)
    want = JPA.paged_chunk_attention_pallas(
        jqc, jk, jv, jnp.asarray(tables), jnp.asarray(offs),
        jnp.asarray(cls), interpret=True)
    got = TPA.paged_chunk_attention(qc, tk, tv, torch.from_numpy(tables),
                                    torch.from_numpy(offs),
                                    torch.from_numpy(cls))
    assert got.dtype == torch.float16
    live = np.arange(8)[None, :] < cls[:, None]
    _close(got, want, 1e-2, live)
    lens = np.array([20, 11, 13], np.int32)
    want = JPA.paged_decode_attention_pallas(
        jqd, jk, jv, jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    got = TPA.paged_decode_attention(qd, tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(lens))
    assert got.dtype == torch.float16
    _close(got, want, 1e-2)


# ------------------------------------------------------------ K6a, K6b
def test_grouped_matmul_forward_and_grads_float16():
    """K6a's forward and K6a / K6b's dlhs and drhs (autograd) against
    ``jax.grad`` through the interpreted Pallas kernels at float16, over
    an empty group, a one-row group and k off the tiles; an empty group's
    drhs is exactly 0."""
    rs = _rs(5)
    sizes = np.array([5, 0, 1, 10], np.int32)
    m, k, n = int(sizes.sum()), 24, 40
    (lhs, jl), (rhs, jr), (cot, jc) = _pair(
        rs.randn(m, k), rs.randn(4, k, n) * k ** -0.5, rs.randn(m, n))
    jgs = jnp.asarray(sizes)

    def f(a, b):
        return j_gmm(a, b, jgs, impl="pallas", interpret=True)
    want, want_g = jax.jit(lambda a, b: (f(a, b), jax.grad(
        lambda x, y: jnp.sum(f(x, y).astype(jnp.float32)
                             * jc.astype(jnp.float32)),
        argnums=(0, 1))(a, b)))(jl, jr)
    tl, tr = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
    got = GM.grouped_matmul(tl, tr, torch.from_numpy(sizes))
    assert got.dtype == torch.float16
    _close(got, want, 2e-2)
    (got.float() * cot.float()).sum().backward()
    _close(tl.grad, want_g[0], 2e-2)
    _close(tr.grad, want_g[1], 2e-2)
    assert float(tr.grad[1].abs().sum()) == 0.0


# --------------------------------------------------------------- models
def _llama_pair():
    pt.seed(0)
    jm = JLlama(JLlamaConfig.tiny(dtype=F16))
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float16),
                          device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm, 256


def _moe_pair():
    # one layer: the MoE block (router, experts, shared expert) once keeps
    # the reference's compile in the suite's budget
    pt.seed(0)
    jm = jqwen.Qwen2MoeForCausalLM(jqwen.Qwen2MoeConfig.tiny(
        num_hidden_layers=1, dtype=F16))
    tm = tqwen.Qwen2MoeForCausalLM(tqwen.Qwen2MoeConfig.tiny(
        num_hidden_layers=1, dtype=torch.float16), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm, 128


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("make", [_llama_pair, _moe_pair],
                         ids=["llama", "qwen2_moe"])
def test_model_logits_loss_and_grads_float16(make):
    """A tiny Llama and a tiny Qwen2-MoE held in float16 on both sides:
    logits, the loss and every gradient (float16 parameters, float16
    gradients) against the reference's ``value_and_grad``."""
    jm, tm, vocab = make()
    assert next(tm.parameters()).dtype == torch.float16
    ids = _rs(6).randint(0, vocab, (2, 24))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    # one compiled program on the JAX side (eager float16 dispatch on the
    # CPU is slow): the loss, the logits as its aux, the gradients
    (jloss, want), jgrads = jax.jit(value_and_grad(
        lambda m, i, lab: (m.loss(i, lab), _logits(m(i))), has_aux=True))(
        jm, jnp.asarray(ids), jnp.asarray(labels))
    got = _logits(tm(torch.as_tensor(ids)))
    assert got.dtype == torch.float16
    assert np.isfinite(to_np(got)).all()
    _close(got, want, 2e-2)
    loss = tm.loss(torch.as_tensor(ids), torch.as_tensor(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-2)
    ref = jgrads.state_dict()
    params = dict(tm.named_parameters())
    assert set(params) == set(ref)
    for name, p in params.items():
        g = np.asarray(ref[name], np.float32)
        assert p.grad.dtype == p.dtype, name
        assert np.abs(to_np(p.grad) - g).max() <= 5e-2 * np.abs(g).max() \
            + 1e-6, name


# ---------------------------------------------------------------- scaler
def test_grad_scaler_on_float16_gradients_matches_reference():
    """The tiny Llama's float16 gradients, scaled as a float16 backward
    would carry them (the product rounded to float16: inf past 65504),
    through both scalers step by step from 2**20 (decrease on every
    overflow, increase after two good steps): found_inf, scale,
    good_steps and bad_steps equal the reference's at every step, and a
    skipped step (step_or_skip) leaves every parameter's bits unchanged."""
    _, tm, vocab = _llama_pair()
    ids = _rs(7).randint(0, vocab, (2, 16))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    tm.loss(torch.as_tensor(ids), torch.as_tensor(labels)).backward()
    base = {n: p.grad.float() for n, p in tm.named_parameters()}
    peak = max(float(g.abs().max()) for g in base.values())
    kw = dict(init_loss_scaling=2.0 ** 20, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    sc, jsc = amp.GradScaler(**kw), jamp.GradScaler(**kw)
    st, jst = sc.init("cpu"), jsc.init()
    params = {n: p.detach().clone() for n, p in tm.named_parameters()}
    seen = []
    for _ in range(8):
        scale = float(st["scale"])
        grads = {n: (g * scale).half() for n, g in base.items()}
        jgrads = {n: jnp.asarray(g.numpy()) for n, g in grads.items()}
        g = sc.unscale(grads, st)
        found = sc.found_inf(g)
        jfound = jsc.found_inf(jsc.unscale(jgrads, jst))
        assert bool(found) == bool(jfound)
        new = {n: p - (1e-3 * g[n]).to(p.dtype) for n, p in params.items()}
        kept = sc.step_or_skip(params, new, found)
        if bool(found):
            for n in params:
                assert torch.equal(kept[n], params[n]), n
        params = kept
        st, jst = sc.update(st, found), jsc.update(jst, jfound)
        for key in st:
            assert float(st[key]) == float(jst[key]), key
        seen.append((scale, bool(found)))
    overflowed = [s for s, f in seen if f]
    assert overflowed and overflowed[0] == 2.0 ** 20
    assert any(not f for _, f in seen)          # then steps are taken
    assert all(s * peak > 65504 for s in overflowed)
