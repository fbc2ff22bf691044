"""Each kernel module of the port against the Pallas kernel it replaces.

On the CPU every wrapper runs its plain PyTorch version (a CUDA kernel
has no interpret mode), and the JAX side runs the Pallas kernel in
interpret mode — the same math, so the two agree to fp32 rounding. The
CUDA kernels themselves are held against these plain versions on the
card: ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as JF
from paddle_tpu.ops.pallas import norms as JN
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops import eager_attention, fused_rms_norm
from paddle_tpu_torch.ops.cuda import flash_attention as TF
from paddle_tpu_torch.ops.cuda import norms as TN
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from tests.test_torch_common import to_np

# fp32, same algorithm on both sides (only the reduction order differs)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 256)])
def test_rms_norm_matches_pallas(shape):
    rs = np.random.RandomState(0)
    x = rs.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    want = JN.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, True)
    got = TN.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    np.testing.assert_allclose(to_np(fused_rms_norm(_t(x), _t(w), 1e-5)),
                               to_np(want), **TOL)


def test_rms_norm_bf16_rounds_like_pallas():
    """bf16: the weight multiplies in fp32 and the result is cast once,
    as in the Pallas kernel; equal up to one bf16 rounding step."""
    rs = np.random.RandomState(1)
    x = rs.randn(4, 128).astype(np.float32)
    w = (1 + 0.1 * rs.randn(128)).astype(np.float32)
    want = JN.rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16), 1e-5, True)
    got = TN.rms_norm(_t(x).bfloat16(), _t(w).bfloat16(), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=8e-3, atol=8e-3)


# ------------------------------------------------------------------ K2
def _live_rows(s, sk, lens):
    """[B|1, S] bool: the query rows the comparison holds under causal.
    With kv_lens and s == sk the valid rows (padded rows are unspecified in
    the reference); with s < sk the rows with a live key, positions
    end-aligned to each row's valid length (the reference's _q_offset
    rule; the others are 0 in the kernels)."""
    if lens is None:
        return np.ones((1, s), bool)
    lens = np.asarray(lens)[:, None]
    if s == sk:
        return np.arange(s)[None, :] < lens
    return (lens - s + np.arange(s)[None, :] >= 0) & (lens > 0)


# the edge shapes of the tensor-core kernels' tiles: ragged S, one and
# five query rows end-aligned to 70 keys with kv_lens (some rows of the
# second batch row have no live key), a window smaller than a key tile
FWD_CASES = {"mha": (4, 4, 40, 40, (40, 23), None),
             "gqa": (4, 2, 40, 40, (40, 23), None),
             "ragged": (4, 2, 37, 37, None, None),
             "s1_kv_lens": (4, 2, 1, 70, (70, 9), None),
             "s5_kv_lens": (4, 4, 5, 70, (70, 3), None),
             "window3_gqa4": (4, 1, 37, 37, None, 3)}


@pytest.mark.parametrize("h,hkv,s,sk,kv_lens,window", FWD_CASES.values(),
                         ids=FWD_CASES.keys())
def test_flash_forward_matches_pallas(h, hkv, s, sk, kv_lens, window):
    rs = np.random.RandomState(2)
    b, d = 2, 16
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    if kv_lens is not None:
        kv_lens = np.array(kv_lens, np.int32)
    jl = None if kv_lens is None else jnp.asarray(kv_lens)
    tl = None if kv_lens is None else _t(kv_lens)
    want = JF.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, kv_lens=jl,
                              interpret=True)
    got = TF.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                             kv_lens=tl)
    # padded query rows are unspecified in the reference: live rows only
    live = np.broadcast_to(_live_rows(s, sk, kv_lens), (b, s))
    np.testing.assert_allclose(to_np(got)[live], to_np(want)[live], **TOL)
    if s < sk:     # the LSE the backward reads: 0 on rows with no live key
        _, lse = TF.flash_attention_fwd_plain(_t(q), _t(k), _t(v),
                                              causal=True, kv_lens=tl)
        assert not to_np(lse).transpose(0, 2, 1)[~live].any()


def test_flash_forward_window_matches_pallas():
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 48, 2, 16).astype(np.float32) for _ in range(3))
    want = JF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              causal=True, window=8, block_q=16, block_k=16,
                              interpret=True)
    got = TF.flash_attention(_t(q), _t(k), _t(v), causal=True, window=8)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


# ------------------------------------------------------- K1 backward
@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 256)])
def test_rms_norm_grads_match_pallas(shape):
    """The rms_norm Function's dx and dw (the reference's ``_rms_bwd`` in
    plain PyTorch) against jax.grad through the Pallas kernel's
    custom_vjp, for the same cotangent."""
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    want = jax.grad(lambda x, w: jnp.sum(
        JN.rms_norm(x, w, 1e-5, True) * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    (TN.rms_norm(xt, wt, 1e-5) * _t(g)).sum().backward()
    for got, ref in zip((xt.grad, wt.grad), want):
        np.testing.assert_allclose(to_np(got), to_np(ref), rtol=1e-4,
                                   atol=1e-5)


def test_rms_norm_bf16_grads_keep_types():
    """dx comes back in x's type, dw in the weight's (an fp32 weight
    under a bf16 activation gets an fp32 gradient)."""
    rs = np.random.RandomState(8)
    x = _t(rs.randn(4, 64).astype(np.float32)).bfloat16().requires_grad_()
    w = _t((1 + 0.1 * rs.randn(64)).astype(np.float32)).requires_grad_()
    TN.rms_norm(x, w, 1e-5).float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


def test_forwards_without_a_graph_skip_the_autograd_function():
    """With grad mode off (the serving path) rms_norm and flash_attention
    run their forward alone: no grad_fn, the same values as through the
    autograd Function."""
    rs = np.random.RandomState(11)
    x = _t(rs.randn(6, 64).astype(np.float32)).requires_grad_()
    w = _t((1 + 0.1 * rs.randn(64)).astype(np.float32))
    q, k, v = (_t(rs.randn(2, 12, 2, 16).astype(np.float32)).requires_grad_()
               for _ in range(3))
    lens = _t(np.array([12, 5], np.int32))
    with_graph = (TN.rms_norm(x, w, 1e-5),
                  TF.flash_attention(q, k, v, causal=True, kv_lens=lens))
    with torch.no_grad():
        without = (TN.rms_norm(x, w, 1e-5),
                   TF.flash_attention(q, k, v, causal=True, kv_lens=lens))
    for a, b in zip(with_graph, without):
        assert a.grad_fn is not None and b.grad_fn is None
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)


# ------------------------------------------------------- K2 LSE, K5
def test_flash_forward_lse_matches_logsumexp():
    """The log-sum-exp the forward saves (natural log of the scaled,
    masked scores) against jax.nn.logsumexp, rows with kv_lens included."""
    rs = np.random.RandomState(9)
    b, s, h, hkv, d = 2, 24, 4, 2, 16
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, s, hkv, d).astype(np.float32)
    v = rs.randn(b, s, hkv, d).astype(np.float32)
    lens = np.array([24, 11], np.int32)
    _, lse = TF.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal=True,
                                          kv_lens=_t(lens))
    kr = np.repeat(k, h // hkv, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q, kr) * d ** -0.5
    keep = (np.tril(np.ones((s, s), bool))[None]
            & (np.arange(s)[None, None, :] < lens[:, None, None]))[:, None]
    want = jax.nn.logsumexp(jnp.where(keep, scores, -jnp.inf), axis=-1)
    np.testing.assert_allclose(to_np(lse), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,lens,s,sk", [
    (True, None, None, 40, 40), (False, None, None, 40, 40),
    (True, 6, None, 40, 40), (True, None, (40, 23), 40, 40),
    (False, None, (40, 17), 40, 40), (True, None, None, 37, 37),
    (True, None, (70, 9), 1, 70), (True, None, (70, 3), 5, 70),
    (True, 3, None, 37, 37)],
    ids=["causal", "full", "window", "causal_kv_lens", "full_kv_lens",
         "ragged", "s1_kv_lens", "s5_kv_lens", "window3"])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "gqa4"])
def test_flash_backward_matches_pallas(h, hkv, causal, window, lens, s, sk):
    """flash_attention's backward on CPU tensors (flash_attention_bwd_plain
    from the saved O and LSE) against jax.grad through the Pallas kernels
    in interpret mode. With kv_lens the padded query rows, and the rows
    with no live key (S < Sk end-aligned past a short kv_lens), get a zero
    cotangent, as the reference's callers give them (its
    test_flash_varlen_kv_lens_matches_masked_xla): the reference leaves
    their outputs unspecified."""
    rs = np.random.RandomState(10)
    b, d = 2, 16
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    kw = dict(causal=causal, window=window)
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        g = g * _live_rows(s, sk, lens)[:, :, None, None]
    want = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(
        q, k, v, kv_lens=None if lens is None else jnp.asarray(lens),
        block_q=8, block_k=8, interpret=True, **kw) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = TF.flash_attention(qt, kt, vt, kv_lens=None if lens is None
                             else _t(lens), **kw)
    (out * _t(g)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(to_np(got), to_np(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("hkv,causal,window,lens,s,sk", [
    (2, True, 6, None, 37, 37), (1, True, None, (40, 23), 40, 40),
    (4, True, None, (70, 3), 5, 70), (2, False, None, None, 33, 33)],
    ids=["gqa_window", "gqa4_kv_lens", "s5_dead_rows", "full"])
def test_flash_dq_bf16_matches_pallas(hkv, causal, window, lens, s, sk):
    """In bf16, dq of flash_attention's backward on CPU tensors (the plain
    version, which keeps dS in fp32) against jax.grad through the Pallas
    kernels in interpret mode (whose _dq_kernel rounds dS to bf16 before
    dS K, as the card's tensor-core K5a does): within 2e-2 * (1 + |dq|)
    at head dim 64, S off the tiles, GQA, a window, kv_lens and rows with
    no live key (dq 0 on both sides)."""
    rs = np.random.RandomState(12)
    b, h, d = 2, 4, 64
    q, g = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, sk, hkv, d).astype(np.float32) for _ in range(2))
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        g = g * _live_rows(s, sk, lens)[:, :, None, None]
    jq, jk, jv, jg = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g))
    want = jax.grad(lambda q: jnp.sum(JF.flash_attention(
        q, jk, jv, causal=causal, window=window,
        kv_lens=None if lens is None else jnp.asarray(lens), block_q=8,
        block_k=8, interpret=True).astype(jnp.float32)
        * jg.astype(jnp.float32)))(jq)
    qt, kt, vt, gt = (torch.tensor(np.asarray(a.astype(jnp.float32)))
                      .bfloat16() for a in (jq, jk, jv, jg))
    qt.requires_grad_()
    out = TF.flash_attention(qt, kt, vt, causal=causal, window=window,
                             kv_lens=None if lens is None else _t(lens))
    (out.float() * gt.float()).sum().backward()
    assert qt.grad.dtype == torch.bfloat16
    ref = to_np(want)
    assert np.all(np.abs(to_np(qt.grad) - ref) <= 2e-2 * (1 + np.abs(ref)))
    if lens is not None and s < sk:
        dead = ~np.broadcast_to(_live_rows(s, sk, lens), (b, s))
        assert dead.any() and not to_np(qt.grad)[dead].any()


# head dim 256 (Gemma, GPT-J), causal: h, hkv, S, Pallas block size
HD256_CASES = {"gqa8_1": (8, 1, 48, 16), "mha": (2, 2, 32, 8)}


@pytest.mark.parametrize("h,hkv,s,blk", HD256_CASES.values(),
                         ids=HD256_CASES.keys())
def test_flash_head_dim_256_matches_pallas(h, hkv, s, blk):
    """At head dim 256, GQA 8:1 (Gemma-2B's group) and 1:1 (GPT-J), the
    port's flash_attention on CPU tensors (the plain forward, and the plain
    backward from the saved O and LSE) against the Pallas flash_attention
    in interpret mode (forward, and jax.grad through _dq_kernel /
    _dkv_kernel) with blocks of 8-16 rows, in fp32; the LSE against
    logsumexp of the masked scores."""
    rs = np.random.RandomState(16)
    b, d = 1, 256
    q, g = (rs.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, block_q=blk, block_k=blk, interpret=True)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = JF.flash_attention(jq, jk, jv, **kw)
    grads = jax.grad(lambda q, k, v: jnp.sum(JF.flash_attention(
        q, k, v, **kw) * jnp.asarray(g)), argnums=(0, 1, 2))(jq, jk, jv)
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = TF.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(to_np(out), to_np(want), **TOL)
    (out * _t(g)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads):
        np.testing.assert_allclose(to_np(got), to_np(ref), rtol=1e-4,
                                   atol=1e-5)
    _, lse = TF.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal=True)
    kr = np.repeat(k, h // hkv, axis=2)
    sc = np.einsum("bqhd,bkhd->bhqk", q, kr) / 16.0
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    ref = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) \
        + sc.max(-1)
    np.testing.assert_allclose(to_np(lse), ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ paged pools
N, BS, MB = 12, 4, 6


def _pools(rs, hkv, d=16):
    kp = rs.randn(N, BS, hkv, d).astype(np.float32)
    vp = rs.randn(N, BS, hkv, d).astype(np.float32)
    perm = rs.permutation(N)
    tables = np.full((3, MB), N, np.int32)       # sentinel = N
    tables[0, :5] = perm[:5]
    tables[1, :3] = perm[5:8]
    tables[2, :4] = perm[8:12]
    return kp, vp, tables


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_paged_chunk_matches_pallas_and_xla(h, hkv):
    rs = np.random.RandomState(4)
    kp, vp, tables = _pools(rs, hkv)
    q = rs.randn(3, 8, h, 16).astype(np.float32)
    offsets = np.array([0, 5, 9], np.int32)
    chunk_lens = np.array([8, 3, 0], np.int32)     # row 2 is dead
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, offsets, chunk_lens)]
    want = JPA.paged_chunk_attention_pallas(*jargs, interpret=True)
    xla = JPA.paged_chunk_attention_xla(*jargs)
    got = TPA.paged_chunk_attention(*(_t(a) for a in (q, kp, vp, tables,
                                                      offsets, chunk_lens)))
    for a, n in enumerate(chunk_lens):     # live query rows only
        np.testing.assert_allclose(to_np(got)[a, :n], to_np(want)[a, :n],
                                   **TOL)
        np.testing.assert_allclose(to_np(got)[a, :n], to_np(xla)[a, :n],
                                   **TOL)


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_paged_decode_matches_pallas(h, hkv, window):
    rs = np.random.RandomState(5)
    kp, vp, tables = _pools(rs, hkv)
    q = rs.randn(3, h, 16).astype(np.float32)
    lens = np.array([17, 9, 13], np.int32)
    want = JPA.paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)), window=window,
        interpret=True)
    got = TPA.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tables,
                                                       lens)), window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernel_route_by_dtype_and_head_dim(d):
    """K2, K5a and K5b run bf16 and float16 on the tensor cores and float32
    on fp32 FMAs at head dims 64, 128 and 256; another head dim (96) or
    dtype (float64) has no kernel and raises."""
    assert TF.ROUTED == ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    assert TF.kernel_route(torch.bfloat16, d) == "wgmma"
    assert TF.kernel_route(torch.float16, d) == "wgmma"
    assert TF.kernel_route(torch.float32, d) == "fma"
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        TF.kernel_route(torch.bfloat16, 96)
    with pytest.raises(TypeError):
        TF.kernel_route(torch.float64, d)


def test_paged_kernels_refuse_unported_modes():
    """No mode of the reference's paged or flash kernels is refused any
    more: ``partials`` (tested in ``test_torch_paged_partials.py``) and
    ALiBi, which runs: the flash wrapper equals its plain version and the
    eager attention (an independent implementation of the same bias)."""
    rs = np.random.RandomState(6)
    q = _t(rs.randn(3, 4, 16).astype(np.float32))
    slopes = torch.ones(4)
    got = TF.flash_attention(q[None], q[None], q[None], alibi_slopes=slopes)
    want = TF.flash_attention_plain(q[None], q[None], q[None],
                                    alibi_slopes=slopes)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, eager_attention(
        q[None], q[None], q[None], alibi_slopes=slopes), **TOL)
