"""ALiBi in K2 and K5: the plain versions against the Pallas kernels.

``paddle_tpu/ops/pallas/flash_attention.py`` adds ALiBi inside the score
tile (``_alibi_add``: ``slope * (k_pos - q_pos)`` under causal,
``-slope * |k_pos - q_pos|`` without, query positions from ``_q_offset``)
in its forward (K2) and both backward kernels (K5a, K5b). The port's
``flash_attention`` runs its plain versions on CPU tensors; here they
meet the Pallas kernels in interpret mode on the same numpy inputs, in
fp32: causal and bidirectional, [H] and [B, H] slopes, GQA, a window,
``kv_lens`` with S == Sk and with a short query block (decode against a
padded cache). Padded query rows are unspecified in the reference: they
are left out of the comparison and get a zero cotangent. The card's
kernels are held against these plain versions in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.attention import xla_attention
from paddle_tpu.ops.pallas import flash_attention as JF
from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
from paddle_tpu_torch.ops.cuda import flash_attention as TF
from tests.test_torch_common import to_np

# fp32, the same algorithm on both sides: only the summation order differs
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)

# name -> (h, hkv, s, sk, causal, window, kv_lens, per-row slopes, d)
CASES = {
    "causal": (4, 4, 40, 40, True, None, None, False, 16),
    "bidir": (4, 4, 40, 40, False, None, None, False, 16),
    "causal_bh_gqa": (4, 2, 40, 40, True, None, None, True, 16),
    "bidir_bh_gqa4": (4, 1, 33, 33, False, None, None, True, 16),
    "window_gqa": (4, 2, 37, 37, True, 6, None, False, 16),
    "kv_lens_bh": (4, 2, 40, 40, True, None, (40, 23), True, 16),
    "bidir_kv_lens": (4, 4, 40, 40, False, None, (40, 17), False, 16),
    "short_q_kv_lens_gqa": (4, 2, 5, 64, True, None, (64, 30), True, 16),
    "s1_kv_lens": (4, 4, 1, 48, True, None, (48, 9), False, 16),
    "bidir_short_q": (4, 2, 6, 24, False, None, None, False, 16),
    "causal_d64_gqa": (4, 2, 32, 32, True, None, None, True, 64),
}


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _live(s, sk, lens):
    """[B|1, S]: the query rows the reference specifies (with kv_lens and
    S == Sk the valid rows; with S < Sk those with a live key)."""
    if lens is None:
        return np.ones((1, s), bool)
    lens = np.asarray(lens)[:, None]
    if s == sk:
        return np.arange(s)[None, :] < lens
    return (lens - s + np.arange(s)[None, :] >= 0) & (lens > 0)


def _inputs(seed, h, hkv, s, sk, lens, per_row, d, b=2):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, s, h, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    # positive slopes up to BLOOM's largest (2^-0.5 at 16 heads)
    slopes = rs.uniform(0.05, 0.7, (b, h) if per_row else (h,))
    if lens is not None:
        lens = np.asarray(lens, np.int32)
        g = g * _live(s, sk, lens)[:, :, None, None]
    return q, k, v, g, slopes.astype(np.float32), lens


@pytest.mark.parametrize("h,hkv,s,sk,causal,window,lens,per_row,d",
                         CASES.values(), ids=CASES.keys())
def test_alibi_forward_matches_pallas(h, hkv, s, sk, causal, window, lens,
                                      per_row, d):
    q, k, v, _, slopes, lens = _inputs(30, h, hkv, s, sk, lens, per_row, d)
    want = JF.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal, window=window,
        kv_lens=None if lens is None else jnp.asarray(lens),
        alibi_slopes=jnp.asarray(slopes), interpret=True)
    got = TF.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window,
        kv_lens=None if lens is None else _t(lens), alibi_slopes=_t(slopes))
    live = np.broadcast_to(_live(s, sk, lens), (q.shape[0], s))
    np.testing.assert_allclose(to_np(got)[live], to_np(want)[live],
                               **FWD_TOL)


@pytest.mark.parametrize("h,hkv,s,sk,causal,window,lens,per_row,d",
                         CASES.values(), ids=CASES.keys())
def test_alibi_backward_matches_pallas(h, hkv, s, sk, causal, window, lens,
                                       per_row, d):
    """dq, dk, dv of the plain backward (the flash-2 recomputation from
    the saved O and the LSE, which includes the bias) against jax.grad
    through the Pallas kernels; the slopes get a zero cotangent on both
    sides (None in PyTorch)."""
    q, k, v, g, slopes, lens = _inputs(31, h, hkv, s, sk, lens, per_row, d)
    jl = None if lens is None else jnp.asarray(lens)

    def loss(q, k, v, m):
        return jnp.sum(JF.flash_attention(
            q, k, v, causal=causal, window=window, kv_lens=jl,
            alibi_slopes=m, block_q=8, block_k=8, interpret=True)
            * jnp.asarray(g))
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, slopes)))
    qt, kt, vt, mt = (_t(a).requires_grad_() for a in (q, k, v, slopes))
    out = TF.flash_attention(qt, kt, vt, causal=causal, window=window,
                             kv_lens=None if lens is None else _t(lens),
                             alibi_slopes=mt)
    (out * _t(g)).sum().backward()
    for got, ref in zip((qt.grad, kt.grad, vt.grad), want[:3]):
        np.testing.assert_allclose(to_np(got), to_np(ref), **BWD_TOL)
    assert mt.grad is None
    assert not np.asarray(want[3]).any()


def test_alibi_lse_includes_the_bias():
    """The LSE the forward saves for K5 is the log-sum-exp of the scaled
    scores plus the bias (rows with kv_lens included)."""
    q, k, v, _, slopes, lens = _inputs(32, 4, 2, 24, 24, (24, 11), True, 16)
    _, lse = TF.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal=True,
                                          kv_lens=_t(lens),
                                          alibi_slopes=_t(slopes))
    kr = np.repeat(k, 2, axis=2)
    scores = np.einsum("bqhd,bkhd->bhqk", q, kr) * 16 ** -0.5
    pos = np.arange(24)
    scores = scores + (slopes[:, :, None, None]
                       * (pos[None, :] - pos[:, None])[None, None])
    keep = (np.tril(np.ones((24, 24), bool))[None]
            & (pos[None, None, :] < lens[:, None, None]))[:, None]
    want = jax.nn.logsumexp(jnp.where(keep, scores, -jnp.inf), axis=-1)
    np.testing.assert_allclose(to_np(lse), np.asarray(want), **FWD_TOL)


def test_alibi_decode_alignment_matches_solo_call():
    """With kv_lens and a short query block, the bias uses the query
    positions end-aligned to each row's valid length: a row equals a solo
    call against its trimmed cache (the reference's
    test_flash_alibi_varlen_decode_alignment)."""
    q, k, v, _, slopes, lens = _inputs(33, 2, 2, 16, 64, (64, 41), False, 16)
    got = TF.flash_attention(_t(q), _t(k), _t(v), causal=True,
                             kv_lens=_t(lens), alibi_slopes=_t(slopes))
    solo = TF.flash_attention(_t(q[1:]), _t(k[1:, :41]), _t(v[1:, :41]),
                              causal=True, alibi_slopes=_t(slopes))
    np.testing.assert_allclose(to_np(got[1]), to_np(solo[0]), **FWD_TOL)
    ref = xla_attention(*(jnp.asarray(a) for a in (q, k, v)), is_causal=True,
                        kv_lens=jnp.asarray(lens),
                        alibi_slopes=jnp.asarray(slopes))
    np.testing.assert_allclose(to_np(got), to_np(ref), **FWD_TOL)


def test_sdpa_sends_alibi_to_the_flash_kernel(monkeypatch):
    """scaled_dot_product_attention hands ALiBi to the flash wrapper (its
    plain version on the CPU), as the reference hands it to the Pallas
    kernel; the result equals the reference's XLA attention."""
    q, k, v, _, slopes, _ = _inputs(34, 4, 2, 12, 12, None, True, 16)
    seen = []
    real = TF.flash_attention

    def spy(*a, **kw):
        seen.append(kw.get("alibi_slopes") is not None)
        return real(*a, **kw)
    monkeypatch.setattr(TF, "flash_attention", spy)
    got = scaled_dot_product_attention(_t(q), _t(k), _t(v), is_causal=True,
                                       alibi_slopes=_t(slopes))
    assert seen == [True]
    want = xla_attention(*(jnp.asarray(a) for a in (q, k, v)),
                         is_causal=True, alibi_slopes=jnp.asarray(slopes))
    np.testing.assert_allclose(to_np(got), to_np(want), **FWD_TOL)


def test_alibi_slopes_of_another_shape_raise():
    q = torch.zeros(2, 4, 4, 16)
    with pytest.raises(ValueError, match="alibi_slopes shape"):
        TF.flash_attention(q, q, q, alibi_slopes=torch.ones(3))
    with pytest.raises(ValueError, match="alibi_slopes shape"):
        TF.flash_attention(q, q, q, alibi_slopes=torch.ones(3, 4))
