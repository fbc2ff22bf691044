"""K7 (``ops.cuda.rope``) on the CPU against the JAX package.

The port's ``fused_rope`` runs its plain version on CPU tensors; it is
held against the Pallas kernel ``paddle_tpu.ops.pallas.rope.fused_rope``
(interpret mode), against the reference's ``apply_rope`` and the paged
serving path's ``_apply_rope_rows`` for per-row tables, and its autograd
backward against ``jax.vjp`` of ``apply_rope``. Inputs are made by numpy
from a seed and handed to both sides.

Tolerances: both sides compute each product and each sum in fp32 and
cast once. In fp32 they agree to 1e-6 (XLA may fuse a product into the
sum where ATen rounds it; |x| < 5). In bf16 one result may round to the
neighbouring bf16 value for the same reason: one bf16 step, 2**-8
relative (rtol 8e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import paged as jpaged
from paddle_tpu.ops import attention as JA
from paddle_tpu.ops.pallas.rope import fused_rope as pallas_fused_rope
from paddle_tpu_torch.models import paged as tpaged
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import fused_rotary_position_embedding
from paddle_tpu_torch.ops.cuda.rope import fused_rope, fused_rope_plain
from tests.test_torch_common import to_np

TOL = {"f32": dict(rtol=1e-6, atol=1e-6), "bf16": dict(rtol=8e-3, atol=1e-6)}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, dtype, seed=0):
    """(torch, jax) copies of one numpy draw, rounded to ``dtype`` once."""
    t_dt, j_dt = DTYPES[dtype]
    x = torch.as_tensor(np.random.RandomState(seed).randn(*shape)
                        .astype(np.float32)).to(t_dt)
    return x, jnp.asarray(x.float().numpy()).astype(j_dt)


def _tables(s, d, base=10000.0):
    """Shared [S, D/2] fp32 tables, the same on both sides."""
    cos, sin = JA.rope_cos_sin(s, d, base=base)
    return (torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin)),
            cos, sin)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_pallas_kernel(dtype, d):
    x, jx = _x((2, 16, 4, d), dtype)
    c, s, jc, js = _tables(16, d)
    want = pallas_fused_rope(jx, jc, js, interpret=True)
    got = fused_rope_plain(x, c, s)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])
    # the differentiable wrapper on a CPU tensor is the plain version
    assert torch.equal(fused_rope(x, c, s), got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nh,nkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_strided_qkv_views_through_apply_rope(dtype, nh, nkv):
    """q and k as ``torch.split`` views of the fused QKV product (token
    stride (nh + 2 nkv) * d), as the model and the paged forwards hand
    them over: the result equals the reference's ``apply_rope`` of the
    same values, and is contiguous."""
    b, s, d = 2, 12, 64
    qkv, jqkv = _x((b, s, (nh + 2 * nkv) * d), dtype, seed=1)
    q, k, _ = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
    q, k = q.reshape(b, s, nh, d), k.reshape(b, s, nkv, d)
    assert not q.is_contiguous() and q.stride(1) == (nh + 2 * nkv) * d
    jq = jqkv[..., :nh * d].reshape(b, s, nh, d)
    jk = jqkv[..., nh * d:(nh + nkv) * d].reshape(b, s, nkv, d)
    c, sn, jc, js = _tables(s, d, base=1e6)
    for got, want in ((TA.apply_rope(q, c, sn), JA.apply_rope(jq, jc, js)),
                      (TA.apply_rope(k, c, sn), JA.apply_rope(jk, jc, js))):
        assert got.is_contiguous()
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_per_row_tables(dtype):
    """Per-row tables: the dynamic-NTK prefill's [B, S, D/2] (a base per
    row from its length) through ``apply_rope``, the decode step's [B,
    D/2] and the chunk prefill's [A, C, D/2] through the paged forwards'
    ``_apply_rope_rows``, each against the reference's own code."""
    d, b, s = 64, 3, 10
    scaling = {"type": "dynamic", "factor": 2.0}
    lens = np.array([10, 4, 7], np.int32)
    jc, js = JA.rope_cos_sin(s, d, base=1e4, scaling=scaling,
                             max_position_embeddings=6, cur_len=lens,
                             allow_dynamic=False)
    c, sn = TA.rope_cos_sin(s, d, base=1e4, scaling=scaling,
                            max_position_embeddings=6, cur_len=lens,
                            allow_dynamic=False, device="cpu")
    assert tuple(c.shape) == (b, s, d // 2)
    np.testing.assert_allclose(to_np(c), np.asarray(jc), rtol=1e-6, atol=1e-6)
    x, jx = _x((b, s, 4, d), dtype, seed=2)
    # the same tables on both sides: the rotation, not the table math, is
    # under test here
    got = TA.apply_rope(x, torch.tensor(np.asarray(jc)),
                        torch.tensor(np.asarray(js)))
    np.testing.assert_allclose(to_np(got), to_np(JA.apply_rope(jx, jc, js)),
                               **TOL[dtype])
    # decode: one position per row, dynamic bases per row
    pos = np.array([3, 17, 9], np.int32)
    tc, ts = tpaged._rope_rows(torch.as_tensor(pos), d, 1e4, scaling, 6)
    rc, rsn = jpaged._rope_rows(jnp.asarray(pos), d, 1e4, scaling, 6)
    assert tuple(tc.shape) == (b, d // 2)
    np.testing.assert_allclose(to_np(tc), np.asarray(rc)[:, 0, 0], rtol=1e-5,
                               atol=1e-6)
    xd, jxd = _x((b, 1, 4, d), dtype, seed=3)
    got = tpaged._apply_rope_rows(xd, torch.tensor(np.asarray(rc)[:, 0, 0]),
                                  torch.tensor(np.asarray(rsn)[:, 0, 0]))
    np.testing.assert_allclose(
        to_np(got), to_np(jpaged._apply_rope_rows(jxd, rc, rsn)), **TOL[dtype])
    # chunk prefill: [A, C] positions from each row's offset
    f = (np.array([0, 5, 11])[:, None] + np.arange(4)[None, :])[..., None] \
        * (1.0 / 1e4 ** (np.arange(0, d, 2) / d))[None, None, :]
    cc, cs = np.cos(f).astype(np.float32), np.sin(f).astype(np.float32)
    xc, jxc = _x((3, 4, 4, d), dtype, seed=4)
    got = tpaged._apply_rope_rows(xc, torch.as_tensor(cc), torch.as_tensor(cs))
    want = jpaged._apply_rope_rows(jxc, jnp.asarray(cc)[:, :, None, :],
                                   jnp.asarray(cs)[:, :, None, :])
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL[dtype])


@pytest.mark.parametrize("tables", ["shared", "per_row"])
def test_backward_matches_jax_vjp(tables):
    """The autograd backward (the plain rotation by -sin on the CPU)
    against ``jax.vjp`` of the reference's ``apply_rope``, fp32."""
    b, s, h, d = 2, 8, 4, 64
    x, jx = _x((b, s, h, d), "f32", seed=5)
    g, jg = _x((b, s, h, d), "f32", seed=6)
    c, sn, jc, js = _tables(s, d)
    if tables == "per_row":
        rs = np.random.RandomState(7)
        ang = rs.uniform(-3, 3, (b, s, d // 2)).astype(np.float32)
        jc, js = jnp.cos(jnp.asarray(ang)), jnp.sin(jnp.asarray(ang))
        c, sn = (torch.tensor(np.asarray(t)) for t in (jc, js))
    xr = x.clone().requires_grad_()
    out = TA.apply_rope(xr, c, sn)
    (dx,) = torch.autograd.grad(out, xr, g)
    want_out, vjp = jax.vjp(lambda t: JA.apply_rope(t, jc, js), jx)
    (want,) = vjp(jg)
    np.testing.assert_allclose(to_np(out), np.asarray(want_out), **TOL["f32"])
    np.testing.assert_allclose(to_np(dx), np.asarray(want), **TOL["f32"])


@pytest.mark.parametrize("kw", [{}, dict(base=1e6), dict(seq_len=16),
                                dict(position_ids=np.arange(3, 19))],
                         ids=["default", "base", "seq_len", "position_ids"])
def test_fused_rotary_position_embedding_matches_reference(kw):
    b, s, d = 2, 16, 64
    q, jq = _x((b, s, 8, d), "f32", seed=8)
    k, jk = _x((b, s, 2, d), "f32", seed=9)
    tkw = dict(kw)
    if "position_ids" in kw:
        tkw["position_ids"] = torch.as_tensor(kw["position_ids"])
        kw = dict(position_ids=jnp.asarray(kw["position_ids"]))
    got = fused_rotary_position_embedding(q, k, **tkw)
    want = JA.fused_rotary_position_embedding(jq, jk, **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(w), **TOL["f32"])


def test_mismatched_tables_raise():
    x = torch.zeros(2, 8, 4, 64)
    c, s, _, _ = _tables(6, 64)
    with pytest.raises(ValueError, match="apply_rope"):
        TA.apply_rope(x, c, s)
    with pytest.raises(ValueError, match="rope"):
        fused_rope(x, c, s)          # 16 rows over 6 table rows
