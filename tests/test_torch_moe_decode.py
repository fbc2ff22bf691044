"""The MoE layer's fused decode products and K7's fold with the decode
tick's pool write, in their plain versions, against the JAX package.

On the CPU the wrappers of K6a's decode route (``moe_gate_up``,
``moe_down``) and of the fold (``rope_kv_write``) run the unfused
composition, so ``decode_forward`` and the paged decode step must equal
the reference's ``grouped_forward`` and ``llama_decode_step_paged``: fp32
within 1e-5 (the same arithmetic, the combine summed in another order),
bf16 within the steps of bf16 the two frameworks round at differently;
and they must equal the port's unfused composition bit for bit. Inputs
from numpy seeds; the same weights on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.models import paged as JP
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.models import paged as TP
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
from paddle_tpu_torch.ops.cuda import rope as TR
from tests.test_torch_common import to_np
from tests.test_torch_moe import _layer_pair

T, H, INTER, E, K = 8, 32, 48, 6, 2


def _routing(kind, seed=0):
    """Logits [T, E] of a decode batch and the capacity of ``kind``:
    "random"; "empty_group" (expert 5 never chosen); "one_expert" (every
    token's first choice is expert 0: a group of T > 4 rows);
    "dropped" (capacity 4 under the same skew: assignments past it are
    dropped, keep 0)."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(T, E).astype(np.float32)
    cap = T
    if kind == "empty_group":
        logits[:, 5] = -30.0
    if kind in ("one_expert", "dropped"):
        logits[:, 0] = 30.0
    if kind == "dropped":
        cap = 4
    return logits, cap


def _weights(seed=1):
    rs = np.random.RandomState(seed)
    xt = rs.randn(T, H).astype(np.float32)
    gu = (rs.randn(E, H, 2 * INTER) * H ** -0.5).astype(np.float32)
    dn = (rs.randn(E, INTER, H) * INTER ** -0.5).astype(np.float32)
    return xt, gu, dn


def _unfused(xt, route, gate_up, down, num_tokens):
    """The port's unfused composition, step by step (the layer's code
    before the decode route)."""
    n = route["order"].shape[0]
    k = n // num_tokens
    x_sorted = xt.unsqueeze(0).expand(k, *xt.shape).reshape(
        n, xt.shape[1]).index_select(0, route["order"])
    gu = GM.grouped_matmul_plain(x_sorted, gate_up, route["counts"])
    g, u = torch.chunk(gu, 2, dim=-1)
    y = GM.grouped_matmul_plain(torch.nn.functional.silu(g) * u, down,
                                route["counts"])
    wgt = (route["gate"] * route["keep"]).to(y.dtype)
    return tmoe._combine_by_token(y * wgt[:, None], route, num_tokens)


@pytest.mark.parametrize("kind", ["random", "empty_group", "one_expert",
                                  "dropped"])
def test_decode_forward_matches_reference_and_unfused(kind):
    """``decode_forward`` (the plain versions of the two fused products
    and the sum) against ``paddle_tpu.distributed.moe.grouped_forward`` on
    the same route, and bit for bit against the port's unfused
    composition; ``grouped_forward`` takes the decode route here."""
    logits, cap = _routing(kind)
    xt, gu, dn = _weights()
    jroute, _, _ = jmoe.top_k_route(jnp.asarray(logits), K, cap)
    troute, _, drop = tmoe.top_k_route(torch.as_tensor(logits), K, cap)
    counts = troute["counts"].numpy()
    if kind == "empty_group":
        assert counts[5] == 0
    if kind in ("one_expert", "dropped"):
        assert counts[0] == T > 4
    if kind == "dropped":
        assert float(drop) > 0 and not bool(troute["keep"].all())
    want = jmoe.grouped_forward(jnp.asarray(xt), jroute, jnp.asarray(gu),
                                jnp.asarray(dn), T)
    args = (torch.as_tensor(xt), troute, torch.as_tensor(gu),
            torch.as_tensor(dn), T)
    assert tmoe._decode_fused(*args[:4])
    got = tmoe.decode_forward(*args)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, _unfused(*args))
    assert torch.equal(tmoe.grouped_forward(*args), got)


@pytest.mark.parametrize("kind", ["random", "one_expert", "dropped"])
def test_fused_products_bf16_are_the_unfused_roundings(kind):
    """In bf16 the two products' plain versions round where the unfused
    composition rounds (the gate_up product, silu, the product with up,
    the down product, the cast weight, the weighted row): bit for bit,
    and within bf16 steps of the reference run in bf16."""
    logits, cap = _routing(kind, seed=3)
    xt, gu, dn = _weights(seed=4)
    troute, _, _ = tmoe.top_k_route(torch.as_tensor(logits), K, cap)
    args = tuple(torch.as_tensor(a).to(torch.bfloat16) for a in (xt, gu, dn))
    got = tmoe.decode_forward(args[0], troute, *args[1:], T)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _unfused(args[0], troute, *args[1:], T))
    jroute, _, _ = jmoe.top_k_route(jnp.asarray(logits), K, cap)
    jx, jgu, jdn = (jnp.asarray(a, jnp.bfloat16) for a in (xt, gu, dn))
    want = jmoe.grouped_forward(jx, jroute, jgu, jdn, T)
    ref = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("factor", [1.25, None], ids=["c1.25", "dropless"])
def test_moe_layer_at_decode_matches_reference(factor):
    """The port's ``MoELayer`` at a decode batch (8 rows of one token),
    which takes the fused products, against the JAX layer; the kill
    switch's dense path gives the same output."""
    jl, tl = _layer_pair(factor, True, h=H, inter=INTER, e=E, k=K)
    x = np.random.RandomState(5).randn(T, 1, H).astype(np.float32)
    jy = jl(jnp.asarray(x), return_aux=False)
    with torch.no_grad():
        y = tl(torch.as_tensor(x), return_aux=False)
        xt = torch.as_tensor(x).reshape(T, H)
        assert tmoe._decode_fused(xt, {"order": torch.zeros(T * K)},
                                  tl.experts.gate_up, tl.experts.down)
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


# (label, m, e, h, inter, dtype, aligned, fused): Qwen1.5-MoE-A2.7B's and
# Mixtral-8x7B's decode and prefill, and the edges of the decode route
ROUTE_CASES = [
    ("qwen_decode", 32, 60, 2048, 1408, torch.bfloat16, True, True),
    ("qwen_decode_f32", 32, 60, 2048, 1408, torch.float32, True, True),
    ("mixtral_decode", 16, 8, 4096, 14336, torch.bfloat16, True, True),
    ("qwen_prefill", 4096, 60, 2048, 1408, torch.bfloat16, True, False),
    ("eight_a_group", 8 * 60, 60, 2048, 1408, torch.bfloat16, True, True),
    ("past_eight", 8 * 60 + 1, 60, 2048, 1408, torch.bfloat16, True, False),
    ("h_off_8", 32, 60, 2044, 1408, torch.bfloat16, True, False),
    ("h_off_8_f32", 32, 60, 2044, 1408, torch.float32, True, True),
    ("inter_off_8", 32, 60, 2048, 1404, torch.bfloat16, True, False),
    ("unaligned", 32, 60, 2048, 1408, torch.bfloat16, False, False),
    ("fp16", 32, 60, 2048, 1408, torch.float16, True, True),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_moe_decode_route_reads_static_shapes_only(case):
    """``moe_decode_route`` is a pure function of the static shapes, the
    dtype and the weights' alignment: both products must take K6a's
    decode route."""
    _, m, e, h, inter, dtype, aligned, fused = case
    assert GM.moe_decode_route(m, e, h, inter, dtype, aligned) is fused


def test_decode_route_is_not_taken_where_a_gradient_is_recorded():
    """Training keeps the autograd path (the general products and their
    backward); under ``no_grad`` the same shapes take the decode route."""
    _, gu, dn = _weights()
    xt = torch.randn(T, H, requires_grad=True)
    route = {"order": torch.zeros(T * K, dtype=torch.int64)}
    w = (torch.as_tensor(gu), torch.as_tensor(dn))
    assert not tmoe._decode_fused(xt, route, *w)
    with torch.no_grad():
        assert tmoe._decode_fused(xt, route, *w)
    assert tmoe._decode_fused(xt.detach(), route, *w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 16), (8, 1, 64), (4, 4, 128)])
def test_rope_kv_write_plain_is_the_unfused_composition(dtype, hq, hkv, d):
    """The fold's plain version equals K7's plain version on q and k and
    the paged forwards' ``_scatter`` of k and v bit for bit, with per-row
    tables and inactive rows writing to the sink; q rotated agrees with
    the reference's ``_apply_rope_rows``."""
    rs = np.random.RandomState(hq + d)
    b, nb, bs = 5, 6, 4
    qkv = torch.as_tensor(rs.randn(b, 1, (hq + 2 * hkv) * d)).to(dtype)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q, k, v = (q.reshape(b, 1, hq, d), k.reshape(b, 1, hkv, d),
               v.reshape(b, 1, hkv, d))
    ang = rs.rand(b, d // 2).astype(np.float32) * 100
    cos, sin = torch.as_tensor(np.cos(ang)), torch.as_tensor(np.sin(ang))
    pools = [torch.as_tensor(rs.randn(nb + 1, bs, hkv, d)).to(dtype)
             for _ in range(2)]
    ref_pools = [p.clone() for p in pools]
    dest = torch.as_tensor(rs.permutation(nb * bs)[:b])
    dest[[1, 3]] = nb * bs
    got = TR.rope_kv_write(q, k, v, cos, sin, *pools, dest)
    want = TR.fused_rope_plain(q, cos, sin)
    TP._scatter(ref_pools[0], TR.fused_rope_plain(k, cos, sin), dest)
    TP._scatter(ref_pools[1], v, dest)
    assert torch.equal(got, want)
    for p, rp in zip(pools, ref_pools):
        assert torch.equal(p[:nb], rp[:nb])
    jq = JP._apply_rope_rows(jnp.asarray(q.float().numpy()),
                             jnp.asarray(cos.numpy())[:, None, None, :],
                             jnp.asarray(sin.numpy())[:, None, None, :])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jq),
                               rtol=0, atol=1e-5 if dtype == torch.float32
                               else 1.6e-2)


def _bf16_or_f32_pair(dtype):
    pt.seed(0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    kw = dict(num_key_value_heads=2)
    jm = JLlama(JLlamaConfig.tiny(dtype=jdt, **kw))
    tm = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype, **kw), device="cpu")
    load_jax_state_dict(tm, jm.state_dict())
    return jm, tm, jdt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_step_over_a_pool_of_the_model_type_matches_reference(dtype):
    """The port's ``llama_decode_step_paged`` (the fold's route: a pool of
    the model's type) against the reference's, over fp32 and bf16 pools:
    two prompts prefilled, one decode step with an inactive row; logits
    and the whole pools agree (fp32 1e-4, bf16 to the steps the two
    round at differently), the inactive row writes nothing readable."""
    jm, tm, jdt = _bf16_or_f32_pair(dtype)
    cfg = tm.cfg
    d = cfg.hidden_size // cfg.num_attention_heads
    n, bs, slots, mb = 16, 4, 3, 8
    jc = JP.PagedKVCache.init(cfg.num_hidden_layers, n, bs,
                              cfg.num_key_value_heads, d, slots, mb, jdt)
    tc = TP.PagedKVCache.init(cfg.num_hidden_layers, n, bs,
                              cfg.num_key_value_heads, d, slots, mb, dtype,
                              device="cpu")
    rs = np.random.RandomState(3)
    ids = np.zeros((3, 9), np.int32)
    ids[0] = rs.randint(0, 256, 9)
    ids[1, :6] = rs.randint(0, 256, 6)
    ids[2, :3] = rs.randint(0, 256, 3)
    lens = np.array([9, 6, 3], np.int32)
    jl, jc = JP.llama_prefill_paged(jm, jnp.asarray(ids), jnp.asarray(lens),
                                    jc)
    tl, tc = TP.llama_prefill_paged(tm, torch.as_tensor(ids), lens, tc)
    tok = np.array([5, 9, 200], np.int32)
    active = np.array([True, False, True])
    jl, jc = JP.llama_decode_step_paged(jm, jnp.asarray(tok), jc,
                                        jnp.asarray(active))
    tl, tc = TP.llama_decode_step_paged(tm, torch.as_tensor(tok), tc,
                                        torch.as_tensor(active))
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=0, atol=6e-2))
    np.testing.assert_allclose(tl.float().numpy()[active],
                               np.asarray(jl, np.float32)[active], **tol)
    for a, b in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), **tol)
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))
