"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside its body whether a card is
present and skips here, where there is none. The file imports neither
JAX nor the JAX package, so it also runs on a machine with the card and
no JAX, with the repository's conftest (which imports JAX) left out::

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import _build
from paddle_tpu_torch.ops.cuda import flash_attention as TF
from paddle_tpu_torch.ops.cuda import grouped_matmul as TG
from paddle_tpu_torch.ops.cuda import norms as TN
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from paddle_tpu_torch.ops.cuda import rope as TR


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """Each CUDA kernel against its plain version on the card, at a small
    shape with GQA, ragged lengths and a sentinel table slot. bf16: the
    two round at different places, so the bound scales with |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def close(a, b):
        d = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(d.max()) <= tol

    x, w = rnd(37, 4096), rnd(4096)
    close(TN.rms_norm(x, w, 1e-5), TN.rms_norm_plain(x, w, 1e-5))
    q, k, v = rnd(2, 77, 8, 128), rnd(2, 77, 2, 128), rnd(2, 77, 2, 128)
    lens = torch.tensor([77, 30], device=dev)
    got = TF.flash_attention(q, k, v, causal=True, kv_lens=lens)
    ref = TF.flash_attention_plain(q, k, v, causal=True, kv_lens=lens)
    close(got[0], ref[0])
    close(got[1, :30], ref[1, :30])
    kp, vp = rnd(20, 16, 2, 128), rnd(20, 16, 2, 128)
    tables = torch.randperm(20, generator=g, device=dev)[:12].reshape(3, 4)
    tables = torch.cat([tables, torch.full((3, 1), 20, device=dev)], 1).int()
    qd, dl = rnd(3, 8, 128), torch.tensor([64, 1, 33], device=dev)
    close(TPA.paged_decode_attention(qd, kp, vp, tables, dl),
          TPA.paged_decode_attention_plain(qd, kp, vp, tables, dl))
    qc = rnd(3, 20, 8, 128)
    offs = torch.tensor([0, 40, 10], device=dev)
    cls = torch.tensor([20, 7, 0], device=dev)
    got = TPA.paged_chunk_attention(qc, kp, vp, tables, offs, cls)
    ref = TPA.paged_chunk_attention_plain(qc, kp, vp, tables, offs, cls)
    close(got[0], ref[0])
    close(got[1, :7], ref[1, :7])
    assert float(got[2].abs().max()) == 0.0          # dead row writes 0


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_and_launches_every_kernel():
    """The serving path on the card in float32 (every kernel) gives the
    same greedy streams as the plain path on the CPU, and launches each
    kernel. Width: head_dim 128 (the kernels' serving width), 2 layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n) for n in (5, 30, 70, 9)]
    prompts.append(np.concatenate([prompts[2][:40], rs.randint(0, 512, 7)]))
    streams = []
    for model in (cpu, card):
        K.reset_launches()
        eng = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=32,
                        max_seq_len=128)
        ids = [eng.add_request(Request(p, max_new_tokens=8)) for p in prompts]
        eng.run()
        eng.assert_quiescent()
        streams.append([eng.requests[i].tokens for i in ids])
    assert streams[0] == streams[1]
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.SERVE_KERNELS), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
def test_rope_kernel_forward_bit_identical_backward_close(dtype, tol, d):
    """K7 on strided q/k views of a fused QKV product (GQA), with a shared
    [S, D/2] table and with per-row [B, S, D/2] tables: the forward equals
    the plain version bit for bit; the backward (the kernel with -sin)
    agrees with autograd through the plain version within ``tol``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, nh, nkv = 2, 37, 8, 2
    qkv = torch.randn(b, s, (nh + 2 * nkv) * d, generator=g,
                      device=dev).to(dtype)
    q, k, _ = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
    ang = torch.rand(b, s, d // 2, generator=g, device=dev) * 40.0
    tables = {"shared": (ang[0].cos(), ang[0].sin()),
              "per_row": (ang.cos(), ang.sin())}
    for x, h in ((q, nh), (k, nkv)):
        x = x.reshape(b, s, h, d)
        for cos, sin in tables.values():
            n0 = TR.fused_rope.launches
            got = TR.fused_rope(x, cos, sin)
            assert TR.fused_rope.launches == n0 + 1
            assert torch.equal(got, TR.fused_rope_plain(x, cos, sin))
            xr = x.detach().clone().requires_grad_()
            cot = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
            (dx,) = torch.autograd.grad(TR.fused_rope(xr, cos, sin), xr, cot)
            (ref,) = torch.autograd.grad(TR.fused_rope_plain(xr, cos, sin),
                                         xr, cot)
            assert dx.dtype == dtype
            err = (dx.float() - ref.float()).abs() / (1 + ref.float().abs())
            assert float(err.max()) <= tol


@pytest.mark.cuda
def test_windowed_engine_on_card_matches_cpu():
    """A sliding-window model (window 24, head_dim 128, float32) served on
    the card gives the CPU's greedy streams, recycles blocks, and launches
    the window path's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.mistral import (MistralConfig,
                                                 MistralForCausalLM)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    cfg = MistralConfig.tiny(hidden_size=256, intermediate_size=512,
                             num_attention_heads=2, num_key_value_heads=1,
                             vocab_size=512, sliding_window=24)
    cpu = MistralForCausalLM(cfg, device="cpu")
    card = MistralForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 512, n) for n in (5, 30, 60, 9)]
    streams = []
    for model in (cpu, card):
        K.reset_launches()
        eng = LLMEngine(model, num_slots=3, block_size=8, max_prompt_len=64,
                        max_seq_len=128)
        ids = [eng.add_request(Request(p, max_new_tokens=40)) for p in prompts]
        peak = 0
        while eng.has_work():
            eng.step()
            peak = max([peak] + [eng.kv.live_blocks(int(r))
                                 for r in eng.slot_req if r >= 0])
        eng.assert_quiescent()
        streams.append([eng.requests[i].tokens for i in ids])
        assert peak <= eng.mgr.blocks_needed(24 + 2 * 8)
    assert streams[0] == streams[1]
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.WINDOW_SERVE_KERNELS), counts


@pytest.mark.cuda
def test_rms_norm_reads_an_fp32_weight_in_fp32():
    """bf16 x under an fp32 weight that bf16 cannot hold: the kernel
    multiplies by the fp32 weight, as the plain version does, so the two
    differ only by summation order (a weight rounded to bf16 changes ~15%
    of the results); its backward gives dw in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(512, 2048, generator=g, device="cuda").bfloat16()
    w = 1.0 + 1e-3 * torch.randn(2048, generator=g, device="cuda")
    got = TN.rms_norm(x, w, 1e-5)
    assert float((got == TN.rms_norm_plain(x, w, 1e-5)).float().mean()) \
        >= 0.99
    w.requires_grad_()
    TN.rms_norm(x, w, 1e-5).float().sum().backward()
    assert w.grad.dtype == torch.float32


# (h, rows): K1 at the train steps' rows (2048 and 1024 wide), a short
# row, the 7B and Mistral widths, a wide row of few rows, and a width of
# no whole 16-byte vectors (scalar access)
RMS_CARD_CASES = {
    "h2048_rows4096": (2048, 4096),
    "h1024_rows5000": (1024, 5000),
    "h72_rows4099": (72, 4099),
    "h2048_rows1024": (2048, 1024),
    "h4096_rows4096": (4096, 4096),
    "h5120_rows37": (5120, 37),
    "h8192_rows8": (8192, 8),
    "h2044_rows300": (2044, 300),
}


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype,tol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2),
                                        (torch.float16, 2e-2)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16,
                                    torch.float16],
                         ids=["w_f32", "w_bf16", "w_f16"])
@pytest.mark.parametrize("case", RMS_CARD_CASES.keys())
def test_rms_norm_kernel_matches_plain_across_widths(xdtype, tol, wdtype,
                                                     case):
    """K1 against the plain version at the widths and row counts of
    RMS_CARD_CASES, bf16, f16 and fp32 x under bf16, f16 and fp32 weights;
    every launch counted (a float16 x also on the float16 count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    h, rows = RMS_CARD_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(h + rows)
    w = (1.0 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(wdtype)
    x = (3 * torch.randn(rows, h, generator=g, device="cuda")).to(xdtype)
    n0, f0 = TN.rms_norm.launches, TN.rms_norm.f16.launches
    got = TN.rms_norm(x, w, 1e-5)
    assert TN.rms_norm.launches == n0 + 1
    assert TN.rms_norm.f16.launches == f0 + (xdtype == torch.float16)
    ref = TN.rms_norm_plain(x, w, 1e-5)
    assert got.dtype == xdtype and got.shape == x.shape
    d = (got.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert float(d.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("case", ["causal", "full", "gqa_window_lens"])
def test_flash_backward_kernels_match_plain(dtype, tol, case):
    """K5a/K5b against flash_attention_bwd_plain from the same saved O and
    LSE, and K2's LSE against the plain one, at ragged small shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    h, hkv, d = (8, 2, 128) if case == "gqa_window_lens" else (4, 4, 64)
    q = torch.randn(2, 150, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, 150, hkv, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn(2, 150, h, d, generator=g, device=dev).to(dtype)
    kw = dict(causal=case != "full")
    lens = None
    if case == "gqa_window_lens":
        lens = torch.tensor([150, 71], dtype=torch.int32, device=dev)
        kw.update(window=33, kv_lens=lens)
        do = do * (torch.arange(150, device=dev)[None, :]
                   < lens[:, None])[:, :, None, None]
    args = (kw["causal"], d ** -0.5, kw.get("window"), lens)
    o, lse = TF.flash_fwd_cuda(q, k, v, *args)
    _, lse_ref = TF.flash_attention_fwd_plain(q, k, v, **kw)
    assert float((lse - lse_ref).abs().max()) <= 1e-4 * (
        1 + float(lse_ref.abs().max()))
    n0 = (TF.flash_bwd_dq.launches, TF.flash_bwd_dkv.launches)
    got = TF.flash_bwd_cuda(q, k, v, o, lse, do, *args)
    ref = TF.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert (TF.flash_bwd_dq.launches, TF.flash_bwd_dkv.launches) == (
        n0[0] + 1, n0[1] + 1)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == dtype
        err = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(err.max()) <= tol


# the tensor-core kernels' tile edges (64-row q and k tiles, 64-key
# steps): b, S, Sk, H, Hkv, causal, window, kv_lens
EDGE_CASES = {
    "ragged_gqa32_8": (2, 77, 77, 32, 8, True, None, None),
    "ragged_kv_lens": (2, 150, 150, 8, 2, True, None, (150, 71)),
    "full_ragged": (2, 130, 130, 8, 8, False, None, (130, 65)),
    "s1_dead_row": (2, 1, 70, 4, 4, True, None, (70, 0)),
    "s5_kv_lens": (3, 5, 70, 8, 1, True, None, (70, 33, 3)),
    "window5_gqa8_1": (2, 200, 200, 8, 1, True, 5, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", EDGE_CASES.keys())
def test_flash_kernels_match_plain_at_tile_edges(dtype, tol, d, case):
    """K2 (O and LSE) and K5a/K5b (dq, dk, dv) against their plain
    versions on their route (bf16: tensor cores, fp32: FMAs) at S and Sk
    off the 64-row tiles, one and five query rows end-aligned to 70 keys
    with kv_lens, a row with no live key (O and LSE exactly 0), a window
    smaller than one key tile, GQA 32/8 and 8/1, at head dims 64, 128
    and 256 (K5b's tensor-core route: a dV block and a dK block a k
    tile). Rows without a live key, and padded rows, get a zero
    cotangent, as callers give them. Neither kernel uses atomics: two
    runs give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    b, s, sk, h, hkv, causal, window, lens = EDGE_CASES[case]
    assert TF.kernel_route(dtype, d) == (
        "fma" if dtype == torch.float32 else "wgmma")
    g = torch.Generator(device=dev).manual_seed(4)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def close(a, b):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(err.max()) <= tol

    q, do = rnd(b, s, h, d), rnd(b, s, h, d)
    k, v = rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    args = (causal, d ** -0.5, window, kl)
    runs = [TF.flash_fwd_cuda(q, k, v, *args) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    o, lse = runs[0]
    ref_o, ref_lse = TF.flash_attention_fwd_plain(q, k, v, *args)
    _, keep = TF._masked_scores(q, k, causal, 1.0, window, kl)
    live = keep.any(-1)[:, 0].expand(b, s)                  # [B, S]
    close(o[live], ref_o[live])
    close(lse.transpose(1, 2)[live], ref_lse.transpose(1, 2)[live])
    assert not o[~live].any() and not lse.transpose(1, 2)[~live].any()
    if kl is not None and s == sk:
        live = live & (torch.arange(s, device=dev)[None, :] < kl[:, None])
    do = do * live[:, :, None, None]
    n0 = (TF.flash_bwd_dq.launches, TF.flash_bwd_dkv.launches)
    runs = [TF.flash_bwd_cuda(q, k, v, o, lse, do, *args) for _ in range(2)]
    assert (TF.flash_bwd_dq.launches, TF.flash_bwd_dkv.launches) == (
        n0[0] + 2, n0[1] + 2)
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    for got, ref in zip(runs[0],
                        TF.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     *args)):
        close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)],
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("per_row", [False, True], ids=["h", "bh"])
@pytest.mark.parametrize("case", EDGE_CASES.keys())
def test_flash_alibi_kernels_match_plain_at_tile_edges(dtype, tol, d,
                                                       per_row, case):
    """The ALiBi mode of K2 (O and LSE), K5a and K5b (dq, dk, dv) against
    the plain versions with the same slopes ([H] or [B, H], BLOOM-sized:
    up to 2^-0.5), on each route, at the tile edges of the mode without
    ALiBi: every live tile takes the bias, K5b's slope changes inside the
    GQA group sum, the short query blocks use the end-aligned positions.
    Only the ALiBi counters rise; two runs give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.ops import cuda as K
    dev = torch.device("cuda")
    b, s, sk, h, hkv, causal, window, lens = EDGE_CASES[case]
    g = torch.Generator(device=dev).manual_seed(14)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    def close(a, b):
        assert a.dtype == b.dtype
        err = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(err.max()) <= tol

    q, do = rnd(b, s, h, d), rnd(b, s, h, d)
    k, v = rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    m = 0.05 + 0.66 * torch.rand((b, h) if per_row else (h,), generator=g,
                                 device=dev)
    slopes = TF._slopes(m, q)
    args = (causal, d ** -0.5, window, kl, slopes)
    K.reset_launches()
    runs = [TF.flash_fwd_cuda(q, k, v, *args) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    o, lse = runs[0]
    ref_o, ref_lse = TF.flash_attention_fwd_plain(q, k, v, *args)
    _, keep = TF._masked_scores(q, k, causal, 1.0, window, kl)
    live = keep.any(-1)[:, 0].expand(b, s)                  # [B, S]
    close(o[live], ref_o[live])
    close(lse.transpose(1, 2)[live], ref_lse.transpose(1, 2)[live])
    assert not o[~live].any() and not lse.transpose(1, 2)[~live].any()
    if kl is not None and s == sk:
        live = live & (torch.arange(s, device=dev)[None, :] < kl[:, None])
    do = do * live[:, :, None, None]
    runs = [TF.flash_bwd_cuda(q, k, v, o, lse, do, *args) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    for got, ref in zip(runs[0],
                        TF.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     *args)):
        close(got, ref)
    counts = K.launches()
    assert {n: counts[n] for n in K.ALIBI_TRAIN_KERNELS} == dict.fromkeys(
        K.ALIBI_TRAIN_KERNELS, 2), counts
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 0, counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)],
                         ids=["f32", "bf16", "f16"])
def test_flash_alibi_kernels_at_head_dim_256_match_plain(dtype, tol):
    """The ALiBi instantiation of K2, K5a and K5b at head dim 256, once a
    route: the tile-edge test above at GQA 32/8, S off the tiles, [B, H]
    slopes."""
    test_flash_alibi_kernels_match_plain_at_tile_edges(
        dtype, tol, 256, True, "ragged_gqa32_8")


# K5a's tensor-core route at its edges: b, S, Sk, causal, window, kv_lens
DQ_CASES = {
    "ragged_s": (2, 77, 77, True, None, None),
    "short_kv_row": (2, 150, 150, True, None, (150, 40)),
    "window": (2, 200, 200, True, 48, None),
    "dead_rows": (3, 5, 70, True, None, (70, 3, 0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("case", DQ_CASES.keys())
def test_flash_dq_tensor_core_route_matches_plain(dtype, d, group, case):
    """K5a's bf16 and f16 route (kernel_route "wgmma": dS rounded to q's
    type, as the Pallas kernel rounds it) against flash_attention_bwd_plain's
    dq within 2e-2 * (1 + |x|): S off the 64-row tiles, GQA groups 1-8, a
    kv_lens row shorter than one key tile, a sliding window, and rows with
    no live key (five queries end-aligned past kv_lens 3, and a row of
    kv_lens 0), whose dq is exactly 0. No atomics: two runs give identical
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    b, s, sk, causal, window, lens = DQ_CASES[case]
    hkv = 2
    h = hkv * group
    assert TF.kernel_route(dtype, d) == "wgmma"
    assert "flash_bwd_dq" in TF.ROUTED
    g = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, do = rnd(b, s, h, d), rnd(b, s, h, d)
    k, v = rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    args = (causal, d ** -0.5, window, kl)
    o, lse = TF.flash_fwd_cuda(q, k, v, *args)
    _, keep = TF._masked_scores(q, k, causal, 1.0, window, kl)
    live = keep.any(-1)[:, 0].expand(b, s)                  # [B, S]
    padded = live
    if kl is not None and s == sk:
        padded = live & (torch.arange(s, device=dev)[None, :] < kl[:, None])
    do = do * padded[:, :, None, None]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    n0 = TF.flash_bwd_dq.launches
    code = TF._check_cuda(q, k, v, "dq")
    runs = [TF.flash_bwd_dq(code, q, k, v, do, lse, delta, *args)
            for _ in range(2)]
    assert TF.flash_bwd_dq.launches == n0 + 2
    assert torch.equal(runs[0], runs[1])
    ref = TF.flash_attention_bwd_plain(q, k, v, o, lse, do, *args)[0]
    assert runs[0].dtype == ref.dtype == dtype
    err = (runs[0].float() - ref.float()).abs() / (1 + ref.float().abs())
    assert float(err.max()) <= 2e-2
    if case == "dead_rows":
        assert int((~live).sum()) == 2 + 5
        assert not runs[0][~live].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("trans", [False, True], ids=["forward", "dlhs"])
@pytest.mark.parametrize("k,n", [(72, 200), (2048, 256)],
                         ids=["k72", "k2048"])
def test_grouped_fwd_tensor_core_route_matches_plain(dtype, trans, k, n):
    """K6a's bf16 and f16 route (fwd_route "wgmma"), forward and read transposed
    (dlhs), against grouped_matmul_plain within 2e-2 * (1 + |x|) over
    empty groups and groups of 1, 63, 64, 65, 129 and 300 rows (tails of
    the 64-row warpgroups and 128-row tiles), at a k off the 64-wide slabs
    and at full slabs (k 2048). Rows past the ragged total are not written
    (the launch fills a NaN buffer); two runs give identical bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    sizes = [0, 63, 1, 64, 65, 0, 129, 300, 0]
    e, total = len(sizes), sum(sizes)
    m = total + 5
    g = torch.Generator(device=dev).manual_seed(8)
    lhs = torch.randn(m, k, generator=g, device=dev).to(dtype)
    shape = (e, n, k) if trans else (e, k, n)
    rhs = (torch.randn(*shape, generator=g, device=dev) * k ** -0.5
           ).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert TG.fwd_route(m, e, k, n, dtype, trans) == "wgmma"
    n0 = TG.grouped_matmul.launches
    runs = [TG.grouped_fwd_cuda(lhs, rhs, gs, trans) for _ in range(2)]
    assert TG.grouped_matmul.launches == n0 + 2
    assert torch.equal(runs[0][:total], runs[1][:total])
    ref = TG.grouped_matmul_plain(lhs, rhs, gs, trans)
    err = ((runs[0][:total].float() - ref[:total].float()).abs()
           / (1 + ref[:total].float().abs()))
    assert float(err.max()) <= 2e-2
    out = torch.full((m, n), float("nan"), dtype=dtype, device=dev)
    lib = TG._lib()
    rc = lib.grouped_fwd(_build.dtype_code(lhs, "k6"), int(trans),
                         TG._KIND["wgmma"], lhs.data_ptr(), rhs.data_ptr(),
                         gs.data_ptr(), out.data_ptr(), m, k, n, e,
                         torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(out[:total], runs[0][:total])
    assert bool(out[total:].isnan().all())


def _plain_drhs(lhs, g, sizes, e):
    """drhs of the plain backward (it needs a weight only for its shape)."""
    rhs = torch.empty(e, lhs.shape[1], g.shape[1], dtype=lhs.dtype,
                      device=lhs.device)
    return TG.grouped_matmul_bwd_plain(lhs, rhs, sizes, g)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("case", ["ragged_k200_n264", "train_gate_up",
                                  "train_down"])
def test_grouped_dw_tensor_core_route_matches_plain(dtype, case):
    """K6b's bf16 and f16 route (dw_route "wgmma") against the plain drhs within
    2e-2 * (1 + |x|): over groups of 0, 1, 63, 64, 65, 130, 0 and 700 rows
    at k 200, n 264 (no multiples of the 128 x 256 tile), with rows past
    the ragged total that hold inf (lhs) and NaN (g) and must not be
    read, and at Qwen1.5-MoE-A2.7B's two train shapes (16 384 routed rows
    over 60 experts; k 2048, n 2816 and k 1408, n 2048). Every empty
    group's drhs is exactly 0; two launches give identical bits; each
    launch is counted, on the tensor-core kernel's own count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    if case == "ragged_k200_n264":
        sizes = [0, 1, 63, 64, 65, 130, 0, 700]
        k, n, pad = 200, 264, 7
    else:
        k, n = (2048, 2816) if case == "train_gate_up" else (1408, 2048)
        choice = torch.rand(4096, 60, generator=g, device=dev).topk(4).indices
        sizes = torch.bincount(choice.reshape(-1), minlength=60).tolist()
        pad = 0
    e, total = len(sizes), sum(sizes)
    lhs = torch.randn(total + pad, k, generator=g, device=dev).to(dtype)
    cot = torch.randn(total + pad, n, generator=g, device=dev).to(dtype)
    lhs[total:] = float("inf")
    cot[total:] = float("nan")
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert TG.dw_route(total + pad, e, k, n, dtype) == "wgmma"
    n0 = TG.grouped_dw.launches
    w0 = TG.grouped_dw.route_launches["wgmma"]
    runs = [TG.grouped_dw(lhs, cot, gs) for _ in range(2)]
    assert TG.grouped_dw.launches == n0 + 2
    assert TG.grouped_dw.route_launches["wgmma"] == w0 + 2
    assert torch.equal(runs[0], runs[1])
    assert runs[0].shape == (e, k, n) and runs[0].dtype == dtype
    ref = _plain_drhs(lhs[:total], cot[:total], gs, e)
    err = (runs[0].float() - ref.float()).abs() / (1 + ref.float().abs())
    assert float(err.max()) <= 2e-2
    empty = gs == 0
    assert float(runs[0][empty].abs().sum()) == 0.0


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu_and_launches_its_kernels():
    """Three AdamW steps of a 2-layer model at head_dim 128 in float32:
    the card (K1, K2, K5) and the CPU (plain versions) give the same
    losses to fp32 rounding, and the card launches every train kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512)
    ids = np.random.RandomState(0).randint(0, 512, (2, 96))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    losses = []
    for model in (cpu, card):
        K.reset_launches()
        opt = O.AdamW(learning_rate=1e-3, weight_decay=0.1,
                      grad_clip=O.ClipGradByGlobalNorm(1.0))
        state = init_state(model, opt)
        step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
        dev = next(model.parameters()).device
        run = []
        for _ in range(3):
            state, loss = step(state, torch.as_tensor(ids, device=dev),
                               torch.as_tensor(labels, device=dev))
            run.append(float(loss))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.TRAIN_KERNELS), counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("sizes,n,rows_kernel", [
    ([5, 0, 1, 130, 0, 70, 1, 0], 200, False),       # the tiled kernel
    ([1, 0, 2, 0, 0, 17, 1, 0, 3, 0], 200, True),    # the decode route
    ([1, 0, 2, 0, 0, 17, 1, 0, 3, 0], 50, False),    # n its loads cannot take
], ids=["tiled", "few_rows", "few_rows_odd_n"])
def test_grouped_matmul_kernels_match_plain(dtype, tol, sizes, n, rows_kernel):
    """K6a (forward, by either kernel, and, transposed, dlhs) and K6b
    (drhs) against the plain versions on a ragged partition with empty and
    one-row groups, m, k and n not multiples of the tiles; an empty
    group's drhs is exactly 0; the autograd wrapper launches K6a twice and
    K6b once, on the kernel dw_route names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    e, k = len(sizes), 72
    m = sum(sizes)
    lhs = torch.randn(m, k, generator=g, device=dev).to(dtype)
    rhs = torch.randn(e, k, n, generator=g, device=dev).to(dtype)
    cot = torch.randn(m, n, generator=g, device=dev).to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    assert (TG.fwd_route(m, e, k, n, dtype) == "decode") == rows_kernel
    assert TG.fwd_route(m, e, n, k, dtype, trans=True) != "decode"

    def close(a, b):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        d = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(d.max()) <= tol

    n0 = (TG.grouped_matmul.launches, TG.grouped_dw.launches)
    dw_kernel = TG.dw_route(m, e, k, n, dtype)
    w0 = TG.grouped_dw.route_launches[dw_kernel]
    lhs.requires_grad_()
    rhs.requires_grad_()
    out = TG.grouped_matmul(lhs, rhs, gs)
    out.backward(cot)
    assert (TG.grouped_matmul.launches, TG.grouped_dw.launches) == (
        n0[0] + 2, n0[1] + 1)
    assert TG.grouped_dw.route_launches[dw_kernel] == w0 + 1
    with torch.no_grad():
        close(out, TG.grouped_matmul_plain(lhs, rhs, gs))
        dlhs, drhs = TG.grouped_matmul_bwd_plain(lhs, rhs, gs, cot)
    close(lhs.grad, dlhs)
    close(rhs.grad, drhs)
    empty = torch.tensor([s == 0 for s in sizes], device=dev)
    assert float(rhs.grad[empty].abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_moe_engine_on_card_matches_cpu_and_is_deterministic(family):
    """An MoE family served on the card in float32 (every kernel, the
    grouped GEMM included) gives the CPU's greedy streams (plain
    versions); the same decode tick run twice gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models import paged as P
    from paddle_tpu_torch.models.mixtral import (MixtralConfig,
                                                 MixtralForCausalLM)
    from paddle_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                   Qwen2MoeForCausalLM)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    kw = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
              vocab_size=512, num_hidden_layers=2)
    if family == "mixtral":
        cls, cfg = MixtralForCausalLM, MixtralConfig.tiny(
            intermediate_size=96, num_local_experts=6, **kw)
    else:
        cls, cfg = Qwen2MoeForCausalLM, Qwen2MoeConfig.tiny(
            moe_intermediate_size=80, shared_expert_intermediate_size=160,
            num_experts=10, num_experts_per_tok=4, **kw)
    cpu = cls(cfg, device="cpu")
    card = cls(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n) for n in (5, 30, 70, 9)]
    streams = []
    for model in (cpu, card):
        K.reset_launches()
        eng = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=32,
                        max_seq_len=128)
        ids = [eng.add_request(Request(p, max_new_tokens=8)) for p in prompts]
        eng.run()
        eng.assert_quiescent()
        streams.append([eng.requests[i].tokens for i in ids])
    assert streams[0] == streams[1]
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.MOE_SERVE_KERNELS), counts
    # one decode step from the same cache state, twice: identical bits
    outs = []
    for _ in range(2):
        cache = P.PagedKVCache.init(2, 16, 16, 1, 128, 2, 4, cfg.dtype,
                                    device="cuda")
        ids = torch.as_tensor(np.stack([np.resize(prompts[1], 32),
                                        np.resize(prompts[2], 32)]),
                              device="cuda")
        P.moe_prefill_paged(card, ids, np.array([30, 32], np.int32), cache,
                            slot_ids=np.arange(2, dtype=np.int32),
                            table_rows=np.arange(8, dtype=np.int32).reshape(
                                2, 4))
        logits, _ = P.moe_decode_step_paged(
            card, torch.tensor([7, 11], device="cuda"), cache,
            torch.ones(2, dtype=torch.bool, device="cuda"))
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_moe_train_step_on_card_matches_cpu_and_launches_its_kernels():
    """Three AdamW steps of a 2-layer Mixtral at head_dim 128 in float32:
    the card (K1, K2, K5, K6a, K6b) and the CPU (plain versions) give the
    same losses to fp32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.mixtral import (MixtralConfig,
                                                 MixtralForCausalLM)
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = MixtralConfig.tiny(hidden_size=256, intermediate_size=96,
                             num_attention_heads=2, num_key_value_heads=1,
                             vocab_size=512, num_local_experts=6)
    ids = np.random.RandomState(0).randint(0, 512, (2, 96))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    cpu = MixtralForCausalLM(cfg, device="cpu")
    card = MixtralForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    losses = []
    for model in (cpu, card):
        K.reset_launches()
        opt = O.AdamW(learning_rate=1e-3, weight_decay=0.1,
                      grad_clip=O.ClipGradByGlobalNorm(1.0))
        state = init_state(model, opt)
        step = make_train_step(lambda m, i, lab: m.loss(i, lab), opt)
        dev = next(model.parameters()).device
        run = []
        for _ in range(3):
            state, loss = step(state, torch.as_tensor(ids, device=dev),
                               torch.as_tensor(labels, device=dev))
            run.append(float(loss))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.MOE_TRAIN_KERNELS), counts


def _int8_pool(g, dev, n, bs, h_kv, d):
    """int8 codes and fp32 per-(position, head) scales, as the serving
    path's quantize-on-write stores them."""
    f = torch.randn(n, bs, h_kv, d, generator=g, device=dev)
    scale = torch.clamp(f.abs().amax(-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_paged_kernels_int8_pools_match_plain(dtype, tol, d, group):
    """K4 and K3 over int8 pools with fp32 scales against their plain
    versions on the same codes: ragged lengths, a sentinel table slot, a
    window, a dead row (0 on the card by design); only the int8 counters
    rise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.ops import cuda as K
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d + group)
    h_kv = 2
    h = h_kv * group
    kq, ks = _int8_pool(g, dev, 20, 16, h_kv, d)
    vq, vs = _int8_pool(g, dev, 20, 16, h_kv, d)
    sc = dict(k_scale=ks, v_scale=vs)
    tables = torch.randperm(20, generator=g, device=dev)[:12].reshape(3, 4)
    tables = torch.cat([tables, torch.full((3, 1), 20, device=dev)], 1).int()

    def close(a, b):
        dd = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(dd.max()) <= tol

    K.reset_launches()
    qd = torch.randn(3, h, d, generator=g, device=dev).to(dtype)
    for window in (None, 9):
        dl = torch.tensor([64, 1, 33], device=dev)
        close(TPA.paged_decode_attention(qd, kq, vq, tables, dl,
                                         window=window, **sc),
              TPA.paged_decode_attention_plain(qd, kq, vq, tables, dl,
                                               window=window, **sc))
        dead = TPA.paged_decode_attention(qd, kq, vq, tables,
                                          torch.tensor([5, 0, 2], device=dev),
                                          window=window, **sc)
        assert float(dead[1].abs().max()) == 0.0    # dead row writes 0
        qc = torch.randn(3, 20, h, d, generator=g, device=dev).to(dtype)
        offs = torch.tensor([0, 40, 10], device=dev)
        cls = torch.tensor([20, 7, 0], device=dev)
        got = TPA.paged_chunk_attention(qc, kq, vq, tables, offs, cls,
                                        window=window, **sc)
        ref = TPA.paged_chunk_attention_plain(qc, kq, vq, tables, offs, cls,
                                              window=window, **sc)
        close(got[0], ref[0])
        close(got[1, :7], ref[1, :7])
        assert float(got[2].abs().max()) == 0.0      # dead row writes 0
    counts = K.launches()
    assert counts["paged_decode_i8"] == 4 and counts["paged_chunk_i8"] == 2
    assert counts["paged_decode"] == counts["paged_chunk"] == 0


@pytest.mark.cuda
def test_int8_engine_on_card_launches_the_int8_kernels():
    """The serving path over an int8 KV pool on the card (weight-only int8
    weights, float32 activations): every request finishes, the engine
    ends quiescent, the streams track the CPU's plain path, and K3/K4 run
    in their int8 mode only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving.quant import quantize_for_serving
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n) for n in (5, 30, 70, 9)]
    prompts.append(np.concatenate([prompts[2][:40], rs.randint(0, 512, 7)]))
    streams = []
    for model in (cpu, card):
        quantize_for_serving(model, "weight_only_int8")
        K.reset_launches()
        eng = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=32,
                        max_seq_len=128, kv_dtype="int8")
        ids = [eng.add_request(Request(p, max_new_tokens=8)) for p in prompts]
        eng.run()
        eng.assert_quiescent()
        streams.append([eng.requests[i].tokens for i in ids])
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.QUANT_SERVE_KERNELS), counts
    assert counts["paged_decode"] == counts["paged_chunk"] == 0, counts
    # an fp32 rounding difference can move one int8 code, so the streams
    # are held to agree on most tokens, not all
    pairs = [(a, b) for s0, s1 in zip(*streams) for a, b in zip(s0, s1)]
    assert np.mean([a == b for a, b in pairs]) >= 0.9


@pytest.mark.cuda
def test_sdpa_on_card_refuses_what_no_kernel_computes():
    """On the card, a head dim with no flash kernel (96) raises: no plain
    version stands in for a kernel mode that is still to port. ALiBi,
    refused here until K2 computed it, launches K2's ALiBi mode (its
    counter, not K2's) and agrees with the CPU. A windowed decode with
    kv_lens, which the reference's kernel refuses too, takes the eager
    path (the flash counter stays put) and agrees with the CPU; head dim
    128 launches K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 4, 128, generator=g).cuda()
               for _ in range(3))
    sl = torch.rand(4, generator=g).cuda()
    K.reset_launches()
    got = scaled_dot_product_attention(q, k, v, alibi_slopes=sl)
    want = scaled_dot_product_attention(q.cpu(), k.cpu(), v.cpu(),
                                        alibi_slopes=sl.cpu())
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert K.launches()["flash_fwd_alibi"] == 1
    assert K.launches()["flash_fwd"] == 0
    with pytest.raises(NotImplementedError, match="head_dim 96"):
        scaled_dot_product_attention(
            *(t[..., :96].contiguous() for t in (q, k, v)), is_causal=True)
    qd = torch.randn(2, 1, 4, 128, generator=g)
    kd, vd = (torch.randn(2, 12, 2, 128, generator=g) for _ in range(2))
    lens = torch.tensor([12, 7])
    want = scaled_dot_product_attention(qd, kd, vd, is_causal=True,
                                        window=4, kv_lens=lens)
    got = scaled_dot_product_attention(qd.cuda(), kd.cuda(), vd.cuda(),
                                       is_causal=True, window=4,
                                       kv_lens=lens.cuda())
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert K.launches()["flash_fwd"] == 0
    scaled_dot_product_attention(q, k, v, is_causal=True)
    assert K.launches()["flash_fwd"] == 1


# name -> (model module, config kw at head dim 64, 2 layers, fp32)
ALIBI_FAMILIES = {
    "bloom": ("bloom", "BloomConfig", "BloomForCausalLM",
              dict(hidden_size=256, n_head=4, vocab_size=512)),
    "falcon_rw": ("falcon", "FalconConfig", "FalconForCausalLM",
                  dict(hidden_size=256, num_attention_heads=4, vocab_size=512,
                       alibi=True, bias=True, multi_query=False,
                       parallel_attn=False)),
    "falcon_7b_shape": ("falcon", "FalconConfig", "FalconForCausalLM",
                        dict(hidden_size=512, num_attention_heads=8,
                             vocab_size=512)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ALIBI_FAMILIES)
def test_bloom_falcon_on_card_match_cpu_and_launch_their_kernels(family):
    """generic_generate (greedy) and two make_train_step steps of a 2-layer
    model at head dim 64 in float32: the card (K2/K5 in their ALiBi mode
    for BLOOM and falcon-rw; K2 at GQA 8:1 and K7 for the falcon-7b block)
    and the CPU (plain versions) give the same tokens and the same losses
    to fp32 rounding, and the card launches the path's kernels and not the
    other mode's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import importlib

    import numpy as np

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.decoding import generic_generate
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    mod, cfg_name, cls_name, kw = ALIBI_FAMILIES[family]
    m = importlib.import_module(f"paddle_tpu_torch.models.{mod}")
    cfg = getattr(m, cfg_name).tiny(initializer_range=0.2, **kw)
    cpu = getattr(m, cls_name)(cfg, device="cpu")
    card = getattr(m, cls_name)(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    prompts = np.random.RandomState(0).randint(0, 512, (3, 40))
    K.reset_launches()
    streams = [generic_generate(model, prompts, max_new_tokens=6).cpu()
               for model in (cpu, card)]
    assert torch.equal(*streams)
    counts = K.launches()
    want = (K.ALIBI_SERVE_KERNELS if getattr(cfg, "alibi", True)
            else K.ROPE_GENERATE_KERNELS)
    other = ("flash_fwd" if want is K.ALIBI_SERVE_KERNELS
             else "flash_fwd_alibi")
    assert all(counts[k] > 0 for k in want) and counts[other] == 0, counts
    ids = prompts[:2]
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    losses = []
    for model in (cpu, card):
        K.reset_launches()
        opt = O.AdamW(learning_rate=1e-3, weight_decay=0.1,
                      grad_clip=O.ClipGradByGlobalNorm(1.0))
        state = init_state(model, opt)
        step = make_train_step(lambda mm, i, lab: mm.loss(i, lab), opt)
        dev = next(model.parameters()).device
        run = []
        for _ in range(2):
            state, loss = step(state, torch.as_tensor(ids, device=dev),
                               torch.as_tensor(labels, device=dev))
            run.append(float(loss))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    if want is K.ALIBI_SERVE_KERNELS:
        counts = K.launches()
        assert all(counts[k] > 0 for k in K.ALIBI_TRAIN_KERNELS), counts


# name -> (model module, config and model classes, config kw at head dim
# 256, 2 layers, fp32): Gemma at GQA 8:1 with remat, GPT-J's interleaved
# rope on 64 of 256 lanes
HD256_FAMILIES = {
    "gemma": ("gemma", "GemmaConfig", "GemmaForCausalLM",
              dict(hidden_size=256, intermediate_size=512,
                   num_attention_heads=8, num_key_value_heads=1,
                   head_dim=256, vocab_size=512, remat=True)),
    "gptj": ("gptj", "GPTJConfig", "GPTJForCausalLM",
             dict(n_embd=512, n_head=2, rotary_dim=64, vocab_size=512)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", HD256_FAMILIES)
def test_gemma_gptj_on_card_match_cpu_and_launch_their_kernels(
        family, monkeypatch):
    """A 2-layer model at head dim 256 in float32 on the card (K2, K5a, K5b
    on the FMA route at 256; Gemma's rope on K7) and on the CPU (plain
    versions): the prompt logits within 5e-4 * (1 + |x|) (at std 0.2 the
    attention is peaky: the CPU's own fp32 logits are 1.5e-4 (GPT-J) and
    7.8e-5 (Gemma) from a float64 run, so two fp32 runs may differ by
    twice that), the same greedy
    tokens through generic_generate and the same losses over two
    make_train_step steps to fp32 rounding. The card launches the flash
    kernels (Gemma's remat: two forwards a layer and step) and never
    ``eager_attention``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import importlib

    import numpy as np

    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.decoding import generic_generate
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step

    def no_eager(*a, **kw):
        raise AssertionError("eager_attention ran on the head dim 256 path")
    monkeypatch.setattr(A, "eager_attention", no_eager)
    mod, cfg_name, cls_name, kw = HD256_FAMILIES[family]
    m = importlib.import_module(f"paddle_tpu_torch.models.{mod}")
    cfg = getattr(m, cfg_name).tiny(initializer_range=0.2, **kw)
    cpu = getattr(m, cls_name)(cfg, device="cpu")
    card = getattr(m, cls_name)(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    prompts = np.random.RandomState(0).randint(0, 512, (3, 40))
    with torch.no_grad():
        want = cpu(torch.as_tensor(prompts))
        got = card(torch.as_tensor(prompts, device="cuda")).cpu()
    assert float(((got - want).abs() / (1 + want.abs())).max()) <= 5e-4
    K.reset_launches()
    streams = [generic_generate(model, prompts, max_new_tokens=6).cpu()
               for model in (cpu, card)]
    assert torch.equal(*streams)
    counts = K.launches()
    assert counts["flash_fwd"] == 6 * 2 and counts["flash_fwd_alibi"] == 0
    ids = prompts[:2]
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    losses = []
    for model in (cpu, card):
        K.reset_launches()
        opt = O.AdamW(learning_rate=1e-3, weight_decay=0.1,
                      grad_clip=O.ClipGradByGlobalNorm(1.0))
        state = init_state(model, opt)
        step = make_train_step(lambda mm, i, lab: mm.loss(i, lab), opt)
        dev = next(model.parameters()).device
        run = []
        for _ in range(2):
            state, loss = step(state, torch.as_tensor(ids, device=dev),
                               torch.as_tensor(labels, device=dev))
            run.append(float(loss))
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    counts = K.launches()
    fwd = 2 * 2 * (2 if cfg.remat else 1)      # steps x layers x forwards
    assert counts["flash_fwd"] == fwd, counts
    assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 4, counts


# ----------------------------------------- K3 and K4 at every group
# pool modes: (q dtype, int8 pool?, tolerance)
PAGED_MODES = {"f32": (torch.float32, False, 1e-4),
               "bf16": (torch.bfloat16, False, 2e-2),
               "int8": (torch.bfloat16, True, 2e-2),
               "f16": (torch.float16, False, 2e-2),
               "int8_f16": (torch.float16, True, 2e-2)}
STALE = 1e4     # planted in pool rows no table row may read


def _paged_case(g, dev, mode, rows_live, n, bs, h_kv, d):
    """K/V pools in ``mode`` whose positions outside ``rows_live`` (a
    [N, bs] bool: a table row reads it) hold finite garbage of magnitude
    STALE, returned with the kwargs of the mode (int8 scales)."""
    dt, int8, _ = PAGED_MODES[mode]
    out, kw = [], {}
    for name in ("k", "v"):
        f = torch.randn(n, bs, h_kv, d, generator=g, device=dev)
        sign = torch.randint(0, 2, f.shape, generator=g, device=dev) * 2 - 1
        f = torch.where(rows_live[:, :, None, None], f, STALE * sign)
        if int8:
            f, sc = _int8_pool_of(f)
            kw[f"{name}_scale"] = sc
        out.append(f.to(torch.int8) if int8 else f.to(dt))
    return out[0], out[1], kw


def _int8_pool_of(f):
    scale = torch.clamp(f.abs().amax(-1), min=1e-8) / 127.0
    return torch.clamp(torch.round(f / scale[..., None]), -127, 127), scale


def _live_rows(tables, ends, n, bs):
    """[N, bs] bool: the pool positions some table row reads below its
    end (lens, or offsets + chunk_lens)."""
    live = torch.zeros(n, bs, dtype=torch.bool, device=tables.device)
    for row, end in zip(tables.tolist(), ends.tolist()):
        for j, blk in enumerate(row):
            if blk < n and j * bs < end:
                live[blk, :min(bs, end - j * bs)] = True
    return live


def _unowned(g, tables, n):
    """The table with about every third entry another shard's (N)."""
    drop = torch.rand(tables.shape, generator=g, device=tables.device) < 0.34
    return torch.where(drop, torch.full_like(tables, n), tables)


def _close_scaled(a, b, tol, what=""):
    if not b.numel():
        return
    a, b = a.float(), b.float()
    err = (a - b).abs() / (1 + b.abs())
    assert float(err.max()) <= tol, (what, float(err.max()))


def _close_partials(got, ref, tol):
    """A partials triple against the plain one: m and l under the scaled
    rule, and acc in units of its own l (acc / l, 0 where l == 0). The
    tensor-core route rounds P to bf16 before P V, as K2 and the plain
    attention do, while the plain partials keep P in fp32, so acc's error
    grows with l; acc / l is what a merge's result is made of."""
    for x in got:
        assert x.dtype == torch.float32
    (acc, m, l), (acc_r, m_r, l_r) = got, ref
    _close_scaled(m, m_r, tol, "m")
    _close_scaled(l, l_r, tol, "l")
    _close_scaled(acc / torch.clamp(l, min=1e-30)[..., None],
                  acc_r / torch.clamp(l_r, min=1e-30)[..., None], tol,
                  "acc / l")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PAGED_MODES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", range(1, 9))
def test_paged_decode_split_matches_plain(mode, d, group):
    """K4, its key range split over blocks, against its plain version:
    lens 0, 1, bs - 1, bs, each split boundary and +-1 around it, and
    the whole table; windows of one, two and three splits (their lower
    edges inside a pool block; the splits start there); garbage in every
    pool row past a row's length and in blocks no table holds; repeated
    launches bit-identical; partials (with another shard's entries inside
    the live range) against the plain partials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(100 * group + d)
    dt, _, tol = PAGED_MODES[mode]
    h_kv, bs, mb, rows, chunk = 2, 16, 32, 14, TPA.DEC_MIN_CHUNK
    h = h_kv * group
    assert TPA.decode_schedule(rows, h_kv, mb * bs) == (4, chunk)
    lens = [0, 1, bs - 1, bs, chunk, 2 * chunk, mb * bs - 1, mb * bs] + [
        k * chunk + e for k in (1, 2, 3) for e in (-1, 1)]   # boundaries
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    n = rows * mb + 8               # 8 blocks outside every table
    tables = torch.randperm(n, generator=g, device=dev)[:rows * mb].reshape(
        rows, mb).int()
    kp, vp, kw = _paged_case(g, dev, mode, _live_rows(tables, lens, n, bs),
                             n, bs, h_kv, d)
    q = torch.randn(rows, h, d, generator=g, device=dev).to(dt)
    for window in (None, 37, 200, 300):     # 200, 300: split windows
        got = TPA.paged_decode_attention(q, kp, vp, tables, lens,
                                         window=window, **kw)
        assert TPA.paged_decode_attention.nsplit == TPA.decode_schedule(
            rows, h_kv, mb * bs, window)[0]
        ref = TPA.paged_decode_attention_plain(q, kp, vp, tables, lens,
                                               window=window, **kw)
        _close_scaled(got[1:], ref[1:], tol, "o")
        assert float(got[0].abs().max()) == 0.0         # lens 0 writes 0
        assert torch.equal(got, TPA.paged_decode_attention(
            q, kp, vp, tables, lens, window=window, **kw))
        part = _unowned(g, tables, n)
        got = TPA.paged_decode_attention(q, kp, vp, part, lens,
                                         window=window, partials=True, **kw)
        _close_partials(got, TPA.paged_decode_attention_plain(
            q, kp, vp, part, lens, window=window, partials=True, **kw), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PAGED_MODES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", range(1, 9))
def test_paged_chunk_matches_plain_at_tile_edges(mode, d, group):
    """K3 on its route for the dtype (``chunk_route``) against its plain
    version: chunk lengths whose folded rows end just before, at and past
    a 64-row tile edge, offsets at and across a 64-key tile edge, a dead
    row, a window; garbage in pool rows past each row's length and in
    blocks no table holds; dead and padding rows exactly 0; two launches
    bit-identical; partials against the plain partials on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1000 + 100 * group + d)
    dt, _, tol = PAGED_MODES[mode]
    h_kv, bs, c = 2, 16, 80
    h = h_kv * group
    edge = 64 // group              # queries a 64-folded-row tile holds
    cls = [c, edge, edge + 1, max(edge - 1, 1), 0, min(130 // group, c)]
    offs = [0, 63, 64, 65, 7, 127]
    mb = -(-max(o + n for o, n in zip(offs, cls)) // bs)
    n = len(cls) * mb + 8
    tables = torch.randperm(n, generator=g, device=dev)[:len(cls) * mb]
    tables = tables.reshape(len(cls), mb).int()
    offs = torch.tensor(offs, dtype=torch.int32, device=dev)
    cls = torch.tensor(cls, dtype=torch.int32, device=dev)
    kp, vp, kw = _paged_case(g, dev, mode,
                             _live_rows(tables, offs + cls, n, bs), n, bs,
                             h_kv, d)
    q = torch.randn(len(cls), c, h, d, generator=g, device=dev).to(dt)
    assert TPA.chunk_route(dt) == ("fma" if dt == torch.float32 else "wgmma")
    for window in (None, 50):
        got = TPA.paged_chunk_attention(q, kp, vp, tables, offs, cls,
                                        window=window, **kw)
        ref = TPA.paged_chunk_attention_plain(q, kp, vp, tables, offs, cls,
                                              window=window, **kw)
        for a, m in enumerate(cls.tolist()):
            _close_scaled(got[a, :m], ref[a, :m], tol, f"row {a}")
            assert float(got[a, m:].float().abs().sum()) == 0.0
        assert torch.equal(got, TPA.paged_chunk_attention(
            q, kp, vp, tables, offs, cls, window=window, **kw))
        part = _unowned(g, tables, n)
        got = TPA.paged_chunk_attention(q, kp, vp, part, offs, cls,
                                        window=window, partials=True, **kw)
        _close_partials(got, TPA.paged_chunk_attention_plain(
            q, kp, vp, part, offs, cls, window=window, partials=True, **kw),
            tol)


@pytest.mark.cuda
def test_paged_decode_does_not_synchronise():
    """One K4 launch at Mistral-7B's window shape (4 rows over 4096 of
    4704 keys, GQA 32/8) under ``set_sync_debug_mode("error")``: the
    wrapper never reads lens or anything else back from the card, and the
    launch runs split (nsplit > 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    kp = torch.randn(1200, 16, 8, 128, generator=g, device=dev).bfloat16()
    vp = torch.randn(1200, 16, 8, 128, generator=g, device=dev).bfloat16()
    tables = torch.randperm(1200, generator=g, device=dev)[:4 * 294]
    tables = tables.reshape(4, 294).int()
    lens = torch.tensor([4248, 4398, 4528, 4648], dtype=torch.int32,
                        device=dev)
    q = torch.randn(4, 32, 128, generator=g, device=dev).bfloat16()
    TPA.paged_decode_attention(q, kp, vp, tables, lens, window=4096)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TPA.paged_decode_attention(q, kp, vp, tables, lens,
                                         window=4096)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert TPA.paged_decode_attention.nsplit > 1
    _close_scaled(out, TPA.paged_decode_attention_plain(
        q, kp, vp, tables, lens, window=4096), 2e-2)


@pytest.mark.cuda
def test_qwen2_group7_engine_on_card_matches_cpu():
    """A narrow Qwen2 with Qwen2's GQA group of 7 (14 heads of 64 over 2
    KV heads, 2 layers, float32) served by ``LLMEngine`` on the card gives
    the CPU run's greedy streams, through K3 (chunked prefill) and K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.qwen import Qwen2Config, Qwen2ForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    cfg = Qwen2Config.tiny(hidden_size=896, intermediate_size=1024,
                           num_attention_heads=14, num_key_value_heads=2,
                           vocab_size=512)
    cpu = Qwen2ForCausalLM(cfg, device="cpu")
    card = Qwen2ForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 512, n) for n in (5, 30, 70, 9)]
    streams = []
    for model in (cpu, card):
        K.reset_launches()
        eng = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=32,
                        max_seq_len=128)
        ids = [eng.add_request(Request(p, max_new_tokens=8)) for p in prompts]
        eng.run()
        eng.assert_quiescent()
        streams.append([eng.requests[i].tokens for i in ids])
    assert streams[0] == streams[1]
    counts = K.launches()
    assert all(counts[k] > 0 for k in K.SERVE_KERNELS), counts


# ------------------------------------------------ the decode tick's graph
def _graph_model(case):
    """A narrow model of ``case`` on the card (head dims 64/128, 2 layers)
    and the engine arguments that case serves with."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.mistral import (MistralConfig,
                                                 MistralForCausalLM)
    from paddle_tpu_torch.models.mixtral import (MixtralConfig,
                                                 MixtralForCausalLM)
    kw = dict(hidden_size=256, intermediate_size=512, num_attention_heads=4,
              num_key_value_heads=2, vocab_size=512)
    f32 = dict(dtype=torch.float32)
    bf16 = dict(dtype=torch.bfloat16)
    if case == "mistral_window":
        return MistralForCausalLM(MistralConfig.tiny(
            sliding_window=24, **kw, **f32), device="cuda"), {}
    if case == "mixtral":
        cfg = MixtralConfig.tiny(
            hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
            vocab_size=512, intermediate_size=96, num_local_experts=6, **bf16)
        return MixtralForCausalLM(cfg, device="cuda"), {}
    extra = {}
    if case == "dynamic_ntk":
        extra = dict(rope_scaling={"type": "dynamic", "factor": 2.0},
                     max_position_embeddings=32)
    dt = f32 if case in ("llama_fp32", "dynamic_ntk") else bf16
    model = LlamaForCausalLM(LlamaConfig.tiny(**kw, **extra, **dt),
                             device="cuda")
    return model, ({"kv_dtype": "int8"} if case == "int8_pool" else {})


def _decoding_engine(model, slots=4, new=32, **kw):
    """An engine on the card with every slot decoding (prompts of 9-60
    tokens) and its tick graph captured."""
    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    eng = LLMEngine(model, num_slots=slots, block_size=16, max_prompt_len=64,
                    max_seq_len=128, seed=0, **kw)
    rs = np.random.RandomState(1)
    for n in (9, 30, 50, 60)[:slots]:
        eng.add_request(Request(rs.randint(0, 512, n), max_new_tokens=new))
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama_bf16", "llama_fp32", "int8_pool",
                                  "mistral_window", "dynamic_ntk", "mixtral"])
def test_graph_tick_matches_the_eager_tick(case):
    """The engine's decode tick on the card is a replay of the executor's
    CUDA graph: from one cache state it gives the eager
    ``llama_decode_tick``'s tokens, bit-identical log-probabilities and an
    identical cache, over every path the tick runs (bf16 and fp32 Llama,
    an int8 pool, Mistral's window, dynamic-NTK rope, Mixtral's routing
    and grouped GEMM); at temperature 0.8 two replays draw different
    noise and a replay from a restored generator state repeats the draw
    (``chip_smoke.graph_against_eager``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import chip_smoke
    model, kw = _graph_model(case)
    eng = _decoding_engine(model, **kw)
    res = chip_smoke.graph_against_eager(torch, eng)
    assert res["tokens_equal"] and res["logp_bit_equal"], res
    assert eng.exe.graph_pool_bytes > 0


@pytest.mark.cuda
def test_graph_replays_count_their_launches():
    """The wrappers count launches in Python, which runs at capture only:
    each replay adds the capture's counts, so five pure decode steps add
    five ticks' launches and the capture itself adds none. A pool of the
    model's type takes K7 folded with the pool write: one ``rope_kv``
    launch a layer, no ``rope``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.ops import cuda as K
    model, _ = _graph_model("llama_bf16")
    layers = model.cfg.num_hidden_layers
    eng = _decoding_engine(model)
    per_tick = eng.exe._tick.launches
    assert per_tick == {"rms_norm": 2 * layers + 1,
                        "paged_decode": layers, "rope_kv": layers}
    K.reset_launches()
    for _ in range(5):
        eng.step()
    counts = K.launches()
    assert {k: v for k, v in counts.items() if v} == {
        k: 5 * v for k, v in per_tick.items()}, counts


@pytest.mark.cuda
def test_graph_capture_failure_raises(monkeypatch):
    """A tick that cannot be captured (here: a host read inside the rope
    tables) raises out of the engine's constructor, which captures the
    tick; there is no eager fallback. The eager tick still runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.models import paged as P
    from paddle_tpu_torch.serving import LLMEngine
    model, _ = _graph_model("llama_fp32")
    orig = P._rope_rows
    reads = []

    def host_read(positions, *a, **kw):
        reads.append(float(positions.float().sum()))
        return orig(positions, *a, **kw)
    monkeypatch.setattr(P, "_rope_rows", host_read)
    with pytest.raises(RuntimeError):
        LLMEngine(model, num_slots=2, block_size=16, max_prompt_len=32,
                  max_seq_len=64)
    assert reads                    # the warm-up ran the tick eagerly
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kw,what", [
    (dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4),
     "head dim 16"),
    (dict(hidden_size=2048, num_attention_heads=16, num_key_value_heads=1),
     "GQA group 16"),
    (dict(hidden_size=512, num_attention_heads=2, num_key_value_heads=2),
     "head dim 256")], ids=["d16", "group16", "d256"])
def test_engine_refuses_kernel_refused_shapes_before_any_step(kw, what):
    """``LLMEngine`` on the card refuses a head dim outside 64/128 (256
    too: the flash kernels take it, the paged ones do not) or a GQA
    group above 8 in its constructor, naming the shape and the ROADMAP
    queue, before any pool, slot or block exists; the CPU engine serves
    the same model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import LLMEngine, Request
    cfg = LlamaConfig.tiny(num_hidden_layers=1, vocab_size=512, **kw)
    card = LlamaForCausalLM(cfg, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with pytest.raises(NotImplementedError,
                       match=f"{what}.*ROADMAP.md queue 2, Shapes the "
                             f"kernels refuse"):
        LLMEngine(card, num_slots=2, block_size=16, max_prompt_len=32,
                  max_seq_len=64)
    assert torch.cuda.memory_allocated() == before
    cpu = LlamaForCausalLM(cfg, device="cpu")
    eng = LLMEngine(cpu, num_slots=2, block_size=16, max_prompt_len=32,
                    max_seq_len=64)
    eng.add_request(Request(np.arange(1, 9), max_new_tokens=3))
    eng.run()
    eng.assert_quiescent()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_async_engine_on_card_matches_the_synchronous_engine(temperature):
    """``async_depth=2`` on the card (the async tick's graph, its loop
    state on the device) gives the synchronous engine's streams token for
    token, greedy and sampled, with EOS; the pipeline really cruised, and
    the generator after a fully masked async tick is where the
    synchronous engine leaves it (a sampled request served afterwards
    draws the same tokens)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    model, _ = _graph_model("llama_bf16")
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 512, n) for n in (9, 30, 50, 17, 44, 5)]
    later = rs.randint(0, 512, 12)
    probe = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=64,
                      max_seq_len=128)
    rid = probe.add_request(Request(prompts[0], max_new_tokens=20))
    probe.run()
    eos = probe.requests[rid].tokens[6]

    def serve(depth):
        eng = LLMEngine(model, num_slots=3, block_size=16, max_prompt_len=64,
                        max_seq_len=128, seed=3, eos_token_id=eos,
                        temperature=temperature, async_depth=depth)
        eng.exe.tick_log = []
        ids = [eng.add_request(Request(p, max_new_tokens=20))
               for p in prompts]
        eng.run()
        ids.append(eng.add_request(Request(later, max_new_tokens=20,
                                           temperature=1.0)))
        eng.run()
        eng.assert_quiescent()
        kinds = {k for k, *_ in eng.exe.tick_log}
        return [eng.requests[i].tokens for i in ids], kinds

    sync, kinds0 = serve(0)
    got, kinds2 = serve(2)
    assert got == sync
    assert kinds0 == {"sync"} and "async" in kinds2


# ------------------------------------- multi-LoRA and speculative decoding
@pytest.mark.cuda
@pytest.mark.parametrize("rank", [4, 8, 16])
@pytest.mark.parametrize("cap,sizes", [(4, (3, 0, 2, 1)), (1, (6,))])
@pytest.mark.parametrize("rows", [8, 8 * 128])
def test_grouped_matmul_at_lora_shapes_matches_plain(rank, cap, sizes,
                                                     rows):
    """K6a at the multi-LoRA shapes (fp32, the store's type): ``x [m,
    4096] x A [cap, 4096, r]`` and ``t [m, r] x B [cap, r, 12288 | 4096]``
    at decode (8 rows: the decode route) and at prefill (8 x 128 rows:
    the FMA route), with an empty group and a null-adapter tail past the
    groups' total (left out: the caller masks it), against the plain
    version; the route is ``fwd_route``'s from the static shapes, counted
    once by the wrapper, never the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(rank * 10 + cap)
    scale = rows // 8
    sz = torch.tensor([s * scale for s in sizes], dtype=torch.int32,
                      device=dev)
    live = torch.arange(rows, device=dev) < int(sz.sum())
    want_route = "decode" if rows == 8 else "fma"
    for k, n in ((4096, rank), (rank, 12288), (rank, 4096)):
        lhs = torch.randn(rows, k, generator=g, device=dev)
        rhs = torch.randn(cap, k, n, generator=g, device=dev) * k ** -0.5
        before = dict(TG.grouped_matmul.route_launches)
        got = TG.grouped_matmul(lhs, rhs, sz)
        after = TG.grouped_matmul.route_launches
        assert TG.fwd_route(rows, cap, k, n, torch.float32) == want_route
        assert {r: c - before[r] for r, c in after.items()
                if c != before[r]} == {want_route: 1}
        ref = TG.grouped_matmul_plain(lhs, rhs, sz)
        d = (got[live] - ref[live]).abs() / (1 + ref[live].abs())
        assert float(d.max()) <= 1e-4, (k, n)
    # a width no 16-byte load tiles is routed to the FMA kernel
    assert TG.fwd_route(8, cap, 4096, 6, torch.float32) == "fma"


def _lora_case(cap, width, k, n, r, dtype, seed):
    """A multi-LoRA batch on the card as the engine builds it: 8 slots of
    ``width`` tokens on cache indices with an empty group (cap 4) and a
    null tail of two slots; x [8, width, k] and y [8, width, n] in
    ``dtype``, A [cap, k, r] and B [cap, r, n] fp32."""
    import numpy as np
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    aidx = np.array((0, 2, -1, 0, 3, 2, 0, -1) if cap == 4
                    else (0, 0, -1, 0, 0, 0, -1, 0))
    order = np.argsort(np.where(aidx < 0, cap, aidx), kind="stable")
    gs = np.bincount(aidx[aidx >= 0], minlength=cap) * width
    x = torch.randn(8, width, k, generator=g, device=dev).to(dtype)
    y = torch.randn(8, width, n, generator=g, device=dev).to(dtype)
    a = torch.randn(cap, k, r, generator=g, device=dev) * k ** -0.5
    b = torch.randn(cap, r, n, generator=g, device=dev) * 0.1
    perm = torch.as_tensor(order.astype(np.int32), device=dev)
    sz = torch.as_tensor(gs.astype(np.int32), device=dev)
    null = torch.as_tensor(aidx < 0, device=dev)
    return x, y, a, b, perm, sz, null


def _scaled(a, b):
    return float(((a.float() - b.float()).abs()
                  / (1 + b.float().abs())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rank", [4, 8, 16])
@pytest.mark.parametrize("cap", [4, 1])
@pytest.mark.parametrize("width", [1, 5, 128])
def test_lora_kernels_match_plain(width, cap, rank, dtype):
    """K6a's multi-LoRA kernels at Llama-2-7B's LoRA shapes (k 4096, n
    12288 for qkv and 4096 for o) at decode, the verify width and prefill
    (8 slots of 1, 5 and 128 tokens), ranks 4, 8, 16, caps 4 (an empty
    group) and 1, a null tail: the shrink's t within 1e-5 of its plain
    version (fp32), the expand's y within 1e-5 (fp32) or one bf16 step
    (bf16 and f16, whose step is finer), the null-adapter rows of y
    untouched, one launch counted each, and two
    launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    for n in (3 * 4096, 4096):
        x, y, a, b, perm, sz, null = _lora_case(cap, width, 4096, n, rank,
                                                dtype, width + rank + cap)
        before = (TG.lora_shrink.launches, TG.lora_expand_add.launches)
        t = TG.lora_shrink(x, perm, a, sz)
        got = TG.lora_expand_add(y.clone(), t, b, sz, perm)
        assert (TG.lora_shrink.launches - before[0],
                TG.lora_expand_add.launches - before[1]) == (1, 1)
        assert _scaled(t, TG.lora_shrink_plain(x, perm, a, sz)) <= 1e-5
        want = TG.lora_expand_add_plain(y.clone(), t, b, sz, perm)
        assert _scaled(got, want) <= tol, n
        assert torch.equal(got[null], y[null])
        assert torch.equal(TG.lora_shrink(x, perm, a, sz), t)
        assert torch.equal(TG.lora_expand_add(y.clone(), t, b, sz, perm),
                           got)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [3, 12, 20, 40, 64])
def test_lora_kernels_at_other_ranks_match_plain(rank):
    """Ranks the LoRA serving shapes do not use: not a multiple of 4
    (A read one value at a time), above 16 (more than one column chunk
    of the shrink; the expand's 32- and 64-rank instantiations), fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    x, y, a, b, perm, sz, null = _lora_case(4, 3, 2048, 1024, rank,
                                            torch.float32, rank)
    t = TG.lora_shrink(x, perm, a, sz)
    assert _scaled(t, TG.lora_shrink_plain(x, perm, a, sz)) <= 1e-5
    got = TG.lora_expand_add(y.clone(), t, b, sz, perm)
    want = TG.lora_expand_add_plain(y.clone(), t, b, sz, perm)
    assert _scaled(got, want) <= 1e-5
    assert torch.equal(got[null], y[null])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 128])
def test_lora_shrink_never_reads_partials_past_live_rows(width):
    """The shrink's per-split partials are scratch from the caching
    allocator: the block it gets is first filled with NaN (freed just
    before the call, so the allocator hands the same block back). Rows
    past the groups' total are never written there and never read: t is
    0 on them and finite, equal to the plain version, on the live rows;
    with every row on the base, t is all 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    x, _, a, _, perm, sz, _ = _lora_case(4, width, 4096, 8, 16,
                                         torch.bfloat16, 3)
    m = 8 * width
    live = int(sz.sum())
    splits, _ = TG.lora_shrink_schedule(
        m, 4, 4096, 16,
        torch.cuda.get_device_properties(0).multi_processor_count)
    for sizes in (sz, torch.zeros_like(sz)):
        planted = torch.full((splits, m, 16), float("nan"), device="cuda")
        del planted
        t = TG.lora_shrink(x, perm, a, sizes)
        n_live = int(sizes.sum())
        assert not t[n_live:].any()
        assert torch.isfinite(t).all()
        assert _scaled(t, TG.lora_shrink_plain(x, perm, a, sizes)) <= 1e-5
    assert live < m


@pytest.mark.cuda
def test_engine_refuses_an_adapter_rank_the_expand_refuses():
    """An adapter store whose max_rank is above LORA_MAX_RANK is refused
    by ``LLMEngine`` on the card in its constructor, naming the rank and
    the ROADMAP queue; a store of that rank limit is served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving.adapters import AdapterStore
    model, _ = _lora_model_and_store()
    kw = dict(num_slots=2, block_size=16, max_prompt_len=32, max_seq_len=64)
    big = AdapterStore(model, capacity=1, max_rank=TG.LORA_MAX_RANK + 1)
    with pytest.raises(NotImplementedError,
                       match=f"adapter max_rank {TG.LORA_MAX_RANK + 1}.*"
                             f"ROADMAP.md queue 2"):
        LLMEngine(model, adapter_store=big, **kw)
    LLMEngine(model, adapter_store=AdapterStore(
        model, capacity=1, max_rank=TG.LORA_MAX_RANK), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8", "f16"])
def test_paged_chunk_at_verify_width_matches_plain(mode):
    """K3 at the speculative verify width: 8 rows of at most spec_k + 1 =
    5 queries (32 heads over 32 KV heads, D 128) at offsets whose chunk
    crosses a 16-token block boundary, over a float32, bf16 and int8 pool
    (fp32 scales), against the plain version; padding queries past each
    row's chunk length are left out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    nb, bs, h, d, mb = 64, 16, 32, 128, 32
    kp = torch.randn(nb, bs, h, d, generator=g, device=dev)
    vp = torch.randn(nb, bs, h, d, generator=g, device=dev)
    tables = torch.randperm(nb, generator=g, device=dev)[:8 * 8].reshape(
        8, 8)
    tables = torch.cat([tables, torch.full((8, mb - 8), nb, device=dev)],
                       1).int()
    offs = torch.tensor([15, 31, 47, 60, 79, 100, 111, 123], device=dev)
    cls = torch.tensor([5, 5, 4, 5, 3, 5, 2, 5], device=dev)
    q = torch.randn(8, 5, h, d, generator=g, device=dev)
    kw, tol = {}, 1e-4
    if mode == "int8":
        kq = torch.clamp(kp.abs().amax(-1), min=1e-8) / 127.0
        vq = torch.clamp(vp.abs().amax(-1), min=1e-8) / 127.0
        kw = dict(k_scale=kq, v_scale=vq)
        kp = torch.round(kp / kq[..., None]).to(torch.int8)
        vp = torch.round(vp / vq[..., None]).to(torch.int8)
        q, tol = q.bfloat16(), 2e-2
    elif mode == "bf16":
        q, kp, vp, tol = q.bfloat16(), kp.bfloat16(), vp.bfloat16(), 2e-2
    elif mode == "f16":
        q, kp, vp, tol = q.half(), kp.half(), vp.half(), 2e-2
    got = TPA.paged_chunk_attention(q, kp, vp, tables, offs, cls, **kw)
    ref = TPA.paged_chunk_attention_plain(q, kp, vp, tables, offs, cls,
                                          **kw)
    live = torch.arange(5, device=dev)[None, :] < cls[:, None]
    d_ = (got[live].float() - ref[live].float()).abs() / (
        1 + ref[live].float().abs())
    assert float(d_.max()) <= tol


def _lora_model_and_store(dtype=torch.bfloat16, capacity=2):
    """A narrow Llama on the card (head dim 128, 2 layers) and an adapter
    store over it; adapters from ``_lora_sd`` (``chip_smoke.lora_sd``)."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.adapters import AdapterStore
    model = LlamaForCausalLM(LlamaConfig.tiny(
        hidden_size=256, intermediate_size=512, num_attention_heads=2,
        num_key_value_heads=1, vocab_size=512, dtype=dtype), device="cuda")
    return model, AdapterStore(model, capacity=capacity, max_rank=8)


def _lora_sd(model, seed, r):
    import numpy as np

    import chip_smoke
    return chip_smoke.lora_sd(model, np, seed, r)


def _lora_decoding_engine(model, store, aids):
    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    eng = LLMEngine(model, adapter_store=store, num_slots=len(aids),
                    block_size=16, max_prompt_len=64, max_seq_len=128,
                    seed=0)
    rs = np.random.RandomState(1)
    for n, aid in zip((9, 30, 50, 60), aids):
        eng.add_request(Request(rs.randint(0, 512, n), max_new_tokens=32,
                                adapter_id=aid))
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["grouped", "gather"])
def test_lora_graph_tick_matches_the_eager_lora_tick(impl, monkeypatch):
    """With an adapter store the executor captures a third graph: the tick
    with the multi-LoRA correction (K6a's two LoRA kernels, or the dense
    gather baseline). From one cache state its replay gives the eager
    LoRA tick's tokens, bit-identical log-probabilities and cache (rows on
    two adapters and the base); its capture counted a shrink and an
    expand for each of a layer's two projections (grouped) or none
    (gather), and no launch of the general K6a routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    import chip_smoke
    monkeypatch.setenv("PT_MULTILORA_IMPL", impl)
    model, store = _lora_model_and_store()
    store.register("a", _lora_sd(model, 1, 8))
    store.register("b", _lora_sd(model, 2, 4))
    eng = _lora_decoding_engine(model, store, ["a", None, "b", "a"])
    lora = eng._lora_arg(np.where(eng.active, eng.slot_aidx, -1), 1)
    res = chip_smoke.graph_against_eager(torch, eng, lora=lora)
    assert res["tokens_equal"] and res["logp_bit_equal"], res
    assert res["cache_bit_equal"], res
    per = 2 * model.cfg.num_hidden_layers if impl == "grouped" else 0
    assert eng.exe._ltick.launches.get("lora_shrink", 0) == per
    assert eng.exe._ltick.launches.get("lora_expand", 0) == per
    assert eng.exe._ltick.launches.get("grouped_fwd", 0) == 0


@pytest.mark.cuda
def test_adapter_uploaded_after_capture_is_read_by_the_next_replay():
    """The LoRA graph is captured when the engine is built, before any
    adapter exists; an adapter registered and uploaded afterwards (in
    place into the store's stacks) is what the next replay reads: the
    replay equals the eager LoRA tick bit for bit, and its stream equals
    the same request served on the CPU (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    import chip_smoke
    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving.adapters import AdapterStore
    model, store = _lora_model_and_store(torch.float32)
    eng = LLMEngine(model, adapter_store=store, num_slots=2, block_size=16,
                    max_prompt_len=64, max_seq_len=128, seed=0)
    ptrs = {k: v.data_ptr() for k, v in store.stacks().items()}
    store.register("late", _lora_sd(model, 3, 8))
    rs = np.random.RandomState(4)
    prompt = rs.randint(0, 512, 20)
    eng.exe.tick_log = []
    rid = eng.add_request(Request(prompt, max_new_tokens=12,
                                  adapter_id="late"))
    eng.run()
    eng.assert_quiescent()
    assert {k: v.data_ptr() for k, v in store.stacks().items()} == ptrs
    assert {k for k, *_ in eng.exe.tick_log} == {"lora"}
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cpu = LlamaForCausalLM(model.cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cstore = AdapterStore(cpu, capacity=2, max_rank=8)
    cstore.register("late", _lora_sd(model, 3, 8))
    ceng = LLMEngine(cpu, adapter_store=cstore, num_slots=2, block_size=16,
                     max_prompt_len=64, max_seq_len=128, device="cpu")
    crid = ceng.add_request(Request(prompt, max_new_tokens=12,
                                    adapter_id="late"))
    ceng.run()
    assert eng.requests[rid].tokens == ceng.requests[crid].tokens
    store.register("late2", _lora_sd(model, 5, 8))
    eng2 = _lora_decoding_engine(model, store, ["late2", None])
    res = chip_smoke.graph_against_eager(
        torch, eng2, lora=eng2._lora_arg(
            np.where(eng2.active, eng2.slot_aidx, -1), 1))
    assert res["tokens_equal"] and res["logp_bit_equal"], res


@pytest.mark.cuda
def test_empty_store_leaves_the_base_graph_untouched():
    """An engine with an adapter store but no adapter row replays the
    base graph only, and its greedy streams and per-tick launches equal a
    storeless engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    model, store = _lora_model_and_store()
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 512, n) for n in (9, 30, 50, 17)]
    out = []
    for s in (None, store):
        eng = LLMEngine(model, adapter_store=s, num_slots=2, block_size=16,
                        max_prompt_len=64, max_seq_len=128, seed=0)
        eng.exe.tick_log = []
        ids = [eng.add_request(Request(p, max_new_tokens=16))
               for p in prompts]
        eng.run()
        eng.assert_quiescent()
        kinds = {k for k, *_ in eng.exe.tick_log}
        out.append(([eng.requests[i].tokens for i in ids], kinds,
                    eng.exe._tick.launches))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1] == {"sync"}
    assert out[0][2] == out[1][2]


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["self", "unrelated", "int8_pool"])
def test_spec_engine_on_card_matches_cpu(draft):
    """Speculative decoding on the card (fp32: the verify on K3, the draft
    through K1 and K7, the rewind) gives the CPU's greedy streams token
    for token, which equal the non-speculative engine's; over an int8
    pool the verify reads K3's int8 mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.serving import LLMEngine, Request
    kw = dict(hidden_size=256, intermediate_size=512, num_attention_heads=2,
              num_key_value_heads=1, vocab_size=512, dtype=torch.float32)
    models = {}
    for dev in ("cpu", "cuda"):
        t = LlamaForCausalLM(LlamaConfig.tiny(**kw), device=dev)
        d = (t if draft != "unrelated" else LlamaForCausalLM(
            LlamaConfig.tiny(**{**kw, "num_hidden_layers": 1}), device=dev,
            seed=1))
        models[dev] = (t, d)
    for n in ("cuda",):
        models[n][0].load_state_dict(models["cpu"][0].state_dict())
        models[n][1].load_state_dict(models["cpu"][1].state_dict())
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 512, n) for n in (9, 70, 33, 5)]
    ekw = dict(num_slots=3, block_size=16, max_prompt_len=64,
               max_seq_len=160, kv_dtype="int8" if draft == "int8_pool"
               else None)
    streams = {}
    K.reset_launches()
    for dev, (t, d) in models.items():
        for spec in (False, True):
            eng = LLMEngine(t, draft_model=d if spec else None, spec_k=4,
                            device=dev, **ekw)
            ids = [eng.add_request(Request(p, max_new_tokens=20))
                   for p in prompts]
            eng.run()
            eng.assert_quiescent()
            if spec:
                assert eng.stats["spec_ticks"] > 0
            streams[dev, spec] = [eng.requests[i].tokens for i in ids]
    assert streams["cuda", True] == streams["cpu", True] == \
        streams["cuda", False]
    k3 = "paged_chunk_i8" if draft == "int8_pool" else "paged_chunk"
    assert K.launches()[k3] > 0


# ------------------------- K6a's decode route and K7 folded with the pool
# ragged groups of the decode route: 0, 1, 4, 5, 8 and 32 rows (the group
# of 32 is four row tiles of the kernel)
DECODE_SIZES = (0, 1, 4, 0, 5, 8, 32, 1, 0, 4)


def _decode_case(dtype, k, n, seed, extra=0):
    """A routed decode batch on the card: xt [11, k] tokens, tok [m] the
    token of each sorted row, gate_up [e, k, n], gu [m, 2 k] (a gate_up
    product), down [e, k, n], gate [m] fp32, keep [m] bool (a third
    dropped), order [m] a permutation; m = sum(DECODE_SIZES) + extra."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    e, m = len(DECODE_SIZES), sum(DECODE_SIZES) + extra
    sizes = torch.tensor(DECODE_SIZES, dtype=torch.int32, device=dev)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    return dict(
        xt=rnd(11, k), tok=torch.randint(0, 11, (m,), generator=g,
                                         device=dev),
        w=rnd(e, k, n, scale=k ** -0.5), gu=rnd(m, 2 * k),
        sizes=sizes, gate=torch.rand(m, generator=g, device=dev),
        keep=torch.rand(m, generator=g, device=dev) > 0.33,
        order=torch.randperm(m, generator=g, device=dev), m=m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("k,n", [(72, 200), (1408, 2048), (2048, 2816)])
def test_moe_decode_products_match_plain(dtype, tol, k, n):
    """K6a's decode route with the MoE glue folded in, against the plain
    versions (the unfused composition) over groups of 0, 1, 4, 5, 8 and
    32 rows, a k that is no multiple of a ring stage and an n that is no
    multiple of a strip: the gate_up product gathered through ``tok``,
    the down product with SwiGLU on load, the cast gate weight (a dropped
    assignment's row exactly 0) and the scatter to ``order``. Each wrapper
    counts one ``grouped_fwd`` launch on the decode route, and a rerun
    gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    c = _decode_case(dtype, k, n, seed=k + n)

    def close(a, b):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        d = (a.float() - b.float()).abs() / (1 + b.float().abs())
        assert float(d.max()) <= tol

    n0, r0 = TG.grouped_matmul.launches, TG.grouped_matmul.route_launches[
        "decode"]
    gu = TG.moe_gate_up(c["xt"], c["tok"], c["w"], c["sizes"])
    flat = TG.moe_down(c["gu"], c["w"], c["sizes"], c["gate"], c["keep"],
                       c["order"])
    assert TG.grouped_matmul.launches == n0 + 2
    assert TG.grouped_matmul.route_launches["decode"] == r0 + 2
    close(gu, TG.moe_gate_up_plain(c["xt"], c["tok"], c["w"], c["sizes"]))
    close(flat, TG.moe_down_plain(c["gu"], c["w"], c["sizes"], c["gate"],
                                  c["keep"], c["order"]))
    assert float(flat[c["order"][~c["keep"]]].abs().max()) == 0.0
    assert torch.equal(gu, TG.moe_gate_up(c["xt"], c["tok"], c["w"],
                                          c["sizes"]))
    assert torch.equal(flat, TG.moe_down(c["gu"], c["w"], c["sizes"],
                                         c["gate"], c["keep"], c["order"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_moe_decode_leaves_rows_past_the_total_untouched(dtype):
    """Rows past sum(group_sizes) are neither read nor written: the
    identity and gather modes leave those rows of ``out`` as they were,
    the down mode the rows they would scatter to; the rows below the
    total hold the plain versions' values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    k, n = 72, 200
    c = _decode_case(dtype, k, n, seed=5, extra=3)
    m, total = c["m"], sum(DECODE_SIZES)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for down in (0, 1):
        out = torch.full((m, n), 7.0, dtype=dtype, device="cuda")
        lhs, idx = (c["gu"], c["order"]) if down else (c["xt"], c["tok"])
        TG._decode_launch("test", down, lhs, idx, c["w"], c["sizes"],
                          c["gate"] if down else None,
                          c["keep"] if down else None, m, k, n, out=out)
        dead = c["order"][total:] if down else torch.arange(
            total, m, device="cuda")
        assert bool((out[dead] == 7.0).all())
        live = c["order"][:total] if down else torch.arange(
            total, device="cuda")
        ref = (TG.moe_down_plain(c["gu"], c["w"], c["sizes"], c["gate"],
                                 c["keep"], c["order"]) if down
               else TG.moe_gate_up_plain(c["xt"], c["tok"], c["w"],
                                         c["sizes"]))
        d = (out[live].float() - ref[live].float()).abs() / (
            1 + ref[live].float().abs())
        assert float(d.max()) <= tol
    # the identity mode (grouped_matmul at the decode shape) as well
    out = TG.grouped_fwd_cuda(c["gu"][:, :k].contiguous(), c["w"],
                              c["sizes"])
    ref = TG.grouped_matmul_plain(c["gu"][:, :k], c["w"], c["sizes"])
    d = (out[:total].float() - ref[:total].float()).abs() / (
        1 + ref[:total].float().abs())
    assert float(d.max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hq,hkv,d,odd", [
    (32, 8, 128, False),       # Llama-2-7B's GQA widths (Mistral-7B's)
    (16, 16, 128, False),      # Qwen1.5-MoE-A2.7B
    (32, 32, 128, False),      # Llama-2-7B
    (8, 1, 64, False),         # group 8, head dim 64
    (7, 1, 128, False),        # group 7
    (4, 2, 64, True),          # a row stride the vector loads cannot take
], ids=["gqa4", "qwen_moe", "mha", "g8_d64", "g7", "scalar"])
def test_rope_kv_write_matches_the_unfused_composition(dtype, hq, hkv, d,
                                                      odd):
    """K7 folded with the decode tick's pool write against the unfused
    composition (``fused_rope_plain`` on q and k, ``index_put_`` of k and
    v), bit for bit: q rotated, and every pool row but the sink block's,
    over pools holding garbage, per-row tables and two inactive rows
    writing to the sink. One ``rope_kv`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(hq * d + hkv)
    b, nb, bs = 8, 12, 16
    width = (hq + 2 * hkv) * d + (1 if odd else 0)
    qkv = torch.randn(b, 1, width, generator=g, device=dev).to(dtype)
    q, k, v = torch.split(qkv[..., :(hq + 2 * hkv) * d],
                          [hq * d, hkv * d, hkv * d], dim=-1)
    q, k, v = (q.reshape(b, 1, hq, d), k.reshape(b, 1, hkv, d),
               v.reshape(b, 1, hkv, d))
    ang = torch.rand(b, d // 2, generator=g, device=dev) * 300
    cos, sin = torch.cos(ang), torch.sin(ang)
    pools = [torch.randn(nb + 1, bs, hkv, d, generator=g, device=dev).to(
        dtype) for _ in range(2)]
    ref_pools = [p.clone() for p in pools]
    dest = torch.randperm(nb * bs, generator=g, device=dev)[:b]
    dest[[2, 5]] = nb * bs                      # inactive rows: the sink
    n0 = TR.rope_kv_write.launches
    got = TR.rope_kv_write(q, k, v, cos, sin, *pools, dest)
    assert TR.rope_kv_write.launches == n0 + 1
    ref = TR.rope_kv_write_plain(q, k, v, cos, sin, *ref_pools, dest)
    assert got.is_contiguous() and torch.equal(got, ref)
    for p, rp in zip(pools, ref_pools):
        assert torch.equal(p[:nb], rp[:nb])


# ------------------------------------------------ beams and grammar ticks
def _cpu_copy(model):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cpu = LlamaForCausalLM(model.cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def _beam_mix():
    import numpy as np

    from paddle_tpu_torch.serving import Request
    rs = np.random.RandomState(11)
    return [Request(rs.randint(0, 512, 20), max_new_tokens=10),
            Request(rs.randint(0, 512, 33), max_new_tokens=12, num_beams=3),
            Request(rs.randint(0, 512, 9), max_new_tokens=10),
            Request(rs.randint(0, 512, 27), max_new_tokens=8)]


def _serve_beams(model, eager=False, check=None, **kw):
    """The beam mix on an engine of 4 slots (a group of 3 beams rides
    with greedy rows); ``eager``: every decode tick runs the executor's
    eager tick instead of a graph replay; ``check(eng)``: called after
    every step. Returns [(tokens, beam_score)]."""
    import time

    from paddle_tpu_torch.serving import LLMEngine
    eng = LLMEngine(model, num_slots=4, block_size=16, max_prompt_len=64,
                    max_seq_len=128, seed=0, **kw)
    exe = eng.exe
    if eager:
        def tick(last_tok, run_mask, rows, cols, vals, temps, top_ps,
                 need_logp=False, lora=None, bias=None):
            return exe._eager_tick(last_tok, run_mask, rows, cols, vals,
                                   temps, top_ps, need_logp, lora, bias,
                                   time.perf_counter())
        exe.decode_tick = tick
    reqs = _beam_mix()
    for r in reqs:
        eng.add_request(r)
    while eng.has_work():
        eng.step()
        if check is not None:
            check(eng)
    eng.assert_quiescent()
    return [(r.tokens, r.beam_score) for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["llama_bf16", "llama_fp32", "int8_pool"])
def test_beam_graph_ticks_bit_identical_to_eager_ticks(case):
    """A beam group rides with greedy rows: the engine that replays the
    tick graph and the engine whose every tick runs eagerly give the same
    beams and streams bit for bit (tokens and scores), and a replay in
    the middle of the group equals the eager tick
    (``chip_smoke.graph_against_eager``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import chip_smoke
    model, kw = _graph_model(case)
    seen = []

    def check(eng):
        if eng.groups and not seen and all(g.i >= 2 for g in
                                           eng.groups.values()):
            seen.append(chip_smoke.graph_against_eager(torch, eng))
    graph = _serve_beams(model, check=check, **kw)
    eager = _serve_beams(model, eager=True, **kw)
    assert graph == eager
    assert seen and seen[0]["tokens_equal"] and seen[0]["logp_bit_equal"]
    assert graph[1][1] is not None and len(graph[1][0]) == 12


@pytest.mark.cuda
def test_beam_group_update_writes_the_captured_tensors_in_place():
    """Every beam reorder writes the tables, lengths and forked blocks
    into the tensors the tick graph captured: ``_cache_ptrs`` never moves
    and every replay is accepted (a rebound tensor raises there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.serving.executor import _cache_ptrs
    model, _ = _graph_model("llama_bf16")
    ptrs = []

    def check(eng):
        ptrs.append(_cache_ptrs(eng.exe.cache) == eng.exe._tick._ptrs)
    _serve_beams(model, check=check)
    assert ptrs and all(ptrs)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_beam_engine_on_card_matches_cpu(kv):
    """fp32 beams on the card (K2 prefill, K4 decode, K7) equal the CPU
    engine's (the plain versions) in tokens, scores within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    model, _ = _graph_model("llama_fp32")
    kw = {} if kv is None else {"kv_dtype": kv}
    got = _serve_beams(model, **kw)
    want = _serve_beams(_cpu_copy(model), device="cpu", **kw)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert abs(got[1][1] - want[1][1]) <= 1e-4 * abs(want[1][1])


def _grammar_engine(model, store=None, aids=None):
    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving.grammar import TokenMaskAutomaton
    vocab = [""] * 3 + [chr(32 + i % 95) for i in range(509)]
    aut = TokenMaskAutomaton('[0-9]{2}-[a-z]{3}', vocab=vocab,
                             eos_token_id=2)
    eng = LLMEngine(model, num_slots=4, block_size=16, max_prompt_len=64,
                    max_seq_len=128, seed=0, eos_token_id=2,
                    adapter_store=store)
    rs = np.random.RandomState(2)
    reqs = [Request(rs.randint(3, 512, n), max_new_tokens=12,
                    grammar=aut if i % 2 else None,
                    adapter_id=None if aids is None else aids[i])
            for i, n in enumerate((9, 30, 50, 17))]
    for r in reqs:
        eng.add_request(r)
    return eng, reqs, aut


@pytest.mark.cuda
def test_biased_graph_tick_matches_the_eager_biased_tick():
    """With grammar rows the executor replays its biased graph: from one
    cache state it gives the eager biased tick's tokens, bit-identical
    log-probabilities and cache; the grammar streams stay legal, the free
    rows' streams equal a run without grammar rows, and the engine's
    streams equal the CPU's (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import chip_smoke
    model, _ = _graph_model("llama_fp32")
    eng, reqs, aut = _grammar_engine(model)
    eng.exe.tick_log = []
    while not (eng.active.all() and eng.stats["ticks"] >= 2):
        eng.step()
    bias = eng._grammar_bias_rows([(s, s) for s in range(4)], 4)
    res = chip_smoke.graph_against_eager(torch, eng, bias=bias)
    assert res["tokens_equal"] and res["logp_bit_equal"], res
    assert res["cache_bit_equal"], res
    eng.run()
    eng.assert_quiescent()
    assert {k for k, *_ in eng.exe.tick_log} >= {"biased"}
    for r in reqs[1::2]:
        sid = aut.start_state
        for t in r.tokens:
            assert aut.mask(sid)[t]
            sid = aut.advance(sid, t)
    ceng, creqs, _ = _grammar_engine(_cpu_copy(model))
    ceng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in creqs]


@pytest.mark.cuda
def test_lora_and_grammar_tick_runs_eagerly_on_the_card():
    """A tick with adapter rows and grammar rows runs the eager tick on
    the card (no graph holds both): the engine counts it, and its streams
    equal the CPU engine's (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.serving.adapters import AdapterStore
    model, store = _lora_model_and_store(torch.float32)
    sd = _lora_sd(model, 1, 8)
    store.register("a", sd)
    aids = ["a", "a", None, None]
    eng, reqs, _ = _grammar_engine(model, store, aids)
    eng.exe.tick_log = []
    eng.run()
    eng.assert_quiescent()
    kinds = [k for k, *_ in eng.exe.tick_log]
    assert eng.stats["lora_grammar_ticks"] > 0
    assert kinds.count("eager") == eng.stats["lora_grammar_ticks"]
    cpu = _cpu_copy(model)
    cstore = AdapterStore(cpu, capacity=2, max_rank=8)
    cstore.register("a", sd)
    ceng, creqs, _ = _grammar_engine(cpu, cstore, aids)
    ceng.run()
    assert [r.tokens for r in reqs] == [r.tokens for r in creqs]


@pytest.mark.cuda
def test_h100_peaks_resolve_from_the_device_name(monkeypatch):
    """The roofline's peaks come from ``torch.cuda.get_device_name``: the
    H100's row (989e12 FLOP/s, 3.35e12 B/s) on that card, 0.0 (undefined)
    on a card no row names; a card engine exports a decode MBU above 0
    on the H100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.observability import METRICS
    from paddle_tpu_torch.observability.roofline import resolve_serving_peaks
    monkeypatch.delenv("PT_ROOFLINE_KIND", raising=False)
    name = torch.cuda.get_device_name(0)
    want = ((989e12, 3.35e12) if name == "NVIDIA H100 80GB HBM3"
            else (0.0, 0.0))
    assert resolve_serving_peaks(torch.device("cuda")) == want
    model, _ = _graph_model("llama_bf16")
    eng = _decoding_engine(model, new=8)
    assert (eng._peak_flops, eng._peak_hbm) == want
    eng.run()
    mbu = METRICS.get("serving_mbu").value(phase="decode")
    assert (mbu > 0.0) == (want[1] > 0.0)
    assert mbu <= 1.05


def _rung_engine(model, draft, dev):
    """Tenants A (weight 2), B, C (best effort) over an engine with a
    self-draft, a held degradation controller and an SLO tracker; the
    scheduler's clock counts steps, so both devices see one schedule."""
    import numpy as np

    from paddle_tpu_torch.observability import SLOTracker
    from paddle_tpu_torch.serving import (DegradationController, LLMEngine,
                                          Request)
    ctrl = DegradationController(signals=[], down_patience=10 ** 9)
    eng = LLMEngine(model, draft_model=draft, spec_k=2, degrade=ctrl,
                    slo=SLOTracker(), num_slots=3, block_size=16,
                    max_prompt_len=32, max_seq_len=160, device=dev)
    clock = [0.0]
    eng.sched.clock = lambda: clock[0]
    eng.sched.set_tenant_weight("A", 2.0)
    eng.sched.set_tenant_priority("C", "best_effort")
    eng.sched.set_tenant_rate("C", 10.0, burst=10.0)
    rs = np.random.RandomState(11)
    reqs = [Request(rs.randint(0, 512, n), max_new_tokens=12, tenant_id=t)
            for n, t in zip((9, 70, 33, 5, 48, 20, 90, 14),
                            "AABCABCA")]
    for r in reqs:
        eng.add_request(r)
    return eng, ctrl, clock, reqs


@pytest.mark.cuda
def test_tenant_engine_with_forced_rungs_on_card_matches_cpu():
    """The tenant engine under a forced rung sequence (L0, L1 with a
    self-draft, L2's shrunk chunks, L3's shedding, L4's rejection, back
    to L0) on the card in float32 gives the CPU's greedy streams token
    for token, with the same sheds, throttles and speculative rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import METRICS
    from paddle_tpu_torch.serving import OverloadError, Request
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512, dtype=torch.float32)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rungs = [0] * 2 + [1] * 3 + [0] * 3 + [3] * 6 + [2] * 6
    out = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        METRICS.reset()
        eng, ctrl, clock, reqs = _rung_engine(model, model, dev)
        levels = []
        for lvl in rungs:
            ctrl.force_level(lvl)
            eng.step()
            clock[0] += 0.05
            levels.append((lvl, eng.stats["spec_ticks"], len(eng.queue)))
        ctrl.force_level(4)
        with pytest.raises(OverloadError):
            eng.add_request(Request(np.arange(5), max_new_tokens=2))
        ctrl.force_level(0)
        while eng.has_work():
            eng.step()
            clock[0] += 0.05
        eng.assert_quiescent()
        series = {n: {k: c[0] for k, c in METRICS.get(n)._series.items()}
                  for n in ("serving_degrade_shed_total",
                            "serving_tenant_throttled_total",
                            "serving_tenant_tokens_total")}
        out.append(([r.tokens for r in reqs], levels, series,
                    eng.stats["spec_ticks"]))
    assert out[1] == out[0]
    assert out[1][2]["serving_degrade_shed_total"].get(("C",), 0) > 0
    assert out[1][2]["serving_tenant_throttled_total"].get(("C",), 0) > 0
    spec = [n for lvl, n, _ in out[1][1] if lvl == 1]
    assert out[1][1][1][1] > 0 and len(set(spec)) == 1   # no round at L1
    assert out[1][3] > spec[0]                          # rounds again at L0


@pytest.mark.cuda
def test_scrape_during_capture_leaves_streams_and_captures_intact(
        tmp_path, monkeypatch):
    """A fresh engine's LoRA, biased and async graphs are captured while a
    client hammers ``/memory`` and ``/profile`` of the metrics server from
    another thread: no capture fails, the streams equal an unscraped
    engine's, and the captures that ran wrote traces naming the decode
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import json
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from paddle_tpu_torch.observability import httpd
    from paddle_tpu_torch.serving import LLMEngine, Request
    monkeypatch.setenv("PT_PROFILE_DIR", str(tmp_path))
    model, store = _lora_model_and_store(torch.float32)
    store.register("a", _lora_sd(model, 3, 8))

    def serve():
        eng = LLMEngine(model, adapter_store=store, async_depth=2,
                        num_slots=3, block_size=16, max_prompt_len=64,
                        max_seq_len=128, seed=0)
        rs = np.random.RandomState(4)
        ids = [eng.add_request(Request(rs.randint(0, 512, n),
                                       max_new_tokens=24, adapter_id=a))
               for n, a in ((9, "a"), (40, None), (17, None), (33, "a"))]
        eng.run()
        eng.assert_quiescent()
        return [eng.requests[i].tokens for i in ids], eng

    want, _ = serve()
    srv = httpd.MetricsServer(port=0, host="127.0.0.1")
    stop, codes = threading.Event(), {}

    def get(path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def hammer(path):
        while not stop.is_set():
            code, body = get(path)
            codes.setdefault(path, []).append(code)
            if path == "/memory" and \
                    "cuda:0" not in json.loads(body)["device"]:
                codes.setdefault("bad", []).append(body[:200])

    threads = [threading.Thread(target=hammer, args=(p,), daemon=True,
                                name=f"pt-test-{p[1:8]}")
               for p in ("/memory", "/profile?seconds=0.3")]
    def decode_named():
        names = set()
        for t in tmp_path.glob("*.json"):
            with open(t) as f:
                names |= {e.get("name", "")
                          for e in json.load(f)["traceEvents"]}
        return any("paged_decode" in n for n in names)

    try:
        for t in threads:
            t.start()
        # serve until a capture window has covered decode ticks: every
        # engine is built, and its graphs captured, under the scraping
        for _ in range(6):
            got, eng = serve()
            assert got == want
            assert {k for k in ("_tick", "_btick", "_atick", "_ltick")
                    if getattr(eng.exe, k, None) is not None} == \
                {"_tick", "_btick", "_atick", "_ltick"}
            if 200 in codes.get("/profile?seconds=0.3", ()) and \
                    decode_named():
                break
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        srv.stop()
    assert codes["/memory"] and set(codes["/memory"]) == {200}
    assert "bad" not in codes, codes["bad"]
    assert 200 in codes["/profile?seconds=0.3"]
    assert set(codes["/profile?seconds=0.3"]) <= {200, 409}
    assert decode_named()


# ----------------------------------------- router, KV handoff, HF loading
def _router_mix():
    import numpy as np

    from paddle_tpu_torch.serving import Request
    rs = np.random.RandomState(12)
    return [Request(rs.randint(0, 512, n), max_new_tokens=10)
            for n in (20, 90, 9, 27, 41)]


def _route_on(model, roles, parallel=False, check=None, **kw):
    """The router mix through a Router over engines of 4 slots on the
    model's device (``roles``: one per replica); ``check(router)`` after
    every step of the sequential run. Returns (token lists, router)."""
    from paddle_tpu_torch.serving import LLMEngine, Replica, Router
    router = Router([Replica(LLMEngine(model, num_slots=4, block_size=16,
                                       max_prompt_len=64, max_seq_len=128,
                                       seed=0, **kw), role=role)
                     for role in roles])
    reqs = _router_mix()
    for r in reqs:
        router.add_request(r)
    if parallel:
        router.run(parallel=True)
    while router.has_work():
        router.step()
        if check is not None:
            check(router)
    router.assert_quiescent()
    for rep in router.replicas:
        rep.engine.assert_quiescent()
    return [r.tokens for r in reqs], router


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [None, "int8"])
def test_disaggregated_router_on_card_matches_cpu(kv):
    """fp32 on the card: a prefill replica (K2, K3 over a 90-token prompt
    in chunks of 64, K7) hands every sequence over sealed to a decode
    replica whose tick graph replays against the installed blocks (the
    install writes the captured tensors in place); the streams equal a
    single CPU engine's token for token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.serving import LLMEngine
    from paddle_tpu_torch.serving.executor import _cache_ptrs
    model, _ = _graph_model("llama_fp32")
    kw = {} if kv is None else {"kv_dtype": kv}
    in_place = []

    def check(router):
        exe = router.replicas[1].engine.exe
        in_place.append(_cache_ptrs(exe.cache) == exe._tick._ptrs)
    got, router = _route_on(model, ("prefill", "decode"), check=check, **kw)
    assert router.stats["transfers"] == 5 and in_place and all(in_place)
    assert router.replicas[0].engine.stats["ticks"] == 0
    cpu = LLMEngine(_cpu_copy(model), num_slots=4, block_size=16,
                    max_prompt_len=64, max_seq_len=128, seed=0,
                    device="cpu", **kw)
    reqs = _router_mix()
    for r in reqs:
        cpu.add_request(r)
    cpu.run()
    assert got == [r.tokens for r in reqs]


@pytest.mark.cuda
def test_parallel_router_on_card_matches_sequential():
    """run(parallel=True) on one card: one thread per replica (the
    tick graphs were captured when the engines were built) gives the
    sequential rounds' streams, and no thread outlives the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import threading
    model, _ = _graph_model("llama_bf16")
    seq, _ = _route_on(model, ("both", "both"))
    par, router = _route_on(model, ("both", "both"), parallel=True)
    assert par == seq
    assert all(rep.engine.stats["ticks"] > 0 for rep in router.replicas)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("pt-router-")]


@pytest.mark.cuda
def test_auto_from_pretrained_loads_onto_the_card(tmp_path):
    """A bf16 HF checkpoint written by ``chip_smoke.write_hf_checkpoint``
    (two shards) loads with no device named onto the card, every
    parameter bit-equal to the model it was written from."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import chip_smoke
    from paddle_tpu_torch.models.auto import auto_from_pretrained
    model, _ = _graph_model("llama_bf16")
    cfg = model.cfg
    hf = {"model_type": "llama", "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_hidden_layers,
          "num_attention_heads": cfg.num_attention_heads,
          "num_key_value_heads": cfg.num_key_value_heads,
          "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.rms_norm_eps,
          "tie_word_embeddings": False, "torch_dtype": "bfloat16"}
    old = chip_smoke.HF_SHARD_BYTES
    chip_smoke.HF_SHARD_BYTES = 2 ** 20
    try:
        chip_smoke.write_hf_checkpoint(torch, str(tmp_path),
                                       chip_smoke.hf_llama_tensors(model), hf)
    finally:
        chip_smoke.HF_SHARD_BYTES = old
    assert len(list(tmp_path.glob("*.safetensors"))) >= 2
    got = auto_from_pretrained(str(tmp_path), dtype=torch.bfloat16)
    assert got.device.type == "cuda"
    want = dict(model.named_parameters())
    for name, p in got.named_parameters():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), name


# ------------------------------------------------ GPTQ, QAT/PTQ products
@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_gptq_on_card_matches_cpu_path(bits):
    """GPTQ's lazy-batch float64 recursion on the card (three blocks, the
    last one narrow) against the reference's loop on the CPU over the same
    weights and activations: scales bit-equal, codes equal on at least
    99.9% of entries (the two orders of the same float64 sums may round a
    tie apart)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.quantization import gptq_quantize
    g = torch.Generator().manual_seed(bits)
    k, n = 300, 96
    x = torch.randn(512, 8, generator=g) @ torch.randn(8, k, generator=g)
    x = x + 0.1 * torch.randn(512, k, generator=g)
    w = torch.randn(k, n, generator=g)
    cpu = gptq_quantize(w, x, bits=bits)
    card = gptq_quantize(w.cuda(), x.cuda(), bits=bits)
    assert card.q.is_cuda and card.q.shape == cpu.q.shape
    assert card.q.is_contiguous() and card.scale.is_contiguous()
    assert torch.equal(card.scale.cpu(), cpu.scale)
    same = (card.unpack().cpu() == cpu.unpack()).float().mean()
    assert float(same) >= 0.999, float(same)


@pytest.mark.cuda
def test_int8_product_on_card_is_the_cpu_int32_product():
    """QuantizedLinear's product on the card (``torch._int_mm`` on padded
    operands) equals the CPU's int32 matmul bit for bit, at shapes that
    need every pad (5 rows, K 60, N 30) and at K 4096 with extreme codes
    (sums past 2^24)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.quantization import QuantizedLinear, int8_matmul
    g = torch.Generator().manual_seed(0)
    for m, k, n in ((5, 60, 30), (40, 4096, 64)):
        a = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
        b = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
        assert torch.equal(int8_matmul(a.cuda(), b.cuda()).cpu(),
                           int8_matmul(a, b))
    big = torch.full((3, 4096), 127, dtype=torch.int8, device="cuda")
    assert int(int8_matmul(big, big.T.contiguous())[0, 0]) == \
        127 * 127 * 4096
    w = torch.randn(64, 32, generator=g)
    x = torch.randn(2, 7, 64, generator=g)
    got = QuantizedLinear(w.cuda())(x.cuda())
    assert torch.allclose(got.cpu(), QuantizedLinear(w)(x), rtol=1e-6,
                          atol=1e-6)


def _card_llama(**kw):
    """(CPU model, card model) of a 2-layer fp32 Llama at head dim 128
    (the kernels' width), the same weights."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512, **kw)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.cuda
def test_smoothing_and_gptq_serving_on_card_match_cpu():
    """Calibrated smoothing folds the CPU's weights on the card (within
    fp32 rounding); a GPTQ-int4 model then serves the CPU's greedy
    streams through the engine on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import copy

    import numpy as np

    from paddle_tpu_torch.serving import LLMEngine, Request
    from paddle_tpu_torch.serving import quant as TQ
    cpu, card = _card_llama()
    calib = torch.as_tensor(np.random.RandomState(3).randint(0, 512, (2, 64)))
    sc = TQ.smooth_for_serving(copy.deepcopy(cpu), calib_ids=calib)
    sg = TQ.smooth_for_serving(copy.deepcopy(card), calib_ids=calib.cuda())
    want = dict(sc.named_parameters())
    for name, p in sg.named_parameters():
        assert torch.allclose(p.cpu(), want[name], rtol=1e-4, atol=1e-7), name
    streams = []
    for m in (cpu, card):
        dev = next(m.parameters()).device
        TQ.quantize_for_serving(m, "gptq_int4", calib_ids=calib.to(dev))
        eng = LLMEngine(m, num_slots=2, block_size=16, max_prompt_len=64,
                        max_seq_len=96, device=dev)
        rs = np.random.RandomState(4)
        ids = [eng.add_request(Request(rs.randint(0, 512, n),
                                       max_new_tokens=8)) for n in (9, 40)]
        eng.run()
        streams.append([list(map(int, eng.requests[i].tokens)) for i in ids])
    assert streams[0] == streams[1]


# ------------------------------------------------ the speculative API
@pytest.mark.cuda
def test_speculative_api_on_card_matches_generate():
    """On the card (fp32, K1 and K7): speculative_generate with an
    unrelated draft equals generate's greedy stream, the batched ragged
    rows equal their solo runs, and both equal the CPU's streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.decoding import generate
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.speculative import (
        speculative_generate, speculative_generate_batched)
    from paddle_tpu_torch.ops import cuda as K
    cpu, card = _card_llama()
    draft = LlamaForCausalLM(LlamaConfig.tiny(
        hidden_size=256, intermediate_size=512, num_attention_heads=2,
        num_key_value_heads=1, vocab_size=512, num_hidden_layers=1),
        device="cuda", seed=1)
    rs = np.random.RandomState(5)
    lens = [20, 7, 33]
    padded = np.zeros((3, 33), np.int64)
    for i, n in enumerate(lens):
        padded[i, :n] = rs.randint(0, 512, n)
    K.reset_launches()
    got_b, _ = speculative_generate_batched(card, draft, padded,
                                            prompt_lens=np.asarray(lens),
                                            max_new_tokens=12, gamma=4)
    for i, n in enumerate(lens):
        solo = generate(card, padded[i:i + 1, :n], 12)
        spec, _ = speculative_generate(card, draft, padded[i:i + 1, :n],
                                       max_new_tokens=12, gamma=4)
        assert torch.equal(spec, solo)
        assert torch.equal(got_b[i, :n + 12], solo[0])
        assert torch.equal(solo.cpu(), generate(cpu, padded[i:i + 1, :n],
                                                12))
    counts = K.launches()
    assert counts["rms_norm"] > 0 and counts["rope"] > 0, counts


# ------------------------------------------------ selective remat
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_policies_bit_identical_on_card(dtype):
    """The train step's loss and every gradient bit for bit the same under
    every remat policy and with scanned layers (K2's recompute and K5a /
    K5b are deterministic), and a policy that saves the attention context
    launches K2 in the backward no more often than full remat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    ids = np.random.RandomState(0).randint(0, 512, (2, 96))
    labels = np.concatenate([ids[:, 1:], np.full((2, 1), -100)], axis=1)
    ids, labels = torch.as_tensor(ids).cuda(), torch.as_tensor(labels).cuda()
    ref, bwd = None, {}
    for pol, scan in ((None, False), ("full", False), ("hidden", False),
                      ("no_ffn", False), ("dots", False), (None, True),
                      ("dots", True)):
        cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                               num_attention_heads=2, num_key_value_heads=1,
                               vocab_size=512, dtype=dtype, remat=True,
                               remat_policy=pol, scan_layers=scan)
        m = LlamaForCausalLM(cfg, device="cuda", seed=0)
        K.reset_launches()
        loss = m.loss(ids, labels)
        fwd = K.launches()
        loss.backward()
        bwd[(pol, scan)] = {k: v - fwd[k] for k, v in K.launches().items()}
        grads = {}
        for n, p in m.named_parameters():
            if n.startswith("model.layers_stacked."):
                for i in range(cfg.num_hidden_layers):
                    grads[n.replace("layers_stacked", f"layers.{i}")] = \
                        p.grad[i]
            else:
                grads[n] = p.grad
        if ref is None:
            ref = (loss.detach(), grads)
            continue
        assert torch.equal(loss.detach(), ref[0]), (pol, scan)
        for n, g in grads.items():
            assert torch.equal(g, ref[1][n]), (pol, scan, n)
    assert bwd[("dots", False)]["flash_fwd"] <= \
        bwd[("hidden", False)]["flash_fwd"] <= bwd[(None, False)]["flash_fwd"]
    assert all(b["flash_bwd_dq"] > 0 and b["flash_bwd_dkv"] > 0
               for b in bwd.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512, 384), (2, 64, 1024, 2048)],
                         ids=["2d", "3d"])
def test_fp8_matmul_on_card_matches_plain(shape):
    """fp8_matmul on the card (torch._scaled_mm) against its plain version
    (bf16 upcasts of the same fp8 codes, float32 products) on the card:
    forward, dx and dw within the bf16 tolerance, rolled histories equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch.amp import fp8
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    *lead, k, n = shape
    x = torch.randn(*lead, k, generator=g, device=dev).bfloat16()
    w = (0.05 * torch.randn(k, n, generator=g, device=dev)).bfloat16()
    gy = torch.randn(*lead, n, generator=g, device=dev).bfloat16()
    out = []
    for plain in (False, True):
        meta = fp8.new_fp8_meta(device=dev)
        meta.amax_x[0] = float(x.abs().max())
        meta.amax_w[0] = float(w.abs().max())
        meta.amax_g[0] = float(gy.abs().max())
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fp8.fp8_matmul(xr, wr, meta, plain=plain)
        y.backward(gy)
        out.append((y, xr.grad, wr.grad, torch.cat(meta.histories())))
    for a, r in zip(out[0][:3], out[1][:3]):
        d = (a.float() - r.float()).abs() / (1 + r.float().abs())
        assert float(d.max()) <= 2e-2
    assert torch.equal(out[0][3], out[1][3])


@pytest.mark.cuda
def test_prefetch_side_stream_orders_the_copies():
    """Batches land on a side stream; the consumer's stream waits on each
    batch's event, so work queued right after next() reads the copied
    values (64 MiB batches, large enough to still be copying), in order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np
    from paddle_tpu_torch.io import prefetch_to_device
    dev = torch.device("cuda")
    batches = [np.full((4096, 4096), i, np.float32) for i in range(6)]
    got = []
    with prefetch_to_device(iter(batches), depth=3, device=dev) as p:
        assert p._stream != torch.cuda.current_stream(dev)
        for b in p:
            assert b.is_cuda
            got.append((b * 2).sum())        # queued on the consumer stream
    want = [2.0 * i * 4096 * 4096 for i in range(6)]
    assert [float(t) for t in got] == want


@pytest.mark.cuda
def test_float16_model_refused_on_card():
    """A float16 model runs on the card (this test once held its refusal):
    its logits, loss and gradients against the same float16 weights on the
    CPU's plain path within 2e-2 of their RMS (both round to float16 at
    different places), every kernel of the forward and backward on its
    float16 instantiation (each launch on the float16 count)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1, dtype=torch.float16)
    cpu = LlamaForCausalLM(cfg, device="cpu")
    card = LlamaForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (2, 40), generator=g)
    labels = torch.roll(ids, -1, 1)

    def rel(a, b):
        a, b = a.detach().float().cpu(), b.detach().float()
        return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())
    K.reset_launches()
    got = card(ids.cuda())
    loss = card.loss(ids.cuda(), labels.cuda())
    loss.backward()
    torch.cuda.synchronize()
    counts = K.launches()
    want = cpu(ids)
    want_loss = cpu.loss(ids, labels)
    want_loss.backward()
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    assert rel(got, want) <= 2e-2
    assert abs(float(loss) - float(want_loss)) <= 2e-2 * abs(float(want_loss))
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        assert rel(p.grad, q.grad) <= 2e-2, name
    for name in K.TRAIN_KERNELS:
        assert counts[name] > 0 and counts[f"{name}_f16"] == counts[name], (
            name, counts)
    assert amp.is_float16_supported("cuda") is True


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_grad_scaler_and_guarded_step_make_no_host_sync(dtype):
    """The scaler's methods and the Trainer's guarded update (the NaN
    guard, the learning-rate lookup, the masked AdamW step with its clip)
    run under set_sync_debug_mode("error"): any host read raises. bf16 and
    float16 models; the scaler over gradients of the model's type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.train import Trainer, TrainerArgs
    dev = torch.device("cuda")
    sc = amp.GradScaler(init_loss_scaling=1024.0)
    st = sc.init(dev)
    grads = {"a": torch.ones(8, dtype=dtype, device=dev), "b": torch.full(
        (4,), float("inf"), dtype=dtype, device=dev)}
    m = LlamaForCausalLM(LlamaConfig.tiny(hidden_size=256,
                                          num_attention_heads=4,
                                          dtype=dtype), device=dev)
    tr = Trainer(m, O.AdamW(1e-3, multi_precision=True,
                            grad_clip=O.ClipGradByGlobalNorm(1.0)),
                 lambda mm, i, lab: mm.loss(i, lab),
                 TrainerArgs(max_steps=4), device=dev)
    tr._schedule_tables(0)
    ids = torch.randint(0, 256, (2, 64), device=dev)
    labels = torch.roll(ids, -1, 1)
    tr._step_fn([(ids, labels)])            # warm-up outside the check
    loss, g_model = tr._grads([(ids, labels)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scaled = sc.scale(torch.ones((), device=dev), st)
        g = sc.unscale(grads, st)
        found = sc.found_inf(g)
        sc.step_or_skip(grads, g, found)
        st2 = sc.update(st, found)
        tr._apply(loss, g_model)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert float(st2["scale"]) == 512.0 and float(scaled) == 1024.0
    assert torch.isfinite(loss) and int(tr._dstep) == 2


def _nccl_world_of_one(tmp_path):
    from paddle_tpu_torch.distributed import init_parallel_env
    assert init_parallel_env(init_method=f"file://{tmp_path}/store",
                             world_size=1, rank=0)
    assert torch.distributed.get_backend() == "nccl"


def _end_world():
    from paddle_tpu_torch.distributed.mesh import forget_groups
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    forget_groups()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mesh_train_step_on_card_is_the_unsharded_step(dtype, tmp_path):
    """make_train_step over HybridMesh() in an NCCL world of one rank:
    every loss and parameter bit for bit the unsharded step's, the same
    kernel launches a step, and the sharded model's state_dict() the
    unsharded one's names and values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import cuda as K
    from paddle_tpu_torch.train import init_state, make_train_step
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           vocab_size=512, dtype=dtype)
    ids = np.random.RandomState(0).randint(0, 512, (4, 96))
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
    ids, labels = torch.as_tensor(ids).cuda(), torch.as_tensor(labels).cuda()
    runs = {}
    _nccl_world_of_one(tmp_path)
    try:
        for mesh in (None, D.HybridMesh()):
            m = LlamaForCausalLM(cfg, device="cuda", seed=0)
            opt = O.AdamW(learning_rate=1e-3, multi_precision=True,
                          grad_clip=O.ClipGradByGlobalNorm(1.0))
            state = init_state(m, opt, mesh)
            step = make_train_step(lambda mm, i, lab: mm.loss(i, lab), opt,
                                   mesh=mesh)
            K.reset_launches()
            losses = []
            for _ in range(3):
                state, lo = step(state, ids, labels)
                losses.append(lo)
            runs[mesh is None] = (torch.stack(losses), K.launches(),
                                  state.model.state_dict())
    finally:
        _end_world()
    (l0, k0, s0), (l1, k1, s1) = runs[True], runs[False]
    assert torch.equal(l0, l1)
    assert k0 == k1 and k0["flash_bwd_dkv"] > 0 and k0["rope"] > 0
    assert s0.keys() == s1.keys()
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


@pytest.mark.cuda
def test_pipeline_on_card_1f1b_equals_zb1(tmp_path):
    """make_llama_pp_train_step at pp = 1 (NCCL, one rank), bf16, 4
    microbatches: zb1's losses and parameters bit for bit 1f1b's, the loss
    of the first step within 1e-2 of the unsharded model's, and the train
    kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    import numpy as np

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import cuda as K
    cfg = L.LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                             num_attention_heads=2, num_key_value_heads=1,
                             vocab_size=512, num_hidden_layers=4,
                             dtype=torch.bfloat16)
    ids = np.random.RandomState(1).randint(0, 512, (4, 128))
    labels = np.concatenate([ids[:, 1:], np.full((4, 1), -100)], axis=1)
    ids, labels = torch.as_tensor(ids).cuda(), torch.as_tensor(labels).cuda()
    m = L.LlamaForCausalLM(cfg, device="cuda", seed=0)
    with torch.no_grad():
        ref = float(m.loss(ids, labels))
    runs = {}
    _nccl_world_of_one(tmp_path)
    try:
        mesh = D.HybridMesh(pp=1)
        for sched in ("1f1b", "zb1"):
            params, st = L.init_llama_pp_state(m, O.AdamW(1e-3), mesh)
            step = L.make_llama_pp_train_step(m, mesh, O.AdamW(1e-3), 4,
                                              schedule=sched)
            K.reset_launches()
            losses = []
            for _ in range(3):
                params, st, lo = step(params, st, ids, labels)
                losses.append(lo)
            runs[sched] = (torch.stack(losses), params.flat(), K.launches())
    finally:
        _end_world()
    (l1, p1, k1), (lz, pz, kz) = runs["1f1b"], runs["zb1"]
    assert torch.equal(l1, lz)
    assert all(torch.equal(p1[k], pz[k]) for k in p1)
    assert abs(float(l1[0]) - ref) <= 1e-2 * abs(ref)
    assert k1 == kz
    assert all(k1[k] > 0 for k in ("rms_norm", "flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "rope"))
