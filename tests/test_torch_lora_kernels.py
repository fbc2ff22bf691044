"""K6a's two multi-LoRA kernels' plain versions (``ops/cuda/grouped_matmul``
``lora_shrink_plain``, ``lora_expand_add_plain``) and the paged forwards'
``_lora_add`` that runs them, on the CPU.

Against the JAX package: ``_lora_add(y, x, ...)`` equals the reference's
``y + _lora_delta(x, ...)`` on the same numpy inputs (fp32 within
``F32_TOL``; bf16 within one bf16 step) at widths 1, 3 and 5 (decode, a
chunk, the speculative verify), with null-adapter rows first, last and
interleaved, an empty group and a capacity of 1; null rows come out equal
to y. Against the port's own ``_lora_delta`` (the unfused composition) the
plain versions are bit for bit the same arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import paged as jpaged
from paddle_tpu_torch.models import paged as tpaged
from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
from tests.test_torch_common import F32_TOL, to_np

# one bf16 step: the correction and the sum are each rounded once to
# bf16, so the two packages may land on neighbouring values
BF16_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
DIMS = {"qkv": (32, 96), "o": (32, 32)}

CASES = [
    ([1, -1, 0, 1], 1, 4),           # decode, a null row interleaved
    ([-1, -1, 2, 0, 2], 1, 4),       # null rows first, an empty group (1, 3)
    ([3, 0, 3, -1, -1], 3, 4),       # chunk rows, null rows last
    ([0, -1, 2, -1, 0, 2], 5, 4),    # verify width, interleaved nulls
    ([0, 0, -1, 0], 5, 1),           # capacity 1
    ([0, 0, 0], 3, 1),               # capacity 1, no null row
    ([-1, -1], 1, 2),                # every row on the base
]


def _batch(rs, cap, aidx, width, r=4, layers=2):
    """Stacks and indices of one LoRA batch as the engine builds them
    (``serving/engine.py`` ``_lora_arg``): numpy, the same for both
    packages."""
    aidx = np.asarray(aidx, np.int64)
    order = np.argsort(np.where(aidx < 0, cap, aidx), kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    gs = np.bincount(aidx[aidx >= 0], minlength=cap) * width
    lora = {}
    for kind, (k, n) in DIMS.items():
        lora[kind + "_a"] = rs.randn(layers, cap, k, r).astype(np.float32)
        lora[kind + "_b"] = (rs.randn(layers, cap, r, n) * 0.1).astype(
            np.float32)
    lora.update(perm=order.astype(np.int32), inv=inv.astype(np.int32),
                gs=gs.astype(np.int32), aidx=aidx.astype(np.int32))
    return lora


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aidx,width,cap", CASES)
def test_lora_add_matches_reference(aidx, width, cap, dtype):
    """``_lora_add`` (the plain versions on the CPU) against the
    reference's ``y + _lora_delta`` for both projections at layer 1; the
    null-adapter rows come out equal to y."""
    rs = np.random.RandomState(len(aidx) * 13 + width + cap)
    lora = _batch(rs, cap, aidx, width)
    tl = {k: torch.as_tensor(v) for k, v in lora.items()}
    jl = {k: jnp.asarray(v) for k, v in lora.items()}
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    null = np.asarray(aidx) < 0
    for kind, (k, n) in DIMS.items():
        x = rs.randn(len(aidx), width, k).astype(np.float32)
        y = rs.randn(len(aidx), width, n).astype(np.float32)
        tx, ty = torch.as_tensor(x).to(tdt), torch.as_tensor(y).to(tdt)
        got = tpaged._lora_add(ty.clone(), tx, tl, kind, 1)
        want = jnp.asarray(y).astype(jdt) + jpaged._lora_delta(
            jnp.asarray(x).astype(jdt), jl, kind, 1)
        assert got.dtype == tdt
        np.testing.assert_allclose(to_np(got.float()),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
        assert torch.equal(got[torch.as_tensor(null)],
                           ty[torch.as_tensor(null)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aidx,width,cap", CASES)
def test_plain_versions_are_the_unfused_composition(aidx, width, cap,
                                                     dtype):
    """The two plain versions, composed, equal the port's unfused
    ``y + _lora_delta(x)`` bit for bit; the shrink alone equals the
    permuted fp32 rows through ``grouped_matmul_plain`` (0 past the
    groups' total)."""
    rs = np.random.RandomState(len(aidx) * 7 + width)
    lora = {k: torch.as_tensor(v)
            for k, v in _batch(rs, cap, aidx, width).items()}
    for kind, (k, n) in DIMS.items():
        x = torch.as_tensor(rs.randn(len(aidx), width, k)).to(dtype)
        y = torch.as_tensor(rs.randn(len(aidx), width, n)).to(dtype)
        a, b = lora[kind + "_a"][0], lora[kind + "_b"][0]
        t = GM.lora_shrink(x, lora["perm"], a, lora["gs"])
        xp = x.float()[lora["perm"].long()].reshape(-1, k)
        assert torch.equal(t, GM.grouped_matmul_plain(xp, a, lora["gs"]))
        assert not t[int(lora["gs"].sum()):].any()
        got = GM.lora_expand_add(y.clone(), t, b, lora["gs"], lora["perm"])
        assert torch.equal(got, y + tpaged._lora_delta(x, lora, kind, 0))


def test_lora_add_returns_y_updated_in_place():
    rs = np.random.RandomState(3)
    lora = {k: torch.as_tensor(v)
            for k, v in _batch(rs, 4, [2, -1, 0], 1).items()}
    x = torch.as_tensor(rs.randn(3, 1, 32).astype(np.float32))
    y = torch.as_tensor(rs.randn(3, 1, 96).astype(np.float32))
    out = tpaged._lora_add(y, x, lora, "qkv", 0)
    assert out is y


def test_gather_baseline_unchanged(monkeypatch):
    """``PT_MULTILORA_IMPL=gather`` keeps the dense baseline: ``_lora_add``
    is ``y + _lora_delta`` (gather), a new tensor."""
    monkeypatch.setenv("PT_MULTILORA_IMPL", "gather")
    rs = np.random.RandomState(4)
    lora = {k: torch.as_tensor(v)
            for k, v in _batch(rs, 4, [3, -1, 0, 3], 2).items()}
    x = torch.as_tensor(rs.randn(4, 2, 32).astype(np.float32))
    y = torch.as_tensor(rs.randn(4, 2, 32).astype(np.float32))
    out = tpaged._lora_add(y, x, lora, "o", 1)
    assert out is not y
    assert torch.equal(out, y + tpaged._lora_delta(x, lora, "o", 1))


def test_wrappers_refuse_bad_shapes_and_types():
    """Shapes and types both versions refuse, on any device."""
    x = torch.zeros(2, 1, 16)
    a = torch.zeros(3, 16, 4)
    b = torch.zeros(3, 4, 8)
    perm = torch.zeros(2, dtype=torch.int32)
    gs = torch.zeros(3, dtype=torch.int32)
    t = torch.zeros(2, 4)
    y = torch.zeros(2, 1, 8)
    with pytest.raises(ValueError):
        GM.lora_shrink(x, perm, torch.zeros(3, 8, 4), gs)
    with pytest.raises(ValueError):
        GM.lora_shrink(x, perm, a, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        GM.lora_shrink(x.double(), perm, a, gs)
    with pytest.raises(TypeError):
        GM.lora_shrink(x, perm.long(), a, gs)
    with pytest.raises(ValueError):
        GM.lora_expand_add(y, torch.zeros(2, 5), b, gs, perm)
    with pytest.raises(ValueError):
        GM.lora_expand_add(torch.zeros(2, 1, 9), t, b, gs, perm)
    with pytest.raises(TypeError):
        GM.lora_expand_add(y, t, b.double(), gs, perm)
    with pytest.raises(TypeError):
        tpaged._lora_add(y.bfloat16(), x, {
            "o_a": a[None], "o_b": b[None], "perm": perm, "gs": gs},
            "o", 0)


@pytest.mark.parametrize("m,e,k,r,want", [
    (8, 4, 4096, 16, (8, 512)),       # decode: 5 row tiles, 8 splits
    (1024, 4, 4096, 16, (4, 1024)),   # prefill: 68 row tiles, 4 splits
    (40, 4, 4096, 16, (8, 512)),      # verify width
    (8, 4, 4096, 4, (2, 2048)),       # rank 4: 32 lanes across k
    (8, 1, 72, 8, (1, 1024)),         # k shorter than one pass
])
def test_shrink_schedule(m, e, k, r, want):
    """The split of k is a pure function of the static shapes: whole
    passes a split, every split non-empty, covering k."""
    splits, ks = GM.lora_shrink_schedule(m, e, k, r)
    assert (splits, ks) == want
    assert (splits - 1) * ks < k <= splits * ks


@pytest.mark.parametrize("max_rank,refused", [(None, False), (16, False),
                                              (GM.LORA_MAX_RANK, False),
                                              (GM.LORA_MAX_RANK + 1, True)])
def test_card_shape_error_names_a_rank_the_expand_refuses(max_rank,
                                                          refused):
    """The engine's constructor on the card refuses an adapter store
    whose rank the LoRA expand kernel does not take, before any slot is
    claimed (the pure function it calls); ranks up to LORA_MAX_RANK
    pass."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.serving.engine import card_shape_error
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=1)
    err = card_shape_error(cfg, max_rank)
    if refused:
        assert err.startswith(f"adapter max_rank {max_rank}")
    else:
        assert err is None
