"""K6's plain PyTorch versions against the Pallas grouped-GEMM kernels.

On the CPU ``grouped_matmul`` runs ``grouped_matmul_plain`` (forward) and
``grouped_matmul_bwd_plain`` (backward); the CUDA kernels are held to these
on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``). Here the
plain versions are held to ``paddle_tpu``'s Pallas kernels in interpret
mode and to its dense one-hot reference, over the ragged cases of
``tests/test_grouped_matmul.py`` (empty groups, one-row groups, leading
empty groups) plus all rows in one group of several. Inputs come from a
numpy seed. Tolerances: fp32 1e-5 forward (one fp32 product, summed in
another order), 1e-4 for the gradients (two chained products); bf16 2e-2
scaled by 1 + |value| (both accumulate in fp32 and round once to bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.grouped_matmul import (
    grouped_matmul as j_grouped_matmul, grouped_matmul_reference)
from paddle_tpu_torch.models.convert import to_tensor
from paddle_tpu_torch.ops.cuda import grouped_matmul as GM
from tests.test_torch_common import to_np

RAGGED_CASES = [
    # (experts, k_dim, n_dim, group_sizes)
    (4, 32, 64, [5, 0, 1, 10]),
    (8, 16, 32, [0, 0, 3, 1, 0, 7, 1, 0]),
    (1, 8, 128, [9]),
    (6, 64, 48, [128, 0, 1, 300, 1, 2]),     # n not a multiple of 128
    (3, 16, 16, [0, 0, 4]),                  # leading empty experts
    (5, 24, 40, [0, 0, 37, 0, 0]),           # all rows in one group
]
IDS = [f"e{c[0]}_k{c[1]}_n{c[2]}" for c in RAGGED_CASES]


def _case(e, k, n, sizes, seed=0):
    rs = np.random.RandomState(seed)
    m = sum(sizes)
    return (rs.randn(m, k).astype(np.float32),
            rs.randn(e, k, n).astype(np.float32),
            np.asarray(sizes, np.int32))


@pytest.mark.parametrize("case", RAGGED_CASES, ids=IDS)
def test_plain_forward_matches_pallas_and_dense_reference(case):
    lhs, rhs, gs = _case(*case)
    got = GM.grouped_matmul(torch.as_tensor(lhs), torch.as_tensor(rhs),
                            torch.as_tensor(gs))
    pallas = j_grouped_matmul(jnp.asarray(lhs), jnp.asarray(rhs),
                              jnp.asarray(gs), impl="pallas", interpret=True)
    dense = grouped_matmul_reference(jnp.asarray(lhs), jnp.asarray(rhs),
                                     jnp.asarray(gs))
    assert got.dtype == torch.float32 and tuple(got.shape) == pallas.shape
    np.testing.assert_allclose(to_np(got), np.asarray(pallas), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(dense), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", RAGGED_CASES[:4], ids=IDS[:4])
def test_plain_forward_bf16_matches_pallas(case):
    lhs, rhs, gs = _case(*case, seed=1)
    jl, jr = (jnp.asarray(a, jnp.bfloat16) for a in (lhs, rhs))
    pallas = j_grouped_matmul(jl, jr, jnp.asarray(gs), impl="pallas",
                              interpret=True)
    got = GM.grouped_matmul(to_tensor(np.asarray(jl)),
                            to_tensor(np.asarray(jr)), torch.as_tensor(gs))
    assert got.dtype == torch.bfloat16
    want = np.asarray(pallas.astype(jnp.float32))
    assert np.all(np.abs(to_np(got) - want) <= 2e-2 * (1 + np.abs(want)))


@pytest.mark.parametrize("case", RAGGED_CASES, ids=IDS)
def test_autograd_matches_grad_of_the_pallas_kernels(case):
    """dlhs and drhs of the autograd wrapper against ``jax.grad`` through
    the interpreted Pallas kernels (``_fwd_kernel`` on the transposed
    weights and ``_dw_kernel``); an empty group's drhs is exactly 0."""
    lhs, rhs, gs = _case(*case, seed=2)
    cot = np.random.RandomState(3).randn(lhs.shape[0], rhs.shape[2]).astype(
        np.float32)

    def f(a, b):
        out = j_grouped_matmul(a, b, jnp.asarray(gs), impl="pallas",
                               interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    ja, jb = jax.grad(f, argnums=(0, 1))(jnp.asarray(lhs), jnp.asarray(rhs))
    tl = torch.as_tensor(lhs).requires_grad_()
    tr = torch.as_tensor(rhs).requires_grad_()
    tg = torch.as_tensor(gs)
    (GM.grouped_matmul(tl, tr, tg) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(to_np(tl.grad), np.asarray(ja), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_np(tr.grad), np.asarray(jb), rtol=1e-4,
                               atol=1e-4)
    empty = np.asarray(gs) == 0
    assert float(tr.grad[torch.as_tensor(empty)].abs().sum()) == 0.0
    assert tg.grad is None and not tg.requires_grad


def test_bwd_plain_is_what_the_wrapper_runs_and_handles_transposed_rhs():
    lhs, rhs, gs = (torch.as_tensor(a) for a in _case(*RAGGED_CASES[0]))
    g = torch.as_tensor(np.random.RandomState(4).randn(
        lhs.shape[0], rhs.shape[2]).astype(np.float32))
    dlhs, drhs = GM.grouped_matmul_bwd_plain(lhs, rhs, gs, g)
    # dlhs is the forward against rhs read as [E, n, k]
    want = GM.grouped_matmul_plain(g, rhs.transpose(1, 2).contiguous(), gs)
    np.testing.assert_allclose(to_np(dlhs), to_np(want), rtol=1e-6,
                               atol=1e-6)
    assert dlhs.shape == lhs.shape and drhs.shape == rhs.shape
    assert float(drhs[1].abs().sum()) == 0.0          # the empty group


def test_no_graph_means_no_autograd_function():
    lhs, rhs, gs = (torch.as_tensor(a) for a in _case(*RAGGED_CASES[1]))
    assert GM.grouped_matmul(lhs, rhs, gs).grad_fn is None
    with torch.no_grad():
        out = GM.grouped_matmul(lhs.requires_grad_(), rhs, gs)
    assert out.grad_fn is None and not out.requires_grad


def test_bad_shapes_and_types_raise():
    lhs, rhs, gs = (torch.as_tensor(a) for a in _case(*RAGGED_CASES[0]))
    with pytest.raises(ValueError, match="bad grouped_matmul shapes"):
        GM.grouped_matmul(lhs[:, :-1], rhs, gs)
    with pytest.raises(ValueError, match="bad grouped_matmul shapes"):
        GM.grouped_matmul(lhs[None], rhs, gs)
    with pytest.raises(ValueError, match="bad grouped_matmul shapes"):
        GM.grouped_matmul(lhs, rhs[0], gs)
    with pytest.raises(ValueError, match="group_sizes"):
        GM.grouped_matmul(lhs, rhs, gs[:-1])
    with pytest.raises(TypeError, match="differ"):
        GM.grouped_matmul(lhs.bfloat16(), rhs, gs)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        GM.grouped_matmul(lhs.double(), rhs.double(), gs)
    with pytest.raises(TypeError, match="int32"):
        GM.grouped_matmul(lhs, rhs, gs.long())


def test_kill_switch_reads_the_environment(monkeypatch):
    assert GM.grouped_gemm_enabled()
    monkeypatch.setenv("PT_GROUPED_GEMM", "0")
    assert not GM.grouped_gemm_enabled()


def test_kernel_choice_reads_static_shapes_only():
    """The decode route is chosen from m, E, k, n, the dtype and the
    weights' alignment: the decode shape takes it, the prefill/train
    shapes, a transposed rhs, a k or an n its 16-byte copies cannot take,
    unaligned weights and more rows or groups than its tables hold do
    not."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert GM.fwd_route(32, 60, 16, 64, bf16) == "decode"
    assert GM.fwd_route(8 * 60, 60, 16, 64, bf16) == "decode"
    assert GM.fwd_route(8 * 60 + 1, 60, 16, 64, bf16) != "decode"
    assert GM.fwd_route(32, 60, 16, 64, bf16, trans=True) != "decode"
    assert GM.fwd_route(32, 60, 16, 60, bf16) != "decode"   # 60 % 8 != 0
    assert GM.fwd_route(32, 60, 16, 60, f32) == "decode"    # 60 % 4 == 0
    assert GM.fwd_route(32, 60, 20, 64, bf16) != "decode"   # 20 % 8 != 0
    assert GM.fwd_route(32, 60, 20, 64, f32) == "decode"    # 20 % 4 == 0
    assert GM.fwd_route(32, 60, 16, 64, bf16, aligned=False) != "decode"
    assert GM.fwd_route(GM.DECODE_MAX_ROWS, 256, 16, 64, bf16) == "decode"
    assert GM.fwd_route(GM.DECODE_MAX_ROWS + 8, 512, 16, 64,
                        bf16) != "decode"
    assert GM.fwd_route(8, GM.DECODE_MAX_GROUPS + 1, 16, 64,
                        bf16) != "decode"


# (label, m, E, k, n, trans, aligned, route for bf16, route for float32):
# Qwen1.5-MoE-A2.7B's shapes (hidden 2048, experts 60 of 1408, top-4)
ROUTE_CASES = [
    ("decode_gate_up", 32, 60, 2048, 2816, False, True, "decode", "decode"),
    ("decode_down", 32, 60, 1408, 2048, False, True, "decode", "decode"),
    ("decode_dlhs", 32, 60, 2816, 2048, True, True, "wgmma", "fma"),
    ("prefill_gate_up", 4096, 60, 2048, 2816, False, True, "wgmma", "fma"),
    ("train_gate_up", 16384, 60, 2048, 2816, False, True, "wgmma", "fma"),
    ("train_dlhs", 16384, 60, 2816, 2048, True, True, "wgmma", "fma"),
    ("ragged_k72", 207, 8, 72, 200, False, True, "wgmma", "fma"),
    ("k_off_8", 4096, 60, 2044, 2816, False, True, "fma", "fma"),
    ("n_off_8", 4096, 60, 2048, 2812, True, True, "fma", "fma"),
    ("unaligned", 4096, 60, 2048, 2816, False, False, "fma", "fma"),
    ("unaligned_decode", 32, 60, 2048, 2816, False, False, "fma", "fma"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_fwd_route_names_a_kernel_for_every_shape_and_dtype(case, dtype):
    """fwd_route is a pure function of the static shapes, the dtype and
    the weights' alignment: bf16 takes the tensor cores at the prefill and
    train shapes, forward and dlhs; float32 keeps fp32 FMAs; the decode
    shape takes the decode route; whatever the tensor-core route
    refuses names the FMA kernel, never the plain version."""
    _, m, e, k, n, trans, aligned, bf16_route, f32_route = case
    route = GM.fwd_route(m, e, k, n, dtype, trans, aligned)
    assert route == (bf16_route if dtype == torch.bfloat16 else f32_route)
    assert route in GM._KIND


# (label, m, E, k, n, aligned, route for bf16, route for float32): K6b at
# Qwen1.5-MoE-A2.7B's train shapes and at the edges of its tensor-core
# route
DW_ROUTE_CASES = [
    ("train_gate_up", 16384, 60, 2048, 2816, True, "wgmma", "fma"),
    ("train_down", 16384, 60, 1408, 2048, True, "wgmma", "fma"),
    ("ragged_k200_n264", 1023, 8, 200, 264, True, "wgmma", "fma"),
    ("no_rows", 0, 8, 200, 264, True, "wgmma", "fma"),
    ("k_off_8", 16384, 60, 2044, 2816, True, "fma", "fma"),
    ("n_off_8", 16384, 60, 2048, 2812, True, "fma", "fma"),
    ("unaligned", 16384, 60, 2048, 2816, False, "fma", "fma"),
    ("max_groups", 4096, GM.DW_WGMMA_MAX_GROUPS, 64, 64, True, "wgmma",
     "fma"),
    ("too_many_groups", 4096, GM.DW_WGMMA_MAX_GROUPS + 1, 64, 64, True,
     "fma", "fma"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", DW_ROUTE_CASES,
                         ids=[c[0] for c in DW_ROUTE_CASES])
def test_dw_route_names_a_kernel_for_every_shape_and_dtype(case, dtype):
    """dw_route is a pure function of the static shapes, the dtype and
    the alignment of lhs, g and the result: bf16 takes the tensor cores
    wherever k and n are multiples of 8 and the groups' offsets fit its
    shared memory, whatever the rows; float32 and whatever the tensor-core
    route refuses name the FMA kernel, never the plain version."""
    _, m, e, k, n, aligned, bf16_route, f32_route = case
    route = GM.dw_route(m, e, k, n, dtype, aligned)
    assert route == (bf16_route if dtype == torch.bfloat16 else f32_route)
    assert route in GM._KIND and route != "decode"
    assert route in GM.grouped_dw.route_launches


def test_reset_launches_zeroes_the_per_kernel_counts():
    """K6a and K6b count each kernel's launches apart from their totals,
    and reset_launches zeroes both, as a path's run needs before it
    counts."""
    from paddle_tpu_torch.ops import cuda as K
    GM.grouped_dw.launches = 3
    GM.grouped_dw.route_launches.update(wgmma=2, fma=1)
    GM.grouped_matmul.launches = 4
    GM.grouped_matmul.route_launches.update(decode=1, wgmma=2, fma=1)
    assert K.route_launches()["grouped_dw"] == {"wgmma": 2, "fma": 1}
    assert K.route_launches()["grouped_fwd"] == {"decode": 1, "wgmma": 2,
                                                 "fma": 1}
    K.reset_launches()
    assert GM.grouped_dw.launches == GM.grouped_matmul.launches == 0
    assert K.route_launches() == {
        "grouped_fwd": {"decode": 0, "wgmma": 0, "fma": 0},
        "grouped_dw": {"wgmma": 0, "fma": 0}}


# groups that straddle the 64-row warpgroups and 128-row tiles of the
# tensor-core route, with empty and one-row groups
TILE_EDGE_SIZES = [63, 0, 64, 65, 1, 129, 0, 130]


def test_plain_forward_and_dlhs_bf16_match_pallas_at_tile_edges():
    """In bf16, the plain forward and the plain dlhs (the forward against
    rhs read transposed) against the interpreted Pallas kernels and
    jax.vjp through them, over a partition whose groups straddle 64- and
    128-row tiles; both accumulate in fp32 and round once to bf16, so they
    agree within 2e-2 * (1 + |value|)."""
    e, k, n = len(TILE_EDGE_SIZES), 24, 40
    lhs, rhs, gs = _case(e, k, n, TILE_EDGE_SIZES, seed=5)
    cot = np.random.RandomState(6).randn(lhs.shape[0], n).astype(np.float32)
    jl, jr, jc = (jnp.asarray(a, jnp.bfloat16) for a in (lhs, rhs, cot))
    out, vjp = jax.vjp(lambda a: j_grouped_matmul(
        a, jr, jnp.asarray(gs), impl="pallas", interpret=True), jl)
    (jdlhs,) = vjp(jc)
    tl, tr, tc = (to_tensor(np.asarray(a)) for a in (jl, jr, jc))
    tg = torch.as_tensor(gs)
    got = GM.grouped_matmul(tl, tr, tg)
    dlhs, _ = GM.grouped_matmul_bwd_plain(tl, tr, tg, tc)
    for mine, ref in ((got, out), (dlhs, jdlhs)):
        assert mine.dtype == torch.bfloat16
        want = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(to_np(mine) - want) <= 2e-2 * (1 + np.abs(want)))
