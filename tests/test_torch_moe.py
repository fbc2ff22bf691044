"""The port's single-device MoE stack against ``paddle_tpu.distributed.moe``.

Routing is discrete, so ``top_k_route``'s decisions (``tok``, ``expert``,
``pos``, ``keep``, ``counts``) must equal the reference's exactly — also on
logits with exact ties, which ``jax.lax.top_k`` gives to the lower expert
index — and ``gate`` within 1e-6 (one fp32 softmax). The layer's output, aux
loss and drop rate agree within 1e-5 in fp32 (the same arithmetic in
another summation order), for a capacity factor of 1.25, a saturated 0.4
and the dropless mode, renormalised and not. Same weights on both sides
(``load_jax_state_dict``), inputs from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.models.convert import load_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, _Init
from tests.test_torch_common import to_np

CAPACITIES = [1.25, 0.4, None]
CAP_IDS = ["c1.25", "c0.4", "dropless"]
INT_KEYS = ("tok", "expert", "pos", "keep", "counts")


def _logits(t, e, seed, ties=False):
    rs = np.random.RandomState(seed)
    if ties:                       # few distinct values: many exact ties
        return rs.randint(0, 3, (t, e)).astype(np.float32)
    return rs.randn(t, e).astype(np.float32)


def _capacity(factor, k, t, e):
    if factor is None:
        return max(t, 4)
    return max(int(factor * k * t / e + 0.999), 4)


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("factor", CAPACITIES, ids=CAP_IDS)
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_top_k_route_equals_reference(factor, renorm, ties):
    t, e, k = 48, 8, 2
    cap = _capacity(factor, k, t, e)
    logits = _logits(t, e, 0, ties)
    want, jaux, jdrop = jmoe.top_k_route(jnp.asarray(logits), k, cap, renorm)
    got, aux, drop = tmoe.top_k_route(torch.as_tensor(logits), k, cap, renorm)
    for key in INT_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["counts"].dtype == torch.int32
    np.testing.assert_allclose(to_np(got["gate"]), np.asarray(want["gate"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(drop), float(jdrop), atol=1e-7)
    if factor == 0.4:
        assert float(drop) > 0, "the case must saturate"
    # the route is a permutation of the choice-major list
    order = got["order"].numpy()
    assert sorted(order.tolist()) == list(range(t * k))
    np.testing.assert_array_equal(got["tok"].numpy(), order % t)


@pytest.mark.parametrize("factor", CAPACITIES, ids=CAP_IDS)
def test_top_k_route_agrees_with_the_dense_spec(factor):
    """Every kept assignment of the sorted route sits at dispatch[tok,
    expert, pos] of the port's own ``top_k_gate`` with its gate as the
    combine weight, and nothing else is dispatched."""
    t, e, k = 40, 8, 3
    cap = _capacity(factor, k, t, e)
    logits = torch.as_tensor(_logits(t, e, 1))
    dispatch, combine, aux_d = tmoe.top_k_gate(logits, k, cap)
    route, aux, _ = tmoe.top_k_route(logits, k, cap)
    keep = route["keep"]
    tok, exp, pos = (route[n][keep] for n in ("tok", "expert", "pos"))
    want = torch.zeros_like(dispatch)
    want[tok, exp, pos] = True
    assert torch.equal(dispatch, want)
    np.testing.assert_allclose(to_np(combine[tok, exp, pos]),
                               to_np(route["gate"][keep]), atol=1e-7)
    np.testing.assert_allclose(float(aux), float(aux_d), rtol=1e-6)
    # and the dense spec itself equals the reference's
    jd, jc, jaux = jmoe.top_k_gate(jnp.asarray(logits.numpy()), k, cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(to_np(combine), np.asarray(jc), atol=1e-6)


def _layer_pair(factor, renorm, h=32, inter=64, e=4, k=2):
    pt.seed(0)
    jl = jmoe.MoELayer(h, inter, e, k=k, capacity_factor=factor,
                       dtype=jnp.float32, norm_topk_prob=renorm)
    init = _Init(LlamaConfig.tiny(), torch.device("cpu"), 0)
    tl = tmoe.MoELayer(h, inter, e, k=k, capacity_factor=factor,
                       norm_topk_prob=renorm, init=init)
    load_jax_state_dict(tl, jl.state_dict())
    return jl, tl


@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("factor", CAPACITIES, ids=CAP_IDS)
def test_moe_layer_matches_reference(factor, renorm, monkeypatch):
    jl, tl = _layer_pair(factor, renorm)
    assert tl.gate_w.dtype == torch.float32
    assert set(dict(tl.named_parameters())) == {
        "gate_w", "experts.gate_up", "experts.down"}
    x = np.random.RandomState(2).randn(2, 24, 32).astype(np.float32)
    jy, jaux, jm = jl(jnp.asarray(x), return_metrics=True)
    y, aux, m = tl(torch.as_tensor(x), return_metrics=True)
    np.testing.assert_allclose(to_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(m["drop_rate"]), float(jm["drop_rate"]),
                               atol=1e-7)
    assert tl._capacity(48) == jl._capacity(48)
    # the dense capacity path behind the kill switch gives the same output
    monkeypatch.setenv("PT_GROUPED_GEMM", "0")
    y_off, aux_off = tl(torch.as_tensor(x))
    np.testing.assert_allclose(to_np(y_off), to_np(y), rtol=1e-5, atol=1e-6)
    assert float(aux_off) == float(aux)
    assert isinstance(tl(torch.as_tensor(x), return_aux=False), torch.Tensor)


def test_kill_switch_takes_the_dense_path(monkeypatch):
    """With PT_GROUPED_GEMM=0 the layer never reaches the grouped GEMM."""
    _, tl = _layer_pair(1.25, True)
    x = torch.as_tensor(np.random.RandomState(3).randn(1, 16, 32).astype(
        np.float32))
    calls = []
    real = tmoe._gmm.grouped_matmul
    monkeypatch.setattr(tmoe._gmm, "grouped_matmul",
                        lambda *a: calls.append(1) or real(*a))
    tl(x)
    assert len(calls) == 2                 # gate_up and down
    monkeypatch.setenv("PT_GROUPED_GEMM", "0")
    tl(x)
    assert len(calls) == 2


def test_combine_is_the_sum_over_choices_in_order():
    """The no-atomics combine equals a scatter-add by token."""
    t, k, h = 12, 3, 5
    route, _, _ = tmoe.top_k_route(torch.as_tensor(_logits(t, 6, 4)), k, t)
    rows = torch.as_tensor(np.random.RandomState(5).randn(t * k, h).astype(
        np.float32))
    got = tmoe._combine_by_token(rows, route, t)
    want = torch.zeros(t, h).index_add_(0, route["tok"], rows)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-6)


def test_unported_paths_raise_naming_their_queue_item():
    """The expert-parallel path is ported (``tests/test_torch_dist_moe.py``
    holds it to the reference): it refuses what the reference refuses,
    experts that do not divide over ep, and the one combination it does
    not take, ep with the sequence split over sp."""
    _, tl = _layer_pair(None, True)
    x = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="not divisible by ep"):
        tl._forward_ep(x, mesh=None, ep=tl.num_experts + 1)

    class _SpMesh:       # the size queries of a mesh with every axis 2
        def size(self, axes):
            return 2

    with pytest.raises(NotImplementedError, match="sequence split over sp"):
        tl._forward_ep(x, mesh=_SpMesh(), ep=2)


@pytest.mark.parametrize("grouped", ["1", "0"], ids=["grouped", "dense"])
def test_quantized_stack_dequantizes_on_the_fly(grouped, monkeypatch):
    """A stack that is not a tensor (a weight-only quantized one) is
    dequantized to the compute type inside the forward, on both expert
    paths; the tensors it gives back make the layer's output."""
    monkeypatch.setenv("PT_GROUPED_GEMM", grouped)
    _, tl = _layer_pair(None, True)
    x = torch.as_tensor(np.random.RandomState(3).randn(2, 6, 32).astype(
        np.float32))
    want = tl(x)[0]
    seen = []

    class Quantized:                       # stands in for a quantized stack
        def __init__(self, w):
            self.w = w.detach().clone()

        def dequantize(self, dtype):
            seen.append(dtype)
            return self.w.to(dtype)

    gu = tl.experts.gate_up
    del tl.experts.gate_up                 # drop the parameter, then shadow
    tl.experts.gate_up = Quantized(gu)
    np.testing.assert_array_equal(to_np(tl(x)[0]), to_np(want))
    assert seen == [torch.float32]
