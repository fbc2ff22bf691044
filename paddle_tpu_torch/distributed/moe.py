"""Mixture-of-Experts, the single-device part — counterpart of
``paddle_tpu/distributed/moe.py``.

* **Sort-based routing** (:func:`top_k_route`): tokens are grouped by
  expert id with a stable sort and capacity is enforced by position within
  the group. No ``[T, E, C]`` one-hot tensor is built; slot priority is
  (choice j, token t), the GShard queue order, so the keep/drop decisions
  equal the dense formulation (:func:`top_k_gate`, kept as the executable
  spec). Ties in the top-k go to the lower expert index, as
  ``jax.lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
  promises no order).
* **Expert compute is a grouped GEMM** (``ops/cuda/grouped_matmul``, K6 on
  the card): the sorted route lays each expert's tokens out contiguously,
  so the SwiGLU runs over the ragged row partition. ``PT_GROUPED_GEMM=0``
  restores the dense capacity-padded dispatch/compute path.
* **The combine takes no atomics.** The route is a permutation of a
  choice-major list, so each token's k expert outputs are brought back by
  undoing the sort and summed over the k choices: the same bits on every
  run, where a scatter-add by token would add them in a changing order.
  The reference adds in expert order; with k = 2 the two orders are
  bit-equal, with k > 2 they differ in the last place.

The routing index tensors (``tok``, ``expert``, ``pos``, ``order``) are
int64, as PyTorch indexes; ``counts`` is int32, as the kernel takes it.
Nothing here reads a device value back to the host.

The expert-parallel path (``_forward_ep``: shard_map + all_to_all) comes
with ``distributed/`` (ROADMAP.md queue 1 item 7) and raises until then.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.ops.cuda import grouped_matmul as _gmm
from paddle_tpu_torch.ops.cuda.grouped_matmul import grouped_gemm_enabled


def _gate_probs(logits, k, renormalize=True):
    """softmax -> top-k -> (optionally) renormalised gates. Returns
    ([T, k] vals, idx, probs). ``renormalize=False`` keeps the raw softmax
    mass at the top-k (Qwen2-MoE's norm_topk_prob=False convention)."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, gate_idx, probs


def _aux_parts(probs, gate_idx):
    """Switch load-balance loss ingredients: (mean prob/expert, frac top-1
    tokens/expert). aux = E * sum(me * ce)."""
    e = probs.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(0)
    return me, ce


def top_k_gate(logits, k: int, capacity: int):
    """DENSE top-k gating with capacity — the executable GShard spec.
    O(T*E*C) memory; kept as the reference semantics that
    :func:`top_k_route` is tested against.

    logits: [T, E]. Returns (dispatch [T, E, C] bool, combine [T, E, C]
    float, aux_loss scalar)."""
    t, e = logits.shape
    gate_vals, gate_idx, probs = _gate_probs(logits, k)
    dev = logits.device
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    offset = torch.zeros((e,), dtype=torch.int64, device=dev)
    for j in range(k):
        choice = F.one_hot(gate_idx[:, j], e)                     # [T, E]
        pos_in_e = torch.cumsum(choice, 0) - 1 + offset[None, :]
        within = (pos_in_e < capacity) & (choice > 0)
        pos = torch.where(within, pos_in_e, 0).sum(1)             # [T]
        oh_pos = F.one_hot(pos, capacity).bool()
        d_j = within[..., None] & oh_pos[:, None, :]
        dispatch = dispatch | d_j
        combine = combine + d_j.float() * gate_vals[:, j][:, None, None]
        offset = offset + choice.sum(0)
    me, ce = _aux_parts(probs, gate_idx)
    return dispatch, combine, e * (me * ce).sum()


def top_k_route(logits, k: int, capacity: int, renormalize: bool = True):
    """Sort-based top-k routing — O(T*k log) compute, O(T*k) memory.

    logits: [T, E]. Returns ``(route, aux, drop_rate)`` where ``route`` is
    a dict of [N = T*k] tensors in expert-sorted order:

      tok    source token index
      expert destination expert
      pos    slot within the expert's queue (GShard (j, t) priority)
      keep   bool, pos < capacity (False = dropped)
      gate   f32 combine weight
      order  the sort: sorted row i is entry order[i] of the choice-major
             list (all j = 0 entries, then j = 1, ...)

    plus ``me``/``ce`` (the aux loss's parts) and ``counts`` — the [E]
    int32 per-expert assignment totals (pre-drop): the segment sizes of the
    sorted layout, i.e. the ``group_sizes`` of the grouped GEMM."""
    t, e = logits.shape
    n = t * k
    dev = logits.device
    gate_vals, gate_idx, probs = _gate_probs(logits, k, renormalize)

    flat_e = gate_idx.T.reshape(n)                 # choice-major [k*T]
    flat_gate = gate_vals.T.reshape(n)

    se, order = torch.sort(flat_e, stable=True)
    counts = torch.zeros((e,), dtype=torch.int32, device=dev).index_add_(
        0, flat_e, torch.ones((n,), dtype=torch.int32, device=dev))
    starts = torch.cumsum(counts, 0) - counts      # exclusive prefix
    pos = torch.arange(n, device=dev) - starts[se]
    keep = pos < capacity

    me, ce = _aux_parts(probs, gate_idx)
    # entry i of the choice-major list belongs to token i % T
    route = dict(tok=order % t, expert=se, pos=pos, keep=keep,
                 gate=flat_gate[order], order=order, me=me, ce=ce,
                 counts=counts)
    aux = e * (me * ce).sum()
    drop_rate = 1.0 - keep.float().mean()
    return route, aux, drop_rate


def _combine_by_token(rows, route, num_tokens: int):
    """rows [N, H] in expert-sorted order -> [T, H]: undo the sort (row i
    goes back to entry order[i] of the choice-major list, a copy through a
    permutation) and sum each token's k rows over the choices. No atomics:
    deterministic."""
    order = route["order"]
    flat = torch.empty_like(rows).index_copy_(0, order, rows)
    return flat.view(order.shape[0] // num_tokens, num_tokens, -1).sum(0)


def sparse_dispatch(xt, route, num_experts: int, capacity: int):
    """Scatter tokens into expert slots: [T, H] -> [E, C, H]. Dropped
    assignments go to a sink row past the last slot and are discarded."""
    h = xt.shape[1]
    sink = num_experts * capacity
    dest = torch.where(route["keep"],
                       route["expert"] * capacity + route["pos"], sink)
    x_e = xt.new_zeros((sink + 1, h))
    x_e = x_e.index_add(0, dest, xt.index_select(0, route["tok"]))
    return x_e[:sink].reshape(num_experts, capacity, h), dest


def sparse_combine(y_e, route, dest, num_tokens: int):
    """Gather expert outputs back to tokens with gate weights:
    [E, C, H] -> [T, H]. Dropped assignments contribute zero."""
    e, c, h = y_e.shape
    y_flat = torch.cat([y_e.reshape(e * c, h), y_e.new_zeros((1, h))], 0)
    gathered = y_flat.index_select(0, dest)
    gathered = gathered * route["gate"][:, None].to(y_flat.dtype)
    return _combine_by_token(gathered, route, num_tokens)


class ExpertMLP(nn.Module):
    """E SwiGLU expert MLPs with a leading expert axis."""

    def __init__(self, num_experts, hidden, intermediate, init):
        super().__init__()
        self.gate_up = init.normal(num_experts, hidden, 2 * intermediate)
        self.down = init.normal(num_experts, intermediate, hidden)

    def forward(self, x_e):
        """x_e: [E, C, H] — per-expert token slots."""
        return expert_mlp_apply(x_e, *_expert_arrays(self, x_e.dtype))


def _expert_arrays(experts, dtype):
    """The expert stacks as tensors of the compute type: a weight-only
    quantized stack (``serving.quant.QuantizedExpertStack``, anything that
    is not a tensor) dequantizes on the fly, so the grouped GEMM runs on
    it unchanged; plain tensors pass through. Duck-typed, so this module
    never imports the serving layer."""
    return tuple(w if isinstance(w, torch.Tensor) else w.dequantize(dtype)
                 for w in (experts.gate_up, experts.down))


def expert_mlp_apply(x_e, gate_up, down):
    """Row-independent SwiGLU over expert slots [E, C, H]."""
    gate, up = torch.chunk(torch.bmm(x_e, gate_up), 2, dim=-1)
    return torch.bmm(F.silu(gate) * up, down)


def grouped_mlp_apply(x_sorted, gate_up, down, group_sizes):
    """SwiGLU over the ragged sorted layout: ``x_sorted`` [N, H] rows
    contiguous per expert, ``group_sizes`` [E] segment sizes. Two grouped
    GEMMs — FLOPs track N, not E * capacity."""
    gu = _gmm.grouped_matmul(x_sorted, gate_up, group_sizes)
    gate, up = torch.chunk(gu, 2, dim=-1)
    return _gmm.grouped_matmul(F.silu(gate) * up, down, group_sizes)


def grouped_forward(xt, route, gate_up, down, num_tokens: int):
    """Sorted-layout expert forward + combine: gather tokens into
    expert-sorted rows, run the grouped SwiGLU over segment offsets, bring
    the rows back by source token with gate x keep weights. Dropped
    assignments ride through the GEMM with weight zero — the capacity
    path's results without the ``[E, C, H]`` dispatch buffer. The gather
    goes through the choice-major list (k copies of the tokens permuted by
    the sort), so its backward sums each token's k cotangents without
    colliding writes. At the decode shape with no gradient recorded
    (:func:`_decode_fused`) the same function runs as
    :func:`decode_forward`."""
    if _decode_fused(xt, route, gate_up, down):
        return decode_forward(xt, route, gate_up, down, num_tokens)
    n = route["order"].shape[0]
    k = n // num_tokens
    x_sorted = xt.unsqueeze(0).expand(k, *xt.shape).reshape(
        n, xt.shape[1]).index_select(0, route["order"])
    y_sorted = grouped_mlp_apply(x_sorted, gate_up, down, route["counts"])
    wgt = (route["gate"] * route["keep"]).to(y_sorted.dtype)
    return _combine_by_token(y_sorted * wgt[:, None], route, num_tokens)


def _decode_fused(xt, route, gate_up, down) -> bool:
    """Whether :func:`grouped_forward` takes :func:`decode_forward`: no
    gradient is recorded, and ``moe_decode_route`` holds for the static
    shapes (the sorted rows, the experts, the widths), the dtype and the
    weights' alignment. A route, not a fallback: the CPU takes it at the
    same shapes and runs the kernels' plain versions."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xt, gate_up, down)):
        return False
    e, h, two_inter = gate_up.shape
    return (down.dtype == gate_up.dtype == xt.dtype
            and _gmm.moe_decode_route(
                route["order"].shape[0], e, h, two_inter // 2, xt.dtype,
                gate_up.data_ptr() % 16 == 0 and down.data_ptr() % 16 == 0))


def decode_forward(xt, route, gate_up, down, num_tokens: int):
    """:func:`grouped_forward`'s function as two launches of K6a's decode
    route and one sum: the gate_up product reads the tokens through
    ``route["tok"]`` in place; the down product forms SwiGLU on load,
    multiplies each row by its cast ``gate * keep`` weight and writes it
    to its place in the choice-major list (``route["order"]``); the k
    choices of each token are then summed. Every step rounds as the
    unfused composition does; on CPU tensors the wrappers run that
    composition (``moe_gate_up_plain``, ``moe_down_plain``)."""
    n = route["order"].shape[0]
    gu = _gmm.moe_gate_up(xt, route["tok"], gate_up, route["counts"])
    flat = _gmm.moe_down(gu, down, route["counts"], route["gate"],
                         route["keep"], route["order"])
    return flat.view(n // num_tokens, num_tokens, -1).sum(0)


class MoELayer(nn.Module):
    """Drop-in MLP replacement. ``forward`` returns ``(y, aux)`` — the aux
    loss for the trainer to add — ``y`` alone with ``return_aux=False``,
    and the drop rate with ``return_metrics=True``. ``init`` draws the
    parameters (``models.llama._Init``): the gate ``gate_w`` in fp32, the
    expert stacks in the model's type."""

    def __init__(self, hidden, intermediate, num_experts, k=2,
                 capacity_factor=1.25, norm_topk_prob=True, *, init):
        super().__init__()
        self.gate_w = init.normal(hidden, num_experts, dtype=torch.float32)
        self.experts = ExpertMLP(num_experts, hidden, intermediate, init)
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.norm_topk_prob = norm_topk_prob

    def _capacity(self, tokens: int) -> int:
        if self.capacity_factor is None:
            # EXACT (dropless) mode: every expert can take every token
            return max(tokens, 4)
        cap = int(self.capacity_factor * self.k * tokens / self.num_experts
                  + 0.999)
        return max(cap, 4)

    def forward(self, x, return_aux=True, return_metrics=False):
        y, aux, drop = self._forward_local(x)
        if return_metrics:
            return y, aux, {"drop_rate": drop}
        return (y, aux) if return_aux else y

    def _forward_local(self, x):
        b, s, h = x.shape
        t = b * s
        cap = self._capacity(t)
        xt = x.reshape(t, h)
        logits = xt.float() @ self.gate_w
        route, aux, drop = top_k_route(logits, self.k, cap,
                                       self.norm_topk_prob)
        gate_up, down = _expert_arrays(self.experts, x.dtype)
        if grouped_gemm_enabled():
            yt = grouped_forward(xt, route, gate_up, down, t)
        else:
            x_e, dest = sparse_dispatch(xt, route, self.num_experts, cap)
            y_e = expert_mlp_apply(x_e, gate_up, down)
            yt = sparse_combine(y_e, route, dest, t)
        return yt.reshape(b, s, h), aux, drop

    def _forward_ep(self, x, mesh, ep):
        raise NotImplementedError(
            "expert-parallel MoE (shard_map + all_to_all over an ep mesh "
            "axis) is not ported yet (ROADMAP.md queue 1 item 7, "
            "distributed)")
