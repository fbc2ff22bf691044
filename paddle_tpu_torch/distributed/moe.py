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

Under a mesh, one process per rank (the reference runs one program over
the global batch):

* **Data axes with ep = 1** (``MoELayer._forward_local`` with a mesh):
  each rank routes its own rows, but as the reference's one program
  routes the GLOBAL batch — capacity ``_capacity(global tokens)``, queue
  positions global and choice-major (one all-gather of the per-row,
  per-choice expert counts gives each rank where its entries stand in
  every expert's queue), ``me``/``ce`` and the drop rate averaged over the
  token axes through the differentiable all-reduce, so the aux loss and
  its gradient are the reference's.
* **ep > 1** (``MoELayer._forward_ep``): each rank routes its tokens with
  LOCAL capacity (the reference's per-rank semantics), an all_to_all over
  ep sends the ``[E, C, H]`` slots to the experts' ranks, the received
  slots are compacted (their counts ride a second all_to_all) so the
  grouped GEMM (K6a forward and dlhs, K6b drhs on the card) runs over
  ``sum(counts)`` rows, and the reverse all_to_all brings the outputs
  back. A model under ``distributed.shard_module`` holds its rank's
  experts (the stacks' spec is ``("ep", None, None)``); an unsharded one
  holds all and each rank takes its slice.

Which tokens a rank holds is said, not guessed: a train step hands every
rank its own rows; a server holds the whole batch on every rank and
enters :func:`replicated_tokens`, under which the ep path takes this
rank's share of the flattened tokens and all-gathers the result, and the
data-axis path routes the batch it holds.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.mesh import DATA_AXES
from paddle_tpu_torch.distributed.sharded import TOKEN_AXES, set_pspec
from paddle_tpu_torch.ops.cuda import grouped_matmul as _gmm
from paddle_tpu_torch.ops.cuda.grouped_matmul import grouped_gemm_enabled

_REPLICATED = contextvars.ContextVar("moe_replicated_tokens", default=False)


@contextlib.contextmanager
def replicated_tokens():
    """Inside, an MoE layer under a mesh takes its input as the whole batch,
    the same on every rank (a server's activations), not this rank's rows
    (a train step's)."""
    token = _REPLICATED.set(True)
    try:
        yield
    finally:
        _REPLICATED.reset(token)


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
    """E SwiGLU expert MLPs with a leading expert axis, ep-sharded."""

    def __init__(self, num_experts, hidden, intermediate, init):
        super().__init__()
        self.gate_up = init.normal(num_experts, hidden, 2 * intermediate)
        self.down = init.normal(num_experts, intermediate, hidden)
        # experts over the ep mesh axis (expert parallelism)
        set_pspec(self, "gate_up", ("ep", None, None))
        set_pspec(self, "down", ("ep", None, None))

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
        from paddle_tpu_torch.distributed.mesh import current_mesh
        mesh = current_mesh()
        ep = mesh.size("ep") if mesh is not None else 1
        if ep > 1:
            y, aux, drop = self._forward_ep(x, mesh, ep)
        else:
            y, aux, drop = self._forward_local(x, mesh)
        if return_metrics:
            return y, aux, {"drop_rate": drop}
        return (y, aux) if return_aux else y

    def _forward_local(self, x, mesh=None):
        """The layer over the tokens ``x`` [B, S, H] holds. Under a mesh
        whose token axes (dp, fsdp, sp) hold more than one rank, ``x`` is
        this rank's piece of the global batch (its rows, its sequence
        block) and the routing is the reference's over the global batch
        (:func:`_global_route`); under :func:`replicated_tokens` ``x`` is
        the whole batch and the routing local."""
        b, s, h = x.shape
        t = b * s
        shards = 1
        if mesh is not None and not _REPLICATED.get():
            shards = mesh.size(TOKEN_AXES)
        cap = self._capacity(t * shards)
        xt = x.reshape(t, h)
        logits = xt.float() @ self.gate_w
        route, aux, drop = top_k_route(logits, self.k, cap,
                                       self.norm_topk_prob)
        if shards > 1:
            route, aux, drop = _global_route(route, s, self.k, cap, mesh)
        gate_up, down = _expert_arrays(self.experts, x.dtype)
        if grouped_gemm_enabled():
            yt = grouped_forward(xt, route, gate_up, down, t)
        else:
            x_e, dest = sparse_dispatch(xt, route, self.num_experts, cap)
            y_e = expert_mlp_apply(x_e, gate_up, down)
            yt = sparse_combine(y_e, route, dest, t)
        return yt.reshape(b, s, h), aux, drop

    def _forward_ep(self, x, mesh, ep):
        """Expert parallelism over the mesh's ep axis: tokens sharded over
        (dp, fsdp, ep), each rank's experts ``E / ep`` of them. ``x`` is
        this rank's rows, or under :func:`replicated_tokens` the whole
        batch, of which the rank takes its share of the flattened tokens
        (the reference's spec) and all-gathers the outputs."""
        e = self.num_experts
        if e % ep != 0:
            raise ValueError(f"num_experts={e} not divisible by ep={ep}")
        if mesh.size("sp") > 1:
            raise NotImplementedError(
                "expert parallelism with the sequence split over sp: the "
                "reference shards an ep rank's tokens over the data axes "
                "alone; train MoE layers over ep with sp = 1")
        b, s, h = x.shape
        t = b * s
        xt = x.reshape(t, h)
        shards = mesh.size(DATA_AXES)
        replicated = _REPLICATED.get()
        if replicated:
            if t % shards != 0:
                raise ValueError(
                    f"tokens {t} (= {b}x{s}) not divisible by "
                    f"dp*fsdp*ep={shards} (tokens are sharded over the data "
                    f"axes)")
            xt = xt.view(shards, t // shards, h)[mesh.index(DATA_AXES)]
        yt, aux, drop = self._ep_tokens(xt, mesh, ep)
        if replicated:
            # a server's forward: no gradient travels back through here
            yt = C.gather_dim(yt, mesh.group(DATA_AXES), shards, 0)
        return yt.reshape(b, s, h), aux, drop

    def _ep_tokens(self, xt, mesh, ep):
        """The ep layer over this rank's tokens ``xt`` [T, H]."""
        e, k = self.num_experts, self.k
        el = e // ep
        tl, h = xt.shape
        # LOCAL capacity — the reference's per-rank semantics: a rank fills
        # at most C slots of each (global) expert
        cap = self._capacity(tl)
        logits = xt.float() @ self.gate_w
        route, _, _ = top_k_route(logits, k, cap, self.norm_topk_prob)
        me, ce, kept = _token_means(mesh, DATA_AXES, route["me"], route["ce"],
                                    route["keep"].float().mean())
        aux, drop = e * (me * ce).sum(), 1.0 - kept
        gate_up, down = self._local_experts(xt.dtype, mesh, ep)
        # send buffer: my tokens in every expert's queue; the all_to_all
        # gives x_recv[s] = rank s's slots of MY experts
        x_send, dest = sparse_dispatch(xt, route, e, cap)
        x_recv = C.all_to_all(x_send.reshape(ep, el, cap, h),
                              axis_name="ep", split_axis=0, concat_axis=0,
                              mesh=mesh)
        if grouped_gemm_enabled():
            y_loc = _compact_mlp(x_recv, route, e, ep, cap, gate_up, down,
                                 mesh)
        else:
            # dense path: senders folded into the slot dim, padded MLP
            x_loc = x_recv.transpose(0, 1).reshape(el, ep * cap, h)
            y_loc = expert_mlp_apply(x_loc, gate_up, down).view(
                el, ep, cap, h)
        y_recv = C.all_to_all(y_loc.transpose(0, 1).contiguous(),
                              axis_name="ep", split_axis=0, concat_axis=0,
                              mesh=mesh)
        return (sparse_combine(y_recv.reshape(e, cap, h), route, dest, tl),
                aux, drop)

    def _local_experts(self, dtype, mesh, ep):
        """This rank's ``E / ep`` expert stacks: the parameters of a model
        ``shard_module`` sharded over ep, else this rank's slice of the
        whole stacks every rank holds (a server's unsharded model)."""
        gate_up, down = _expert_arrays(self.experts, dtype)
        if gate_up.shape[0] == self.num_experts:
            i = mesh.index("ep")
            gate_up, down = gate_up.chunk(ep, 0)[i], down.chunk(ep, 0)[i]
        return gate_up, down


def _token_means(mesh, axes, *xs):
    """Each of ``xs`` (per-rank means over equal token counts) averaged
    over the mesh ``axes`` through the differentiable all-reduce: the
    means over the global batch."""
    return tuple(C.all_reduce(x, C.ReduceOp.AVG, axis_name=axes, mesh=mesh)
                 for x in xs)


def _global_route(route, s_loc, k, capacity, mesh):
    """The route of this rank's tokens as the reference's routing of the
    GLOBAL batch places them: ``route`` is :func:`top_k_route` of the
    rank's [B_loc * S_loc] tokens, which are rows [r*B_loc, (r+1)*B_loc) of
    the global batch (r: its index over the data axes) and positions
    [i*S_loc, (i+1)*S_loc) of each (i: its index over sp). An expert's
    global queue is choice-major and, within a choice, in global flat
    token order (row, then position). One all-gather of the per-choice,
    per-row expert counts [k, B_loc, E] over the token axes gives the
    entries ahead of each of this rank's (choice, row) runs; ``pos``,
    ``keep``, ``me``, ``ce``, the aux loss and the drop rate are replaced
    by the global ones. Returns (route, aux, drop_rate)."""
    e = route["counts"].shape[0]
    order = route["order"]
    n = order.shape[0]
    t = n // k
    b_loc = t // s_loc
    dev = order.device
    jb = order // s_loc                          # (choice, row) run of entry
    cnt = torch.zeros((k * b_loc * e,), dtype=torch.int64, device=dev)
    cnt.index_add_(0, jb * e + route["expert"],
                   torch.ones_like(route["expert"]))
    cnt = cnt.view(k * b_loc, e)
    # entries ahead of each (choice, row) run in this rank's own list
    local_before = torch.cumsum(cnt, 0) - cnt
    n_data, n_sp = mesh.size(DATA_AXES), mesh.size("sp")
    g = C.gather_dim(cnt.view(1, k, b_loc, e), mesh.group(TOKEN_AXES),
                     n_data * n_sp, 0).view(n_data, n_sp, k, b_loc, e)
    r, i = mesh.index(DATA_AXES), mesh.index("sp")
    per_choice = g.sum((0, 1, 3))                              # [k, E]
    base = (torch.cumsum(per_choice, 0) - per_choice)[:, None]  # choices
    base = base + g[:r].sum((0, 1, 3))[:, None]                # rows of
    mine = g[r].sum(0)                                         # ranks < r
    base = base + torch.cumsum(mine, 1) - mine                 # rows < b
    base = base + g[r, :i].sum(0)                              # sp < i
    base = base.reshape(k * b_loc, e)
    row = jb * e + route["expert"]
    pos = (route["pos"] - local_before.view(-1)[row]
           + base.view(-1)[row])
    keep = pos < capacity
    me, ce, kept = _token_means(mesh, TOKEN_AXES, route["me"], route["ce"],
                                keep.float().mean())
    route = dict(route, pos=pos, keep=keep, me=me, ce=ce)
    return route, e * (me * ce).sum(), 1.0 - kept


def _compact_mlp(x_recv, route, e, ep, cap, gate_up, down, mesh):
    """The received slots [ep, E_loc, C, H] through the experts as one
    grouped SwiGLU over their occupied rows. Kept assignments fill slots
    0..kept-1 of each (sender, expert), so the occupied slots compact into
    per-expert segments (senders in order); the counts ride a second, tiny
    all_to_all (cnt_recv[s, el]: slots rank s filled for my expert el).
    Returns the outputs in slot layout [E_loc, ep, C, H], zero in the
    unoccupied slots."""
    el, h = e // ep, x_recv.shape[-1]
    dev = x_recv.device
    kept = route["keep"].to(torch.int32)
    cnt_send = torch.zeros((e,), dtype=torch.int32, device=dev).index_add_(
        0, route["expert"], kept).view(ep, el)
    cnt = C.all_to_all(cnt_send, axis_name="ep", split_axis=0,
                       concat_axis=0, mesh=mesh).T.long()      # [el, ep]
    rows = el * ep * cap
    sizes = cnt.sum(1)                                         # [el]
    seg_start = torch.cumsum(sizes, 0) - sizes
    ahead = torch.cumsum(cnt, 1) - cnt       # earlier senders' rows
    c_idx = torch.arange(cap, device=dev)
    valid = c_idx[None, None, :] < cnt[:, :, None]
    # slot (el, s, c) -> its compacted row (rows: the zero row past them)
    dest = torch.where(valid, (seg_start[:, None] + ahead)[:, :, None]
                       + c_idx, rows).reshape(-1)
    # compacted row -> its slot: the expert by the segment ends, the
    # sender by the senders' running counts within it
    i = torch.arange(rows, device=dev)
    ex = torch.clamp(torch.searchsorted(torch.cumsum(sizes, 0), i,
                                        right=True), max=el - 1)
    within = i - seg_start[ex]
    snd = torch.clamp(torch.searchsorted(
        torch.cumsum(cnt, 1).index_select(0, ex), within[:, None],
        right=True)[:, 0], max=ep - 1)
    src = (ex * ep + snd) * cap + within - ahead[ex, snd]
    src = torch.where(i < sizes.sum(), src, rows)
    flat = x_recv.transpose(0, 1).reshape(rows, h)             # (el, s, c)
    xc = torch.cat([flat, flat.new_zeros((1, h))]).index_select(0, src)
    yc = grouped_mlp_apply(xc, gate_up, down, sizes.to(torch.int32))
    # rows past sum(sizes) are unspecified: only occupied slots read yc
    y = torch.cat([yc, yc.new_zeros((1, h))]).index_select(0, dest)
    return y.view(el, ep, cap, h)
