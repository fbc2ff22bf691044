"""Pipeline parallelism — counterpart of
``paddle_tpu/distributed/pipeline.py`` (ref: Paddle's
``fleet/meta_parallel/pipeline_parallel.py``, PipelineLayer + 1F1B).

The reference runs one SPMD ``lax.scan`` over global ticks with a
``ppermute`` ring. The port is what upstream Paddle runs: a per-rank
schedule over the same ticks, exchanging activations forward and
cotangents backward with point-to-point send/recv. At tick ``t`` stage
``s`` runs the forward of microbatch ``t - s`` and the backward of
microbatch ``t - (2(pp-1) - s)``, as the reference's schedule does; each
tick's sends and receives go out together (``batch_isend_irecv``), so no
two ranks wait on each other in different orders.

* **Memory.** The forward runs without a graph and keeps only its stage
  input; the backward recomputes the stage from it (recompute-style 1F1B)
  and differentiates with ``torch.autograd.grad``. A stage holds at most
  ``2(pp-1-s) + 1 <= 2pp - 1`` saved inputs whatever the number of
  microbatches (``stats=`` receives the peak of a run), and no activation
  stash of M microbatches.
* **Gradients** accumulate in fp32 in microbatch order and are scaled by
  1/M at the end; the embedding's and the head's are summed over pp (only
  the first / last stage holds them) and every gradient is averaged over
  ``batch_axes``. The send/recv pair carries the cotangent as the
  reference's reverse ring does: the backward is written out, not traced.
* **zb1** (zero bubble, ZB-H1): stage ``s`` computes only dx for its last
  ``pp-1-s`` microbatches on the drain hops and defers their weight
  gradients (``autograd.grad`` with ``inputs=`` the parameters alone) to
  ``pp-1`` tail ticks, from a queue of ``(x, g)`` pairs. The forward is
  untouched and the deferred terms are added in the same microbatch order,
  so the loss and the gradients equal 1F1B's bit for bit.

``pipeline_apply`` (the GPipe forward) and ``PipelineLayer.__call__`` are
forward-only here (no gradient crosses a rank); training goes through
:func:`pipeline_train_1f1b` / :func:`pipeline_train_step`.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.mesh import current_mesh

def stack_layers(layers) -> dict:
    """{parameter name: [N, ...]} of N structurally identical layers."""
    names = [n for n, _ in layers[0].named_parameters()]
    return {n: torch.stack([lyr.get_parameter(n).detach() for lyr in layers])
            for n in names}


def unstack_layers(stacked: dict, n: int) -> list:
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


class LayerView:
    """One layer of a stacked set: calling it runs ``template`` with this
    layer's parameter slices (``torch.func.functional_call``)."""

    def __init__(self, template, params: dict):
        self.template, self.params = template, params

    def __call__(self, *args, **kw):
        return functional_call(self.template, self.params, args, kw)


def _stage_runner(template, layer_call, remat):
    """stage_fwd(params {name: [lps, ...]}, h) applying each layer. One
    unbind a stacked parameter: its backward stacks the layers' gradients
    once, where indexing each layer's slice would add every slice's
    gradient into a zero-filled [lps, ...] tensor of its own."""
    def stage_fwd(params, h):
        def run(h):
            slices = {k: v.unbind(0) for k, v in params.items()}
            for i in range(len(next(iter(slices.values())))):
                h = layer_call(LayerView(
                    template, {k: v[i] for k, v in slices.items()}), h)
            return h
        if remat and torch.is_grad_enabled():
            return checkpoint(run, h, use_reentrant=False)
        return run(h)
    return stage_fwd


def _grad_leaves(tree):
    flat, spec = pytree.tree_flatten(tree)
    return [t.detach().requires_grad_(True) for t in flat], spec


def _grad(out, inputs, g):
    """d(out . g) / d inputs, zeros where an input is unused."""
    got = torch.autograd.grad(out, inputs, g, allow_unused=True)
    return [torch.zeros_like(i) if d is None else d
            for i, d in zip(inputs, got)]


def _acc(acc, upd):
    """fp32 accumulators += gradients (promoted inside the add: no cast
    copy)."""
    for a, u in zip(acc, upd):
        a.add_(u)


def _p2p(ops):
    for w in (dist.batch_isend_irecv(ops) if ops else []):
        w.wait()


def pipeline_apply(stage_params, layer_fn: Callable, x_microbatches, *,
                   mesh=None, axis_name: str = "pp", template=None,
                   remat: bool = False):
    """Forward-only fill-drain (GPipe) wavefront over the pp stages.

    stage_params: this stage's layers {name: [layers_per_stage, ...]}
    (``template`` the layer module they run through) or a callable
    ``stage(x) -> x``. x_microbatches: [M, mb, ...], read at stage 0.
    Returns [M, mb, ...]: the last stage's outputs on the last stage,
    zeros on the others."""
    mesh = mesh if mesh is not None else current_mesh()
    pp = 1 if mesh is None else mesh.size(axis_name)
    s = 0 if pp == 1 else mesh.index(axis_name)
    if callable(stage_params):
        stage = stage_params
    else:
        run = _stage_runner(template, layer_fn, remat)
        stage = lambda h: run(stage_params, h)  # noqa: E731
    m_total = x_microbatches.shape[0]
    out = None
    ring = None
    with torch.no_grad():
        for t in range(m_total + pp - 1):
            m = t - s
            y = None
            if 0 <= m < m_total:
                x_in = x_microbatches[m] if s == 0 else ring
                y = stage(x_in)
                if out is None:
                    out = torch.zeros((m_total,) + tuple(y.shape),
                                      dtype=y.dtype, device=y.device)
                if s == pp - 1:
                    out[m] = y
            ops = []
            if y is not None and s < pp - 1:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      mesh.peer(axis_name, s + 1)))
            if s > 0 and 0 <= t + 1 - s < m_total:
                ring = torch.empty_like(x_microbatches[0] if ring is None
                                        else ring)
                ops.append(dist.P2POp(dist.irecv, ring,
                                      mesh.peer(axis_name, s - 1)))
            _p2p(ops)
    return out


def pipeline_train_1f1b(stage_params, stage_fwd: Callable, x_mb, y_mb, *,
                        mesh=None, axis_name: str = "pp", batch_axes=(),
                        embed_params=None, embed_fn: Callable = None,
                        head_params=None, head_loss_fn: Callable = None,
                        zero_bubble: bool = False, stats: dict = None):
    """One 1F1B (or, with ``zero_bubble``, ZB-H1) training step of this
    rank's stage.

    stage_params: this stage's parameters, a pytree of tensors (e.g.
      {name: [layers_per_stage, ...]}); stage_fwd(stage_params, x) -> y.
    x_mb: [M, mb, ...] stage-0 input (token ids when ``embed_fn`` is
      given); y_mb: [M, mb, ...] labels, read at the last stage.
    embed_fn(embed_params, tokens) -> activations at stage 0;
    head_loss_fn(head_params, y, labels) -> scalar mean loss at the last
      stage (without one the loss is mean(y)).

    Returns (loss, dstage, dembed, dhead): the mean loss over the
    microbatches (the same on every stage), fp32 gradients of this stage's
    parameters (the structure of ``stage_params``) and of the embedding
    and head parameters (``()`` where not given), as the reference.
    ``stats``, a dict, receives the run's ticks and this rank's peak
    counts of saved stage inputs and of deferred (x, g) pairs (zb1).
    """
    mesh = mesh if mesh is not None else current_mesh()
    pp = 1 if mesh is None else mesh.size(axis_name)
    s = 0 if pp == 1 else mesh.index(axis_name)
    nxt = None if s == pp - 1 else mesh.peer(axis_name, s + 1)
    prv = None if s == 0 else mesh.peer(axis_name, s - 1)
    M = x_mb.shape[0]
    T = M + 2 * (pp - 1) + ((pp - 1) if zero_bubble else 0)
    is_first, is_last = s == 0, s == pp - 1
    has_embed, has_head = embed_fn is not None, head_loss_fn is not None
    if not has_head:
        head_params = ()
        head_loss_fn = lambda hp, y, lbl: y.float().mean()  # noqa: E731
    if not has_embed:
        embed_params = ()
        embed_fn = lambda ep, x: x  # noqa: E731

    sp, sp_spec = _grad_leaves(stage_params)
    ep, ep_spec = _grad_leaves(embed_params)
    hp, hp_spec = _grad_leaves(head_params)
    stage_of = lambda leaves: pytree.tree_unflatten(leaves, sp_spec)  # noqa
    embed_of = lambda leaves: pytree.tree_unflatten(leaves, ep_spec)  # noqa
    head_of = lambda leaves: pytree.tree_unflatten(leaves, hp_spec)  # noqa
    with torch.no_grad():
        a0 = embed_fn(embed_of(ep), x_mb[0])
    act_shape, act_dtype, dev = tuple(a0.shape), a0.dtype, a0.device

    dstage = [torch.zeros_like(p, dtype=torch.float32) for p in sp]
    dembed = [torch.zeros_like(p, dtype=torch.float32) for p in ep]
    dhead = [torch.zeros_like(p, dtype=torch.float32) for p in hp]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    resid, wq = {}, {}
    stats = {} if stats is None else stats
    stats.update(peak_saved_inputs=0, peak_deferred=0, ticks=T)
    fwd_in = bwd_in = dy = None
    d_s = (pp - 1) - s

    def stage_grads(x_in, g, want_x, want_p):
        with torch.enable_grad():
            x = x_in.detach().requires_grad_(want_x)
            y = stage_fwd(stage_of(sp), x)
            inputs = ([x] if want_x else []) + (sp if want_p else [])
            got = _grad(y, inputs, g.to(y.dtype))
        return (got[0] if want_x else None), (got[1:] if want_x else got)

    for t in range(T):
        ops = []
        # -------- forward slot: microbatch t - s ------------------------
        m_f = t - s
        if 0 <= m_f < M:
            with torch.no_grad():
                x_in = (embed_fn(embed_of(ep), x_mb[m_f]).to(act_dtype)
                        if is_first else fwd_in)
                y = stage_fwd(stage_of(sp), x_in).to(act_dtype)
            resid[m_f] = x_in
            stats["peak_saved_inputs"] = max(stats["peak_saved_inputs"],
                                             len(resid))
            if is_last:
                with torch.enable_grad():
                    yy = y.detach().requires_grad_(True)
                    loss_m = head_loss_fn(head_of(hp), yy, y_mb[m_f])
                    got = _grad(loss_m, [yy] + hp, None)
                loss += loss_m.detach().float()
                dy = got[0].to(act_dtype)
                _acc(dhead, got[1:])
            else:
                ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt))
        # -------- backward slot: microbatch t - (2(pp-1) - s) -----------
        m_b = t - (2 * (pp - 1) - s)
        if 0 <= m_b < M:
            x_saved = resid.pop(m_b)
            g = dy if is_last else bwd_in
            want_x = not is_first or has_embed
            if zero_bubble and m_b >= M - d_s:
                dx, _ = stage_grads(x_saved, g, True, False)
                wq[m_b] = (x_saved, g)
                stats["peak_deferred"] = max(stats["peak_deferred"], len(wq))
            else:
                dx, dp = stage_grads(x_saved, g, want_x, True)
                _acc(dstage, dp)
            if is_first and has_embed:
                with torch.enable_grad():
                    e = embed_fn(embed_of(ep), x_mb[m_b]).to(act_dtype)
                    _acc(dembed, _grad(e, ep, dx.to(act_dtype)))
            if not is_first:
                ops.append(dist.P2POp(dist.isend,
                                      dx.to(act_dtype).contiguous(), prv))
        # -------- deferred weight gradients (zb1 tail) -------------------
        m_w = m_b - d_s
        if zero_bubble and max(M - d_s, 0) <= m_w < M:
            x_w, g_w = wq.pop(m_w)
            _acc(dstage, stage_grads(x_w, g_w, False, True)[1])
        # -------- the tick's exchanges ------------------------------------
        if not is_first and 0 <= t + 1 - s < M:
            fwd_in = torch.empty(act_shape, dtype=act_dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, fwd_in, prv))
        if not is_last and 0 <= t + 1 - (2 * (pp - 1) - s) < M:
            bwd_in = torch.empty(act_shape, dtype=act_dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, bwd_in, nxt))
        _p2p(ops)

    inv_m = 1.0 / M
    group = None if pp == 1 else mesh.group(axis_name)
    # the loss lives on the last stage, the embedding's grads on the first
    # and the head's on the last: sum each over pp
    C.all_reduce_([loss] + dembed + dhead, group, inv_m)
    torch._foreach_mul_(dstage, inv_m)
    batch_axes = tuple(batch_axes)
    if batch_axes and mesh.size(batch_axes) > 1:
        nb = mesh.size(batch_axes)
        C.all_reduce_([loss] + dstage + dembed + dhead,
                      mesh.group(batch_axes), 1.0 / nb)
    return (loss, stage_of(dstage), embed_of(dembed) if ep else (),
            head_of(dhead) if hp else ())


def _stage_slice(pipe, mesh):
    """This rank's stage of a PipelineLayer's global stacked layers."""
    if pipe.stage_local:
        return pipe.stacked
    s = 0 if mesh is None or mesh.size("pp") == 1 else mesh.index("pp")
    lps = pipe.layers_per_stage
    return {k: v[s * lps:(s + 1) * lps] for k, v in pipe.stacked.items()}


def pipeline_train_step(pipe: "PipelineLayer", mesh, x, y, *,
                        layer_call: Callable = None,
                        head_loss_fn: Callable = None, head_params=None,
                        embed_fn: Callable = None, embed_params=None,
                        batch_axes=(), stage_specs=None,
                        schedule: str = "1f1b", stats: dict = None):
    """1F1B loss and gradients of a PipelineLayer under ``mesh`` (pp axis);
    ``schedule``: "1f1b" or "zb1"; ``stats`` as pipeline_train_1f1b's.

    Splits the global batch into ``pipe.num_microbatches``; with
    ``batch_axes`` (e.g. ("dp",)) each microbatch's rows are split over
    those axes and every member pipelines its share. ``stage_specs``
    ({name: spec} over the stacked [L, ...] tensors, e.g.
    ``models.llama.llama_tp_stage_specs``) slices the stacked layers over
    their other axes too (tp). Returns ``(loss, dstage, dembed, dhead)``:
    dstage this rank's stage's fp32 gradients {name: [lps, ...]}, dembed /
    dhead None where not given."""
    if schedule not in ("1f1b", "zb1"):
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         "(expected '1f1b' or 'zb1')")
    layer_call = layer_call or (lambda lyr, h: lyr(h))
    mb_n = pipe.num_microbatches
    b = x.shape[0]
    if b % mb_n:
        raise ValueError(f"num_microbatches ({mb_n}) must divide the batch "
                         f"size ({b})")
    xm = x.reshape((mb_n, b // mb_n) + tuple(x.shape[1:]))
    ym = y.reshape((mb_n, b // mb_n) + tuple(y.shape[1:]))
    batch_axes = tuple(batch_axes)
    if batch_axes:
        xm = mesh.local(xm, (None, batch_axes))
        ym = mesh.local(ym, (None, batch_axes))
    params = _stage_slice(pipe, mesh)
    if stage_specs is not None:
        params = {k: mesh.local(v, (None,) + tuple(stage_specs[k][1:]))
                  for k, v in params.items()}
    stage_fwd = _stage_runner(pipe.template, layer_call, pipe.remat)
    loss, dstage, dembed, dhead = pipeline_train_1f1b(
        params, stage_fwd, xm, ym, mesh=mesh, batch_axes=batch_axes,
        embed_params=embed_params, embed_fn=embed_fn,
        head_params=head_params, head_loss_fn=head_loss_fn,
        zero_bubble=(schedule == "zb1"), stats=stats)
    return (loss, dstage, dembed if embed_fn is not None else None,
            dhead if head_loss_fn is not None else None)


class PipelineLayer:
    """Identical blocks partitioned over pp stages.

    ``stacked``: {name: [L, ...]}, the layers' parameters stacked
    (moved to ``device``: the card when none is named, ``"cpu"`` for the
    tests); ``template``: the first layer, which every slice runs through.
    Without a mesh (or at pp = 1) ``__call__`` runs the layers in order;
    over a pp mesh it runs :func:`pipeline_apply` and hands the last
    stage's output to every stage."""

    def __init__(self, layers, num_stages: int, num_microbatches: int = 1,
                 remat: bool = True, device=None):
        if len(layers) % num_stages:
            raise ValueError(f"num_stages ({num_stages}) must divide "
                             f"len(layers) ({len(layers)})")
        dev = resolve_device(device)
        self.stacked = {k: v.to(dev) for k, v in stack_layers(layers).items()}
        self.template = layers[0]
        self._init(len(layers), num_stages, num_microbatches, remat, False)

    def _init(self, n_layers, num_stages, num_microbatches, remat, local):
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.layers_per_stage = n_layers // num_stages
        self.n_layers = n_layers
        self.remat = remat
        self.stage_local = local

    @classmethod
    def from_stacked(cls, stacked: dict, *, n_layers: int, num_stages: int,
                     num_microbatches: int = 1, remat: bool = True,
                     template=None, stage_local: bool = False):
        """From an already stacked {name: [L, ...]} set, or with
        ``stage_local`` from this rank's stage alone ([L / pp, ...])."""
        if n_layers % num_stages:
            raise ValueError(f"num_stages ({num_stages}) must divide "
                             f"n_layers ({n_layers})")
        self = cls.__new__(cls)
        self.stacked, self.template = stacked, template
        self._init(n_layers, num_stages, num_microbatches, remat,
                   stage_local)
        return self

    def stage_specs(self) -> dict:
        """The leading (layer) axis on pp."""
        return {k: ("pp",) + (None,) * (v.dim() - 1)
                for k, v in self.stacked.items()}

    def __call__(self, x, layer_call: Callable = None, mesh=None):
        layer_call = layer_call or (lambda lyr, h: lyr(h))
        if mesh is None or mesh.size("pp") == 1:
            return _stage_runner(self.template, layer_call, False)(
                self.stacked, x)
        mb = self.num_microbatches
        b = x.shape[0]
        if b % mb:
            raise ValueError("the batch must divide into microbatches")
        xm = x.reshape((mb, b // mb) + tuple(x.shape[1:]))
        out = pipeline_apply(_stage_slice(self, mesh), layer_call, xm,
                             mesh=mesh, template=self.template)
        out = C.broadcast(out, mesh.size("pp") - 1, axis_name="pp",
                          mesh=mesh)
        return out.reshape((b,) + tuple(out.shape[2:]))
