"""Ring attention — counterpart of ``paddle_tpu/distributed/ring_attention.py``.

Sequence parallelism over the ``sp`` mesh axis: each rank holds q, k, v
of its sequence block ``[B, S/sp, H, D]`` and the KV blocks travel round
the ring (one :func:`~.collective.permute` a step, K and V stacked into
one exchange) while every rank attends its queries to the block it holds,
folding the blocks with the online softmax. No rank ever holds the
``S x S`` scores. The exchange is differentiable, so the backward is
itself a ring pass in the other direction (``lax.ppermute``'s transpose).

The block step (:func:`_block_attend`) is plain PyTorch, as the
reference's is XLA einsums with no Pallas kernel behind it. GQA runs as a
grouped einsum: repeated K/V is never materialised, so the ring moves
``1/rep`` of the bytes.

Where the reference masks a dead step (a future block under causal
attention) with ``jnp.where``, a rank here knows its index and skips the
step's arithmetic; the block it skipped still gets a zero cotangent
(:class:`_Tie`), so every rank runs every exchange of the reverse ring.

``make_ring_attention`` and ``make_zigzag_ring_attention`` bind the
options to a mesh, as the reference's ``shard_map`` wrappers do; the
returned function takes and returns this rank's pieces under the
reference's specs (each rank's tensors already are its shards).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.distributed import collective as C

_NEG_INF = -1e30


def _block_attend(q, k, v, scale, mask, bias=None):
    """(o, m, l) of one (q block, kv block) pair, scores in fp32.
    q: [B, Sq, H, D]; k, v: [B, Sk, Hkv, D]; ``mask``: bool broadcastable
    to [B, H, Sq, Sk] or None; ``bias``: additive float scores
    broadcastable to [B, H, Sq, Sk] (after scaling, before the mask).
    o [B, Sq, H, D] fp32 unnormalised, m and l [B, H, Sq]. A row with
    every key masked has l = 0. The block max is a constant of the
    backward: the normalised result does not depend on it."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    qf, kf = q.float(), k.float()
    if hq != hk:
        rep = hq // hk
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf.reshape(b, sq, hk, rep, d),
                         kf) * scale
        s = s.reshape(b, hq, sq, sk)      # head h = g*rep + r (q head order)
    else:
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m = s.detach().amax(-1)
    p = torch.exp(s - m[..., None])
    if mask is not None:
        # a fully-masked row has m = NEG_INF and exp(s - m) = 1: zero the
        # masked entries so dead rows contribute l = 0, not Sk
        p = torch.where(mask, p, 0.0)
    l = p.sum(-1)
    if hq != hk:
        pg = p.reshape(b, hk, rep, sq, sk).to(v.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", pg, v).reshape(b, sq, hq, d)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o.float(), m, l


def _fold(acc, o_b, m_b, l_b):
    """Online-softmax merge of a block into the [B, S, H, D] accumulator."""
    o, m, l = acc
    m_new = torch.maximum(m, m_b)
    c1, c2 = torch.exp(m - m_new), torch.exp(m_b - m_new)
    o = (o * c1.transpose(1, 2)[..., None]
         + o_b * c2.transpose(1, 2)[..., None])
    return o, m_new, l * c1 + l_b * c2


def _finish(acc):
    o, _, l = acc
    return o / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)


class _Tie(torch.autograd.Function):
    """``out`` unchanged; each of ``dead`` (ring blocks a rank skipped)
    gets a zero cotangent, so the exchanges that brought them are
    reversed on every rank alike."""

    @staticmethod
    def forward(ctx, out, *dead):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in dead]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev)
                     for s, dt, dev in ctx.shapes))


def _tie(out, dead):
    return _Tie.apply(out, *dead) if dead else out


def _zero_acc(b, s, h, d, dev):
    return (torch.zeros((b, s, h, d), dtype=torch.float32, device=dev),
            torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((b, h, s), dtype=torch.float32, device=dev))


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                   scale: float | None = None, window: int | None = None,
                   kv_lens=None, attn_mask=None, attn_bias=None, mesh=None):
    """Blockwise ring attention with online-softmax accumulation over the
    ``axis_name`` group of the active mesh (or ``mesh``); this rank's
    [B, S/sp, H, D] blocks in and out. Equals full attention over the
    gathered sequence.
    ``window``: causal sliding window over GLOBAL positions (query i sees
    [i-window+1, i] across block boundaries); steps no query can reach
    are pruned before the loop, alike on every rank.
    ``kv_lens``: [B] GLOBAL valid key lengths, masked per step against the
    arriving block's global key positions.
    ``attn_mask``: [B, S_loc, S_global] bool — this rank's query rows
    against every global key column; each step slices its block's columns.
    ``attn_bias``: [B|1, H|1, S_loc, S_global] float additive scores,
    sliced per step like the mask; finite (block positions with
    ``attn_mask``); differentiable."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    _, _, n, my = C._axis(axis_name, mesh)
    b, s_loc, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    acc = _zero_acc(b, s_loc, h, d, dev)
    tril = torch.tril(torch.ones((s_loc, s_loc), dtype=torch.bool,
                                 device=dev))
    ar = torch.arange(s_loc, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    # a window bounds how far back any query looks: ring step s covers
    # global distance >= s*s_loc - (s_loc-1) on every rank, so the steps
    # past ceil((window + s_loc - 1) / s_loc) are dead everywhere
    live_steps = n
    if causal and window is not None:
        live_steps = min(n, -(-(window + s_loc - 1) // s_loc))
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, device=dev)
    kv, dead = torch.stack([k, v]), []
    for step in range(live_steps):
        src = (my - step) % n        # the sequence block kv holds
        mask = None
        if causal:
            live = src <= my
            if window is not None:
                live = live and (my - src) * s_loc - (s_loc - 1) < window
            if not live:
                dead.append(kv)
            else:
                mask = tril if src == my else None
                if window is not None:
                    band = ((my - src) * s_loc + ar[:, None] - ar[None, :]
                            < window)
                    mask = band if mask is None else mask & band
                mask = None if mask is None else mask[None, None]
        else:
            live = True
        if live:
            cols = slice(src * s_loc, (src + 1) * s_loc)
            if kv_lens is not None:
                key_ok = ((src * s_loc + ar)[None, :]
                          < kv_lens[:, None])[:, None, None, :]
                mask = key_ok if mask is None else mask & key_ok
            if attn_mask is not None:
                blk = attn_mask[:, :, cols][:, None]
                mask = blk if mask is None else mask & blk
            bias = None if attn_bias is None else attn_bias[..., cols]
            acc = _fold(acc, *_block_attend(q, kv[0], kv[1], scale, mask,
                                            bias))
        if step != live_steps - 1:
            kv = C.permute(kv, perm, axis_name=axis_name, mesh=mesh)
    return _tie(_finish(acc), dead).to(q.dtype)


# -- online-softmax partial merges (context-parallel serving) --------------
#
# The paged kernels emit per-shard (acc, m, l) partials in the TRAILING-head
# layout — o [..., H, D] with m, l shaped o.shape[:-1] — and a serving
# engine combines them across the ``cp`` axis. Both merges are
# deterministic across members: every shard folds the same partials in the
# same global order (ring) or through symmetric reductions (psum), so the
# merged result is bit-identical on every member.

def merge_partials(o, m, l, o_b, m_b, l_b):
    """One pairwise online-softmax merge of two partial triples
    (trailing-head layout: m/l shaped ``o.shape[:-1]``)."""
    m_new = torch.maximum(m, m_b)
    c1, c2 = torch.exp(m - m_new), torch.exp(m_b - m_new)
    return o * c1[..., None] + o_b * c2[..., None], m_new, l * c1 + l_b * c2


def finalize_partials(o, l, dtype=None):
    """Normalise a merged accumulator; ``max(l, eps)`` keeps fully-masked
    rows at 0, not NaN."""
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out if dtype is None else out.to(dtype)


def ring_merge_partials(o, m, l, axis_name: str = "cp", mesh=None):
    """Ring merge: rotate the triples round the ring until every member
    holds all ``n`` shards' partials, then fold them in GLOBAL shard order
    0..n-1, so the fold's rounding is the same on every member."""
    _, _, n, my = C._axis(axis_name, mesh)
    if n == 1:
        return o, m, l
    perm = [(i, (i + 1) % n) for i in range(n)]
    # the exchange receives into buffers shaped (and strided) like these
    got = [(o.contiguous(), m.contiguous(), l.contiguous())]
    for _ in range(n - 1):
        got.append(tuple(C.permute(t, perm, axis_name=axis_name, mesh=mesh)
                         for t in got[-1]))
    # after s rotations the copy at position s came from member (my - s)
    # % n: shard g sits at position (my - g) % n
    parts = [got[(my - g) % n] for g in range(n)]
    acc = parts[0]
    for p in parts[1:]:
        acc = merge_partials(*acc, *p)
    return acc


def psum_merge_partials(o, m, l, axis_name: str = "cp", mesh=None):
    """Flat merge through symmetric reductions: one max for the global row
    max, one sum of the rescaled (acc, l) through one flat buffer. Both are
    member-order-invariant, so the result is bit-identical on every
    member."""
    if C._axis(axis_name, mesh)[2] == 1:
        return o, m, l
    m_max = C.all_reduce(m, C.ReduceOp.MAX, axis_name=axis_name, mesh=mesh)
    c = torch.exp(m - m_max)
    oc, lc = o * c[..., None], l * c
    flat = C.all_reduce(torch.cat([oc.reshape(-1), lc.reshape(-1)]),
                        axis_name=axis_name, mesh=mesh)
    return (flat[:oc.numel()].view_as(oc), m_max,
            flat[oc.numel():].view_as(lc))


def bias_spec(bias_shape, head_spec, batch_axes=("dp", "fsdp"),
              rows_axis="sp"):
    """The spec of a [B|1, H|1, Sq, Sk] additive bias: only the dims that
    are not broadcast are sharded (a size-1 batch/head dim stays
    replicated)."""
    b_ax = batch_axes if bias_shape[0] > 1 else None
    h_ax = head_spec if bias_shape[1] > 1 else None
    return (b_ax, h_ax, rows_axis, None)


def make_ring_attention(mesh, causal=True, head_spec=None, window=None,
                        varlen=False, masked=False, bias_shape=None,
                        scale=None):
    """Ring attention bound to ``mesh``: ``attend(q, k, v, *extra)`` on
    this rank's pieces of [B, S, H, D] tensors (batch over (dp, fsdp), S
    over sp, heads over ``head_spec``: "tp" composes with tensor
    parallelism, each tp rank ringing its own heads), returning its piece
    of the output. ``window``: a global causal sliding window (Mistral).
    ``varlen=True``: ``attend(q, k, v, kv_lens)`` with this rank's rows of
    [B] global key lengths. ``masked=True``: then a [B, S_loc, S] bool
    mask (this rank's query rows, every key column). ``bias_shape``: the
    global [B|1, H|1, S, S] shape of an additive float bias passed last,
    as this rank's piece under :func:`bias_spec` (query rows over sp,
    heads over ``head_spec`` when per-head)."""
    n_extra = int(varlen) + int(masked) + int(bias_shape is not None)

    def attend(q, k, v, *extra):
        if len(extra) != n_extra:
            raise TypeError(f"attend takes {n_extra} extra argument(s) "
                            f"(varlen={varlen}, masked={masked}, "
                            f"bias_shape={bias_shape}), got {len(extra)}")
        it = iter(extra)
        return ring_attention(
            q, k, v, axis_name="sp", causal=causal, scale=scale,
            window=window, kv_lens=next(it) if varlen else None,
            attn_mask=next(it) if masked else None,
            attn_bias=next(it) if bias_shape is not None else None,
            mesh=mesh)

    return attend


# -- zigzag (load-balanced causal) ring attention ----------------------------
#
# With contiguous blocks, causal masking gives rank r r+1 visible kv blocks
# and rank 0 one: the ring waits on the last rank. The zigzag layout (rank r
# holds chunks r and 2n-1-r of a 2n-chunk split) gives every rank one early
# and one late chunk, so the visible work is equal across ranks. Outputs stay
# in the zigzag layout (invert with zigzag_inverse_permutation).

def zigzag_permutation(seq_len: int, n_shards: int):
    """Index array mapping zigzag order to original positions: apply
    ``x[:, perm]`` BEFORE sharding on sp."""
    if seq_len % (2 * n_shards):
        raise ValueError("2*n_shards must divide seq_len")
    c = seq_len // (2 * n_shards)
    order = []
    for r in range(n_shards):
        order.extend(range(r * c, (r + 1) * c))                       # r
        order.extend(range((2 * n_shards - 1 - r) * c,
                           (2 * n_shards - r) * c))                   # 2n-1-r
    return np.asarray(order)


def zigzag_inverse_permutation(seq_len: int, n_shards: int):
    perm = zigzag_permutation(seq_len, n_shards)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len)
    return inv


def zigzag_ring_attention(q, k, v, *, axis_name: str = "sp",
                          scale: float | None = None, mesh=None):
    """Causal ring attention over zigzag-laid-out blocks (see
    :func:`zigzag_permutation`): [B, S/sp, H, D] a rank, its local
    sequence the chunks [my, 2n-1-my] (A and B). With the arriving kv
    chunks C = src and D = 2n-1-src a step computes two s2 x s2 blocks:
      * step 0 (src == my): A·C causal, B·C full, B·D causal
      * src < my: A·C full, B·C full           (B·D dead)
      * src > my: B·C full, B·D full           (A·C dead)
    the dead quadrants are never evaluated."""
    _, _, n, my = C._axis(axis_name, mesh)
    b, s_loc, h, d = q.shape
    if s_loc % 2:
        raise ValueError("zigzag needs an even local length")
    s2 = s_loc // 2
    scale = scale if scale is not None else d ** -0.5
    tril = torch.tril(torch.ones((s2, s2), dtype=torch.bool,
                                 device=q.device))
    qa, qb = q[:, :s2], q[:, s2:]
    acc_a = _zero_acc(b, s2, h, d, q.device)
    acc_b = _zero_acc(b, s2, h, d, q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = torch.stack([k, v])
    for step in range(n):
        kc, vc = kv[0][:, :s2], kv[1][:, :s2]
        kd, vd = kv[0][:, s2:], kv[1][:, s2:]
        if step == 0:
            acc_a = _fold(acc_a, *_block_attend(qa, kc, vc, scale, tril))
            acc_b = _fold(acc_b, *_block_attend(qb, kc, vc, scale, None))
            acc_b = _fold(acc_b, *_block_attend(qb, kd, vd, scale, tril))
        else:
            acc_b = _fold(acc_b, *_block_attend(qb, kc, vc, scale, None))
            if (my - step) % n < my:
                acc_a = _fold(acc_a, *_block_attend(qa, kc, vc, scale, None))
            else:
                acc_b = _fold(acc_b, *_block_attend(qb, kd, vd, scale, None))
        if step != n - 1:
            kv = C.permute(kv, perm, axis_name=axis_name, mesh=mesh)
    return torch.cat([_finish(acc_a), _finish(acc_b)], dim=1).to(q.dtype)


def make_zigzag_ring_attention(mesh):
    """Zigzag ring attention bound to ``mesh``: ``attend(q, k, v)`` on this
    rank's pieces (already in the zigzag layout, S over sp)."""

    def attend(q, k, v):
        return zigzag_ring_attention(q, k, v, axis_name="sp", mesh=mesh)

    return attend
