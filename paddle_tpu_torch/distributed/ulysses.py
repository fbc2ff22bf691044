"""DeepSpeed-Ulysses sequence parallelism — counterpart of
``paddle_tpu/distributed/ulysses.py``.

The complement of ring attention (:mod:`.ring_attention`): one
``all_to_all`` re-shards q, k, v from sequence-sharded to head-sharded,
ordinary full attention runs on a head slice, and a second ``all_to_all``
restores sequence sharding. The inner attention is the port's
``ops.attention.scaled_dot_product_attention``: K2 forward and K5a/K5b
backward on the card wherever the flash kernel takes the call, as the
reference's reaches its Pallas flash kernel. Both exchanges are
differentiable (the backward runs the inverse all_to_all).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.ops import attention as A


def ulysses_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                      scale=None, window=None, kv_lens=None, attn_mask=None,
                      attn_bias=None, mesh=None):
    """Attention over the full sequence with this rank's [B, S_loc, H, D]
    sequence block in and out (the ``axis_name`` group of the active mesh,
    or ``mesh``). H must divide by the axis size.

    ``kv_lens``: [B] global valid key lengths, applied by the inner
    attention after the exchange (the flash kernel's varlen path).
    ``attn_mask``: [B, S, S] bool over GLOBAL positions, whole on every
    member (after the exchange a member holds the whole sequence of its
    head slice). ``attn_bias``: [B|1, H_slice|1, S, S] float additive
    scores of THIS member's post-exchange head slice
    (:func:`make_ulysses_attention` documents which slice)."""
    sp = C._axis(axis_name, mesh)[2]
    if q.shape[2] % sp != 0:
        raise ValueError(
            f"ulysses_attention: num_heads={q.shape[2]} must be divisible by "
            f"axis '{axis_name}' size {sp}")
    if k.shape[2] % sp != 0:
        # GQA with fewer KV heads than sp: replicate KV groups up to sp so
        # the head scatter has something to split (Ulysses-GQA). The
        # exchange then moves rep = sp / kv_heads times the KV bytes;
        # sequence_parallel="ring" rotates un-replicated KV instead.
        if sp % k.shape[2] == 0:
            rep = sp // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        else:
            raise ValueError(
                f"ulysses_attention: num_key_value_heads={k.shape[2]} must "
                f"divide by (or into) axis '{axis_name}' size {sp}; use "
                "sequence_parallel='ring' for this head configuration")

    def scatter_heads(x):       # seq-sharded -> head-sharded
        return C.all_to_all(x, axis_name=axis_name, split_axis=2,
                            concat_axis=1, mesh=mesh)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    mask = attn_mask[:, None] if attn_mask is not None else None  # [B,1,S,S]
    if attn_bias is not None:
        # one mask for the attention core: blocked positions fold into the
        # additive bias
        bias = attn_bias.float()
        mask = bias if mask is None else torch.where(mask, bias, -1e30)
    # a window needs nothing more: after the exchange the inner attention
    # sees the whole sequence, global positions intact
    out = A.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         is_causal=causal, scale=scale,
                                         window=window, kv_lens=kv_lens)
    return C.all_to_all(out, axis_name=axis_name, split_axis=1,
                        concat_axis=2, mesh=mesh)   # head -> seq sharded


def ulysses_merge_partials(o, m, l, axis_name: str = "cp", mesh=None):
    """Ulysses-style merge of per-shard online-softmax partials (trailing
    head layout: ``o`` [..., H, D], ``m``/``l`` shaped ``o.shape[:-1]``).
    One all_to_all re-shards them from partial-per-member to head-sharded
    (member j receives head slice j of ALL n partials, in shard order),
    each member folds its slice 0..n-1, and an all_gather restores the
    head dim: every member ends with the same bits. Requires H % n == 0."""
    from paddle_tpu_torch.distributed.ring_attention import merge_partials
    _, group, n, _ = C._axis(axis_name, mesh)
    if n == 1:
        return o, m, l
    ho, hm = o.dim() - 2, m.dim() - 1
    if o.shape[ho] % n != 0:
        raise ValueError(
            f"ulysses_merge_partials: heads={o.shape[ho]} must divide by "
            f"axis '{axis_name}' size {n}; use PT_CP_IMPL=ring")

    def split(x, ax):
        y = C.all_to_all(x.unsqueeze(0), axis_name=axis_name,
                         split_axis=ax + 1, concat_axis=0, mesh=mesh)
        return y.unbind(0)

    o_s, m_s, l_s = split(o, ho), split(m, hm), split(l, hm)
    acc = (o_s[0], m_s[0], l_s[0])
    for g in range(1, n):
        acc = merge_partials(*acc, o_s[g], m_s[g], l_s[g])
    return tuple(C.gather_dim(t, group, n, ax)
                 for t, ax in zip(acc, (ho, hm, hm)))


def make_ulysses_attention(mesh, causal: bool = True, axis_name: str = "sp",
                           head_spec=None, batch_axes=("dp", "fsdp"),
                           window: int | None = None, varlen: bool = False,
                           masked: bool = False, bias_shape=None,
                           scale=None):
    """Ulysses attention bound to ``mesh``: ``attend(q, k, v, *extra)`` on
    this rank's pieces of [B, S, H, D] tensors (S over ``axis_name``, batch
    over ``batch_axes``, heads over ``head_spec``: "tp" composes with
    tensor parallelism, each tp rank re-sharding its own heads, so local
    heads must divide by sp), returning its piece of the output.
    ``varlen=True``: then this rank's rows of [B] key lengths.
    ``masked=True``: then its rows of a [B, S, S] bool mask, whole along
    both sequence dims. ``bias_shape``: the global [B|1, H|1, S, S] shape
    of an additive bias passed last: a per-head bias as this rank's head
    slice over (tp, sp), tp-major and sp-minor — exactly the heads rank
    (tp_j, sp_i) computes after the exchange."""
    n_extra = int(varlen) + int(masked) + int(bias_shape is not None)

    def attend(q, k, v, *extra):
        if len(extra) != n_extra:
            raise TypeError(f"attend takes {n_extra} extra argument(s) "
                            f"(varlen={varlen}, masked={masked}, "
                            f"bias_shape={bias_shape}), got {len(extra)}")
        it = iter(extra)
        return ulysses_attention(
            q, k, v, axis_name=axis_name, causal=causal, scale=scale,
            window=window, kv_lens=next(it) if varlen else None,
            attn_mask=next(it) if masked else None,
            attn_bias=next(it) if bias_shape is not None else None,
            mesh=mesh)

    return attend
