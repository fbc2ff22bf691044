"""One-call sequence-parallel attention dispatch shared by the models —
counterpart of ``paddle_tpu/distributed/sp.py``.

The Llama-family attention routes its sp path through here, so the ring /
Ulysses choice and the way a mask or bias is cut for each live in one
place (the models keep only their own mask normalisation).
"""
from __future__ import annotations


def sp_attention(mesh, mode: str, q, k, v, *, causal=True, scale=None,
                 window=None, head_spec=None, attn_mask=None,
                 attn_bias=None):
    """Attention over the sequence with this rank's [B, S_loc, H_loc, D]
    pieces of q, k, v (S over sp, heads over ``head_spec``) via ``mode``
    ("ring" | "ulysses"); returns this rank's piece of the output.
    ``attn_mask``: [B, S, S] bool over global positions; ``attn_bias``:
    [B|1, H|1, S, S] float additive scores over every head — both for this
    rank's batch rows and whole along the sequence and head dims: each
    rank cuts the piece its mode reads (the ring its query rows and tp
    heads, Ulysses its post-exchange heads)."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence_parallel mode {mode!r}")
    bias = None
    if attn_bias is not None:
        bias = attn_bias.float()
        heads = (head_spec, "sp") if mode == "ulysses" else head_spec
        if bias.shape[1] > 1:
            n = mesh.size(heads)
            bias = bias.chunk(n, 1)[mesh.index(heads)] if n > 1 else bias
    mask = attn_mask
    if mode == "ring":
        from paddle_tpu_torch.distributed.ring_attention import (
            make_ring_attention as make)
        rows = (None, None, "sp", None)
        if mask is not None:
            mask = mesh.local(mask, rows[1:])
        if bias is not None:
            bias = mesh.local(bias, rows)
    else:
        from paddle_tpu_torch.distributed.ulysses import (
            make_ulysses_attention as make)
    attend = make(mesh, causal=causal, scale=scale, window=window,
                  head_spec=head_spec, masked=mask is not None,
                  bias_shape=None if attn_bias is None else
                  tuple(attn_bias.shape))
    extra = tuple(t for t in (mask, bias) if t is not None)
    return attend(q, k, v, *extra)
