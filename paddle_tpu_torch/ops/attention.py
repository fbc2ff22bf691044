"""Attention ops — counterpart of ``paddle_tpu/ops/attention.py``.

Layout is the JAX package's ``[B, S, H, D]`` throughout. Dispatch:
:func:`scaled_dot_product_attention` hands every call the flash kernel
can take to the differentiable
``ops.cuda.flash_attention.flash_attention`` — K2 forward and K5
backward on a CUDA tensor, their plain versions on a CPU tensor — and
the calls the reference's kernel refuses (a dense ``attn_mask``,
dropout, windowed decode against a padded cache) to
:func:`eager_attention`, the port of the reference's ``xla_attention``,
which autograd differentiates as it stands. ALiBi goes to the flash
kernel too (K2 and K5 add the bias in the tile). Rotate-half rotary
embedding (:func:`apply_rope`, :func:`fused_rotary_position_embedding`)
goes through K7, ``ops.cuda.rope.fused_rope``; GPT-J's interleaved rotary
(:func:`apply_rope_interleaved`) is plain PyTorch, as the reference's is
plain ``jnp`` with no Pallas kernel behind it.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.ops.cuda import rope as _rope

# most-negative bf16-representable; avoids nan from -inf - -inf
_NEG_INF = -2.3819763e38


def eager_attention(query, key, value, attn_mask=None, is_causal=False,
                    scale=None, dropout_p=0.0, training=True, generator=None,
                    window=None, kv_lens=None, alibi_slopes=None):
    """Reference-semantics attention in plain PyTorch (``xla_attention``).
    [B,S,H,D]. ``window``: causal sliding window (token i sees
    [i-window+1, i]). ``kv_lens``: [B] valid key lengths. ``alibi_slopes``:
    [H] or [B, H] positive slopes m, adding ``-m * (q_pos - k_pos)``.
    Scores and softmax in fp32; the probabilities are cast to the value
    dtype before the second product, as in the reference."""
    if window is not None and not is_causal:
        raise ValueError("window requires is_causal=True")
    b, sq, h, d = query.shape
    sk = key.shape[1]
    dev = query.device
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, device=dev)
        pad = (torch.arange(sk, device=dev)[None, :] < kv_lens[:, None])
        pad = pad[:, None, None, :]
        if attn_mask is None:
            attn_mask = pad
        elif attn_mask.dtype == torch.bool:
            attn_mask = attn_mask & pad
        else:
            attn_mask = torch.where(pad, attn_mask,
                                    torch.tensor(_NEG_INF, device=dev))
    kv_heads = key.shape[2]
    if kv_heads != h:  # GQA: repeat KV heads
        rep = h // kv_heads
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    scale = scale if scale is not None else d ** -0.5
    q = query.transpose(1, 2)  # [B,H,S,D]
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    # query positions aligned to the END of the key axis; with kv_lens and
    # sq < sk, to each row's valid length
    if kv_lens is not None and sq < sk:
        q_pos = (kv_lens.to(torch.int64)[:, None] - sq
                 + torch.arange(sq, device=dev)[None, :])
    else:
        q_pos = (torch.arange(sq, device=dev) + (sk - sq))[None, :]
    k_pos = torch.arange(sk, device=dev)
    if alibi_slopes is not None:
        # fixed head geometry, not learned: no gradient reaches the
        # slopes, as the reference's stop_gradient (and K2's contract)
        m_sl = torch.as_tensor(alibi_slopes, device=dev,
                               dtype=torch.float32).detach().reshape(-1, h)
        dist = (q_pos[:, :, None] - k_pos[None, None, :]).float()
        if not is_causal:
            dist = dist.abs()
        scores = scores - m_sl[:, :, None, None] * dist[:, None]
    if is_causal or window is not None:
        diff = q_pos[:, :, None] - k_pos[None, None, :]
        keep = (diff >= 0) if is_causal else torch.ones_like(diff, dtype=torch.bool)
        if window is not None:
            keep = keep & (diff < window)
        scores = scores.masked_fill(~keep[:, None], _NEG_INF)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, _NEG_INF)
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        keep = torch.rand(probs.shape, generator=generator,
                          device=dev) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    probs = probs.to(v.dtype)
    out = torch.matmul(probs, v)
    return out.transpose(1, 2)  # back to [B,S,H,D]


def _flash_takes(query, key, attn_mask, dropout_p, is_causal, training,
                 window, kv_lens):
    """Whether the flash kernel takes this call, decided from the
    arguments alone (a launch that fails still raises). The calls the
    reference's own Pallas kernel refuses go to :func:`eager_attention`,
    its ``xla_attention``, on any device: a dense mask or dropout, GQA
    by partial groups, a window without ``is_causal``, and a window with
    ``kv_lens`` when Sq != Sk (windowed decode against a padded cache).
    ALiBi stays with the flash kernel, as in the reference: on a CPU
    tensor its plain version computes the bias the card's kernel does. On
    a CUDA tensor a head dim or dtype that ``kernel_route`` does not
    build raises."""
    from paddle_tpu_torch.ops.cuda import flash_attention as _flash
    if (attn_mask is not None or (dropout_p != 0.0 and training)
            or query.shape[2] % key.shape[2]
            or (window is not None and not is_causal)
            or (window is not None and kv_lens is not None
                and query.shape[1] != key.shape[1])):
        return False
    if query.is_cuda:
        _flash.kernel_route(query.dtype, query.shape[-1])
    return True


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                  dropout_p=0.0, is_causal=False,
                                  training=True, generator=None, scale=None,
                                  window=None, kv_lens=None,
                                  alibi_slopes=None):
    """Dispatch: the flash kernel (K2) for every call it takes — padding as
    ``kv_lens``, GQA by index, causal sliding window, ALiBi — and
    :func:`eager_attention` for the calls the reference gives
    ``xla_attention`` because its kernel refuses them (:func:`_flash_takes`):
    a dense ``attn_mask`` or dropout (a materialised [.., Sq, Sk] mask has
    already spent the memory flash saves) and windowed decode with
    ``kv_lens`` against a longer cache. On a CUDA tensor a head dim or
    dtype with no kernel raises."""
    if _flash_takes(query, key, attn_mask, dropout_p, is_causal, training,
                    window, kv_lens):
        from paddle_tpu_torch.ops.cuda import flash_attention as _flash
        return _flash.flash_attention(query, key, value, causal=is_causal,
                                      scale=scale, window=window,
                                      kv_lens=kv_lens,
                                      alibi_slopes=alibi_slopes)
    return eager_attention(query, key, value, attn_mask=attn_mask,
                           is_causal=is_causal, scale=scale,
                           dropout_p=dropout_p, training=training,
                           generator=generator, window=window,
                           kv_lens=kv_lens, alibi_slopes=alibi_slopes)


# -- rotary embedding -------------------------------------------------------

def resolve_rope_scaling(base, head_dim, scaling, seq_len=None,
                         max_position_embeddings=None, *,
                         allow_dynamic=True, cur_len=None):
    """The rope_scaling math (PaddleNLP/HF convention); returns ``(base,
    position_divisor)``:
      {"type": "linear",  "factor": f} — position interpolation (pos / f)
      {"type": "ntk",     "factor": f} — base *= f^(d/(d-2)) (fixed NTK)
      {"type": "dynamic", "factor": f} — NTK base grows once the length
        exceeds the trained window; with ``cur_len`` (scalar or [B]
        tensor) the returned base is a tensor, per row for [B]; a decode
        path that passes neither raises (``allow_dynamic=False``)."""
    if not scaling:
        return base, 1.0
    kind, factor = scaling["type"], float(scaling["factor"])
    if kind == "linear":
        return base, factor
    if kind == "ntk":
        return base * factor ** (head_dim / (head_dim - 2)), 1.0
    if kind == "dynamic":
        if cur_len is not None:
            trained = max_position_embeddings
            if not trained:
                raise ValueError(
                    "dynamic rope_scaling with a cur_len needs "
                    "max_position_embeddings (the trained window)")
            alpha = torch.clamp(
                factor * torch.as_tensor(cur_len, dtype=torch.float32)
                / trained - (factor - 1.0), min=1.0)
            return base * alpha ** (head_dim / (head_dim - 2)), 1.0
        if not allow_dynamic:
            raise NotImplementedError(
                "dynamic-NTK rope_scaling needs the current sequence "
                "length; pass cur_len or use 'linear'/'ntk'")
        trained = max_position_embeddings or seq_len
        if seq_len is not None and seq_len > trained:
            alpha = factor * seq_len / trained - (factor - 1)  # HF formula
            base = base * alpha ** (head_dim / (head_dim - 2))
        return base, 1.0
    raise ValueError(f"unknown rope_scaling type {kind!r}")


def rope_cos_sin(seq_len, head_dim, base=10000.0, dtype=torch.float32,
                 position_ids=None, scaling=None,
                 max_position_embeddings=None, allow_dynamic=True,
                 cur_len=None, device=None):
    """cos/sin [S, D/2] (or [B, S, D/2] for a per-row dynamic base) on
    ``device`` (None: the card, as every entry point of the port)."""
    device = resolve_device(device)
    base, pos_div = resolve_rope_scaling(
        base, head_dim, scaling, seq_len=seq_len,
        max_position_embeddings=max_position_embeddings,
        allow_dynamic=allow_dynamic, cur_len=cur_len)
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           if position_ids is None
           else torch.as_tensor(position_ids, device=device).float())
    if pos_div != 1.0:
        pos = pos / pos_div
    # a Python base fills a 0-d tensor on the device: a copy from host
    # memory would synchronise the stream every forward
    base = (base.to(device=device, dtype=torch.float32)
            if isinstance(base, torch.Tensor) else
            torch.full((), float(base), dtype=torch.float32, device=device))
    if base.ndim == 0:
        freqs = torch.outer(pos, 1.0 / (base ** ar))          # [S, D/2]
    else:
        inv_freq = 1.0 / (base[:, None] ** ar[None, :])
        freqs = pos[None, :, None] * inv_freq[:, None, :]
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin):
    """x: [B,S,H,D]; cos/sin: [S, D/2] (shared) or [B, S, D/2] (per row).
    NeoX-style rotate-half (LLaMA), through K7 (``ops.cuda.rope``): the
    kernel on a CUDA tensor, its plain version on a CPU tensor. The result
    is contiguous."""
    b, s = x.shape[:2]
    want = (s,) if cos.ndim == 2 else (b, s)
    if tuple(cos.shape[:-1]) != want:
        raise ValueError(f"apply_rope: tables {tuple(cos.shape)} for x "
                         f"{tuple(x.shape)}")
    return _rope.fused_rope(x, cos, sin)


def apply_rope_interleaved(x, cos, sin):
    """GPT-J-style interleaved rotary: the pairs are the (even, odd) lanes
    ``(x[2i], x[2i+1])``, not the two halves. x: [B,S,H,D(rot)]; cos/sin:
    [S, D/2]. Plain PyTorch (the reference's is plain ``jnp``; K7 rotates
    halves): the products in the tables' dtype (fp32 tables promote a bf16
    x), one cast back to x's dtype."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[None, :, None, :]
    sin = sin[None, :, None, :]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def fused_rotary_position_embedding(q, k, seq_len=None, base=10000.0,
                                    position_ids=None):
    """Rotate-half rope of q and k [B, S, H, D] with fp32 tables built for
    ``seq_len`` (default S) positions, or for ``position_ids`` [S] — the
    counterpart of ``paddle.incubate.nn.functional.
    fused_rotary_position_embedding``, through K7 on the card."""
    s = seq_len or q.shape[1]
    cos, sin = rope_cos_sin(s, q.shape[-1], base=base, dtype=torch.float32,
                            position_ids=position_ids, device=q.device)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)
