"""Speculative decoding with a draft model — the part of
``paddle_tpu/models/speculative.py`` the serving engine needs: the draft
model's per-row chunk forward over its dense cache (:func:`_forward_rows`).

The engine (``serving/engine.py``) drafts up to ``spec_k`` tokens a slot
through this forward, verifies them in ONE target chunk forward through
the paged pool (``models/paged.py`` ``llama_verify_chunk_paged``, K3 on
the card), and rolls rejected positions back by lengths alone
(``spec_rewind_lens``). The accept rules are ``models/paged.py``'s
``greedy_accept_length`` and ``stochastic_accept_row``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.models.decoding import KVCache
from paddle_tpu_torch.models.paged import (_apply_rope_rows, _backbone,
                                           _mlp_out, _model_logits, _qkv,
                                           model_config)
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.quantization import wo_matmul as _wo


@torch.no_grad()
def _forward_rows(model, input_ids, cache: KVCache, row_pos, chunk_lens=None):
    """Chunk forward with PER-ROW positions: row b's tokens occupy cache
    positions ``row_pos[b] .. row_pos[b]+C-1`` (rope, cache writes and
    causal visibility all per row). After the first speculative round
    every row sits at a different position (different acceptance
    counts), so this is what makes the draft batchable. Stale cache
    entries beyond a row's frontier are never visible (key j attends iff
    j <= row_pos[b]+i) and are overwritten by the row's next chunk.

    ``chunk_lens`` ([B]): per-row WRITE mask — row b commits only its
    first chunk_lens[b] positions to the cache (a row at 0 writes nothing
    at all): slots propose different k, so padding columns and whole
    padding rows must not clobber cache entries. Masked writes go to the
    cache's sink position, the counterpart of the reference's
    out-of-bounds dropped scatter (NOT a clamp, which would corrupt
    position cap-1). The cache is written in place; returns the logits
    [B, C, V].

    Attention here is plain PyTorch (``ops.attention.eager_attention``)
    over the dense cache: the reference computes it with
    ``xla_attention``, outside any Pallas kernel. The norms run K1 and
    the ropes K7 on the card. Dynamic-NTK rope (the reference's
    ``chunk_end_len``) is not ported: the engine refuses speculation
    with it."""
    cfg = model_config(model)
    if cfg.sliding_window:
        raise NotImplementedError("speculative rows-forward: no window")
    if (cfg.rope_scaling or {}).get("type") == "dynamic":
        raise NotImplementedError(
            "speculative rows-forward with dynamic-NTK rope is not ported")
    dev = cache.k[0].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, c = input_ids.shape
    row_pos = torch.as_tensor(row_pos, device=dev).long()
    x = _backbone(model).embed_tokens[input_ids]
    d = cfg.hidden_size // cfg.num_attention_heads
    positions = row_pos[:, None] + torch.arange(c, device=dev)   # [B, C]
    base, pos_div = A.resolve_rope_scaling(
        cfg.rope_theta, d, cfg.rope_scaling, allow_dynamic=False,
        max_position_embeddings=cfg.max_position_embeddings)
    inv = 1.0 / (torch.as_tensor(base, dtype=torch.float32, device=dev)
                 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                  device=dev) / d))
    f = (positions.float() / pos_div)[:, :, None] * inv
    cos, sin = torch.cos(f), torch.sin(f)                     # [B, C, D/2]
    cap = cache.capacity
    vis = (torch.arange(cap, device=dev)[None, None, :]
           <= positions[:, :, None])[:, None]                 # [B,1,C,L]
    wpos = positions
    if chunk_lens is not None:
        cl = torch.as_tensor(chunk_lens, device=dev).long()
        wpos = torch.where(torch.arange(c, device=dev)[None, :]
                           < cl[:, None], positions, cap)
    wpos = torch.clamp(wpos, max=cap)          # past the cache: the sink
    row = torch.arange(b, device=dev)[:, None]
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        att = lyr.self_attn
        q, k, v = _qkv(att, h, (b, c), (b, c))
        q = _apply_rope_rows(q, cos, sin)
        k = _apply_rope_rows(k, cos, sin)
        cache.k[li][row, wpos] = k.to(cache.k[li].dtype)
        cache.v[li][row, wpos] = v.to(cache.v[li].dtype)
        out = A.eager_attention(q, cache.view_k(li), cache.view_v(li),
                                attn_mask=vis)
        x = x + _wo(out.reshape(b, c, att.num_heads * att.head_dim),
                    att.o_proj)
        x = x + _mlp_out(lyr, lyr.post_attention_layernorm(x))
    x = _backbone(model).norm(x)
    return _model_logits(model, x)
