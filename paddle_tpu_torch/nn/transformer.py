"""Transformer layers — counterpart of ``paddle_tpu/nn/transformer.py``.

``MultiHeadAttention`` keeps the reference's API (``embed_dim``,
``num_heads``, separate q/k/v projections, GQA through ``num_kv_heads``,
cached decoding through ``cache=``) and computes through
``nn.functional.scaled_dot_product_attention``: the flash kernel (K2
forward, K5 backward on the card) for padding given as ``kv_lens`` and
for causal or full attention, and the eager path for a dense
``attn_mask`` or attention dropout while training, as the reference
sends those to ``xla_attention``.

Parameters keep the reference's names and ``[in, out]`` layout
(``q_proj.weight`` ...), so ``models.convert.load_jax_state_dict`` fills
them name for name. Dropout draws from the ``generator`` handed to
``forward`` (the reference's ``rng``); the draws are not the reference's
bits.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, LayerList, LayerNorm, Linear,
                                        init_generator)

_ACT = {"gelu": F.gelu, "relu": torch.relu, "silu": F.silu}


class MultiHeadAttention(nn.Module):
    """``forward(query, key=None, value=None, attn_mask=None,
    is_causal=False, cache=None, generator=None, kv_lens=None)``: q/k/v
    [B, S, embed_dim] (key/value default to query). ``cache.update(k, v)``
    returns ``(k, v, new_cache)``, and the call then returns ``(out,
    new_cache)``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, num_kv_heads=None, bias_attr=True,
                 dtype=torch.float32, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        kv_out = self.num_kv_heads * self.head_dim
        kw = dict(bias_attr=bias_attr, dtype=dtype, device=device,
                  generator=gen)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, kv_out, **kw)
        self.v_proj = Linear(vdim or embed_dim, kv_out, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)
        self.dropout = dropout

    def forward(self, query, key=None, value=None, attn_mask=None,
                is_causal=False, cache=None, generator=None, kv_lens=None):
        key = query if key is None else key
        value = key if value is None else value
        b, sq, _ = query.shape
        q = self.q_proj(query).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, key.shape[1], self.num_kv_heads,
                                     self.head_dim)
        v = self.v_proj(value).reshape(b, value.shape[1], self.num_kv_heads,
                                       self.head_dim)
        new_cache = None
        if cache is not None:
            k, v, new_cache = cache.update(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=is_causal, training=self.training, generator=generator,
            kv_lens=kv_lens)
        out = self.out_proj(out.reshape(b, sq, self.embed_dim))
        return (out, new_cache) if cache is not None else out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="gelu", normalize_before=False,
                 dtype=torch.float32, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                            generator=gen, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, generator=gen, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, generator=gen, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation
        self.normalize_before = normalize_before

    def _ff(self, x):
        return self.linear2(_ACT[self.activation](self.linear1(x)))

    def forward(self, src, src_mask=None, generator=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        x = self.self_attn(x, attn_mask=src_mask, generator=generator)
        x = residual + self.dropout1(x, generator)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        x = residual + self.dropout2(self._ff(y), generator)
        if not self.normalize_before:
            x = self.norm2(x)
        return x


class TransformerEncoder(nn.Module):
    """``layer_fn()`` builds each of the ``num_layers`` layers."""

    def __init__(self, layer_fn, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(layer_fn() for _ in range(num_layers))
        self.norm = norm

    def forward(self, src, src_mask=None, generator=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=src_mask, generator=generator)
        return x if self.norm is None else self.norm(x)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="gelu", normalize_before=True,
                 dtype=torch.float32, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        kw = dict(dtype=dtype, device=device)
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                            generator=gen, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                             generator=gen, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, generator=gen, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, generator=gen, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout_p = dropout
        self.activation = activation
        self.normalize_before = normalize_before

    def _drop(self, h, generator):
        return F.dropout(h, self.dropout_p, self.training,
                         generator=generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                generator=None):
        pre = self.normalize_before
        x = tgt
        h = self.norm1(x) if pre else x
        h = self.self_attn(h, attn_mask=tgt_mask, is_causal=tgt_mask is None,
                           generator=generator)
        x = x + self._drop(h, generator)
        if not pre:
            x = self.norm1(x)
        h = self.norm2(x) if pre else x
        h = self.cross_attn(h, key=memory, attn_mask=memory_mask,
                            generator=generator)
        x = x + self._drop(h, generator)
        if not pre:
            x = self.norm2(x)
        h = self.norm3(x) if pre else x
        h = self.linear2(_ACT[self.activation](self.linear1(h)))
        x = x + self._drop(h, generator)
        if not pre:
            x = self.norm3(x)
        return x


class TransformerDecoder(nn.Module):
    """Stack of decoder layers (``layer_fn()`` builds each)."""

    def __init__(self, layer_fn, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(layer_fn() for _ in range(num_layers))
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                generator=None):
        x = tgt
        for layer in self.layers:
            x = layer(x, memory, tgt_mask=tgt_mask, memory_mask=memory_mask,
                      generator=generator)
        return x if self.norm is None else self.norm(x)


class Transformer(nn.Module):
    """Full encoder-decoder Transformer with the reference's constructor
    (``custom_encoder`` / ``custom_decoder`` swap in user stacks);
    ``forward(src, tgt, ...)`` returns the decoder output [B, T_tgt,
    d_model]."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", normalize_before=False,
                 custom_encoder=None, custom_decoder=None,
                 dtype=torch.float32, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=dtype, device=device)
        self.d_model, self.nhead = d_model, nhead

        def norm():
            return LayerNorm(d_model, **kw) if normalize_before else None
        self.encoder = (custom_encoder if custom_encoder is not None
                        else TransformerEncoder(
                            lambda: TransformerEncoderLayer(
                                d_model, nhead, dim_feedforward, dropout,
                                activation, normalize_before, generator=gen,
                                **kw),
                            num_encoder_layers, norm=norm()))
        self.decoder = (custom_decoder if custom_decoder is not None
                        else TransformerDecoder(
                            lambda: TransformerDecoderLayer(
                                d_model, nhead, dim_feedforward, dropout,
                                activation, normalize_before, generator=gen,
                                **kw),
                            num_decoder_layers, norm=norm()))

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None, generator=None):
        memory = self.encoder(src, src_mask=src_mask, generator=generator)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask, generator=generator)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """Additive causal mask [length, length]: 0 on and below the
        diagonal, -inf above (fp32)."""
        row = torch.arange(length, device=resolve_device(device))
        keep = row[None, :] <= row[:, None]
        return torch.where(keep, 0.0, float("-inf")).float()
