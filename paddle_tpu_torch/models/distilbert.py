"""DistilBERT — counterpart of ``paddle_tpu/models/distilbert.py``
(PaddleNLP ``paddlenlp/transformers/distilbert``).

The distilled 6-layer BERT shape: no token-type stream, no pooler,
post-LN blocks over ``nn.transformer.MultiHeadAttention``, the MLM head
transform + LN + a projector tied to the word embeddings. An
``attention_mask`` becomes the additive mask (the eager attention path,
as the reference's ``xla_attention``); without one every layer takes the
flash kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import _Encoder, additive_mask, lm_head
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Embedding, LayerNorm, Linear,
                                        init_generator)
from paddle_tpu_torch.nn.transformer import MultiHeadAttention


@dataclass
class DistilBertConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw):
        return DistilBertConfig(**{**dict(vocab_size=128, dim=32,
                                          n_layers=2, n_heads=2,
                                          hidden_dim=64,
                                          max_position_embeddings=64),
                                   **kw})


class DistilBertLayer(nn.Module):
    def __init__(self, cfg: DistilBertConfig, device, gen):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.attention = MultiHeadAttention(cfg.dim, cfg.n_heads,
                                            generator=gen, **kw)
        self.sa_layer_norm = LayerNorm(cfg.dim, epsilon=1e-12, **kw)
        self.lin1 = Linear(cfg.dim, cfg.hidden_dim, generator=gen, **kw)
        self.lin2 = Linear(cfg.hidden_dim, cfg.dim, generator=gen, **kw)
        self.output_layer_norm = LayerNorm(cfg.dim, epsilon=1e-12, **kw)

    def forward(self, x, attn_mask=None):
        x = self.sa_layer_norm(x + self.attention(x, attn_mask=attn_mask))
        return self.output_layer_norm(x + self.lin2(F.gelu(self.lin1(x))))


class DistilBertModel(_Encoder):
    """``forward(input_ids, attention_mask=None)`` -> the sequence output
    [B, S, dim]."""

    def __init__(self, cfg: DistilBertConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.dim, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.dim, **kw)
        self.emb_norm = LayerNorm(cfg.dim, epsilon=1e-12, dtype=cfg.dtype,
                                  device=device)
        self.layers = nn.ModuleList(DistilBertLayer(cfg, device, gen)
                                    for _ in range(cfg.n_layers))

    def forward(self, input_ids, attention_mask=None):
        s = input_ids.shape[1]
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.emb_norm(self.word_embeddings(input_ids)
                          + self.position_embeddings(pos))
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask)
        return x


class DistilBertForMaskedLM(_Encoder):
    def __init__(self, cfg: DistilBertConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.distilbert = DistilBertModel(cfg, device, generator=gen)
        self.vocab_transform = Linear(cfg.dim, cfg.dim, generator=gen, **kw)
        self.vocab_norm = LayerNorm(cfg.dim, epsilon=1e-12, **kw)
        self.vocab_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))

    def forward(self, input_ids, attention_mask=None):
        seq = self.distilbert(input_ids, attention_mask)
        h = self.vocab_norm(F.gelu(self.vocab_transform(seq)))
        return lm_head(h, self.distilbert.word_embeddings, self.vocab_bias)
