"""ERNIE-M — counterpart of ``paddle_tpu/models/ernie_m.py`` (PaddleNLP
``paddlenlp/transformers/ernie_m``, Baidu's multilingual ERNIE).

A post-LN encoder with ERNIE-M's embedding quirk: no token-type stream,
and positions offset by +2 (the PaddleNLP convention the HF port
mimics). The blocks are ``nn.transformer.MultiHeadAttention`` + a gelu
MLP. An ``attention_mask`` becomes the additive mask (the eager attention
path, as the reference's ``xla_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import _Encoder, additive_mask
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Embedding, LayerNorm, Linear,
                                        init_generator)
from paddle_tpu_torch.nn.transformer import MultiHeadAttention


@dataclass
class ErnieMConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw):
        return ErnieMConfig(**{**dict(vocab_size=128, hidden_size=32,
                                      num_hidden_layers=2,
                                      num_attention_heads=2,
                                      intermediate_size=64,
                                      max_position_embeddings=66), **kw})


class ErnieMLayer(nn.Module):
    def __init__(self, cfg: ErnieMConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.self_attn = MultiHeadAttention(h, cfg.num_attention_heads,
                                            generator=gen, **kw)
        self.norm1 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.linear1 = Linear(h, cfg.intermediate_size, generator=gen, **kw)
        self.linear2 = Linear(cfg.intermediate_size, h, generator=gen, **kw)
        self.norm2 = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.self_attn(x, attn_mask=attn_mask))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class ErnieMModel(_Encoder):
    """``forward(input_ids, attention_mask=None)`` -> (sequence output,
    pooled)."""

    def __init__(self, cfg: ErnieMConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        h = cfg.hidden_size
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, h,
                                             **kw)
        self.emb_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(ErnieMLayer(cfg, device, gen)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = Linear(h, h, dtype=cfg.dtype, device=device,
                             generator=gen)

    def forward(self, input_ids, attention_mask=None):
        s = input_ids.shape[1]
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        # the PaddleNLP +2 position offset (no token-type stream)
        pos = torch.arange(2, s + 2, device=input_ids.device)[None, :]
        x = self.emb_norm(self.word_embeddings(input_ids)
                          + self.position_embeddings(pos))
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ErnieMForSequenceClassification(_Encoder):
    def __init__(self, cfg: ErnieMConfig, num_classes: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        self.cfg = cfg
        self.ernie_m = ErnieMModel(cfg, device, generator=gen)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 dtype=cfg.dtype, device=device,
                                 generator=gen)

    def forward(self, input_ids, attention_mask=None):
        _, pooled = self.ernie_m(input_ids, attention_mask)
        return self.classifier(pooled)
