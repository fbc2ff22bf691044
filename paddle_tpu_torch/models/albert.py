"""ALBERT — counterpart of ``paddle_tpu/models/albert.py`` (PaddleNLP
``paddlenlp/transformers/albert``).

The parameter-sharing encoder: ONE transformer layer's weights
(``shared``) are applied ``num_hidden_layers`` times, so autograd sums
each application's gradient into the one set of parameters; on top of a
factorised embedding (``embedding_size`` < ``hidden_size`` and a
projection). Post-LN blocks, tanh-GELU (``gelu_new``), the MLM head back
in embedding space with the decoder tied to the word table. An
``attention_mask`` becomes the additive mask (the eager attention path,
as the reference's ``xla_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import (_Encoder, additive_mask, lm_head,
                                          masked_lm_loss)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Embedding, LayerNorm, Linear,
                                        init_generator)
from paddle_tpu_torch.nn.transformer import MultiHeadAttention


@dataclass
class AlbertConfig:
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw):
        return AlbertConfig(**{**dict(vocab_size=128, embedding_size=16,
                                      hidden_size=32, num_hidden_layers=3,
                                      num_attention_heads=2,
                                      intermediate_size=64,
                                      max_position_embeddings=64), **kw})


class AlbertSharedLayer(nn.Module):
    """The ONE layer whose weights every depth step reuses."""

    def __init__(self, cfg: AlbertConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.attention = MultiHeadAttention(h, cfg.num_attention_heads,
                                            generator=gen, **kw)
        self.attn_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.ffn = Linear(h, cfg.intermediate_size, generator=gen, **kw)
        self.ffn_output = Linear(cfg.intermediate_size, h, generator=gen,
                                 **kw)
        self.full_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)

    def forward(self, x, attn_mask=None):
        x = self.attn_norm(x + self.attention(x, attn_mask=attn_mask))
        m = self.ffn_output(F.gelu(self.ffn(x), approximate=True))
        return self.full_norm(x + m)


class AlbertModel(_Encoder):
    """``forward(input_ids, token_type_ids=None, attention_mask=None)`` ->
    (sequence output, pooled)."""

    def __init__(self, cfg: AlbertConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        e = cfg.embedding_size
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, e, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, e,
                                             **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, e, **kw)
        lkw = dict(dtype=cfg.dtype, device=device)
        self.emb_norm = LayerNorm(e, epsilon=cfg.layer_norm_eps, **lkw)
        self.embedding_project = Linear(e, cfg.hidden_size, generator=gen,
                                        **lkw)
        self.shared = AlbertSharedLayer(cfg, device, gen)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, generator=gen,
                             **lkw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = self.embedding_project(self.emb_norm(x))
        # weight recycling: the SAME layer's parameters at every depth step
        for _ in range(self.cfg.num_hidden_layers):
            x = self.shared(x, attn_mask=attention_mask)
        return x, torch.tanh(self.pooler(x[:, 0]))


class AlbertForMaskedLM(_Encoder):
    def __init__(self, cfg: AlbertConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.albert = AlbertModel(cfg, device, generator=gen)
        self.lm_dense = Linear(cfg.hidden_size, cfg.embedding_size,
                               generator=gen, **kw)
        self.lm_norm = LayerNorm(cfg.embedding_size,
                                 epsilon=cfg.layer_norm_eps, **kw)
        self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.albert(input_ids, token_type_ids, attention_mask)
        h = self.lm_norm(F.gelu(self.lm_dense(seq), approximate=True))
        return lm_head(h, self.albert.word_embeddings, self.lm_bias)

    def loss(self, input_ids, mlm_labels, token_type_ids=None,
             attention_mask=None):
        return masked_lm_loss(self(input_ids, token_type_ids,
                                   attention_mask), mlm_labels)
