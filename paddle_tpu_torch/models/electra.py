"""ELECTRA — counterpart of ``paddle_tpu/models/electra.py`` (PaddleNLP
``paddlenlp/transformers/electra``).

A BERT-style encoder with a factorised embedding: the tables live in
``embedding_size`` dims and are projected up to ``hidden_size`` before
the first block (no projection when the two are equal).
``ElectraForPreTraining`` is the replaced-token discriminator, a
per-token binary head. An ``attention_mask`` becomes the additive mask
(the eager attention path, as the reference's ``xla_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import (BertConfig, BertLayer, _Encoder,
                                          additive_mask)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                        init_generator)


@dataclass
class ElectraConfig(BertConfig):
    vocab_size: int = 30522
    embedding_size: int = 128

    @staticmethod
    def tiny(**kw):
        return ElectraConfig(**{**dict(vocab_size=128, hidden_size=32,
                                       embedding_size=16,
                                       num_hidden_layers=2,
                                       num_attention_heads=2,
                                       intermediate_size=64,
                                       max_position_embeddings=64), **kw})


class ElectraModel(_Encoder):
    """``forward(input_ids, token_type_ids=None, attention_mask=None,
    generator=None)`` -> the sequence output [B, S, h]."""

    def __init__(self, cfg: ElectraConfig, device=None, seed: int = 0,
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
        self.emb_norm = LayerNorm(e, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.embeddings_project = (
            Linear(e, cfg.hidden_size, dtype=cfg.dtype, device=device,
                   generator=gen) if e != cfg.hidden_size else None)
        self.layers = nn.ModuleList(BertLayer(cfg, device, gen)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = self.dropout(self.emb_norm(x), generator)
        if self.embeddings_project is not None:
            x = self.embeddings_project(x)
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask, generator=generator)
        return x


class ElectraForPreTraining(_Encoder):
    """Replaced-token-detection discriminator: [B, S] logits (> 0:
    predicted replaced)."""

    def __init__(self, cfg: ElectraConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device, generator=gen)
        self.cfg = cfg
        self.electra = ElectraModel(cfg, device, generator=gen)
        self.disc_dense = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.disc_out = Linear(cfg.hidden_size, 1, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        seq = self.electra(input_ids, token_type_ids, attention_mask,
                           generator=generator)
        return self.disc_out(F.gelu(self.disc_dense(seq)))[..., 0]

    def loss(self, input_ids, labels, token_type_ids=None,
             attention_mask=None, generator=None):
        """Per-token binary cross entropy; labels < 0 are ignored."""
        logits = self(input_ids, token_type_ids, attention_mask,
                      generator=generator).float()
        y = torch.clamp(labels, 0, 1).float()
        ce = (torch.clamp(logits, min=0) - logits * y
              + torch.log1p(torch.exp(-logits.abs())))
        return F.masked_mean(ce, (labels >= 0).float())
