"""LayoutLM — counterpart of ``paddle_tpu/models/layoutlm.py`` (PaddleNLP
``paddlenlp/transformers/layoutlm``).

A BERT encoder with 2-D layout embeddings: each token carries its
bounding box ``bbox`` [B, S, 4] (x0, y0, x1, y1 on a 0..1023 grid), and
the embedding sum adds the x table at x0 and x1, the y table at y0 and
y1, and the height and width tables at y1 - y0 and x1 - x0. An
``attention_mask`` becomes the additive mask (the eager attention path,
as the reference's ``xla_attention``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import (BertConfig, BertLayer, _Encoder,
                                          additive_mask, lm_head)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                        init_generator)


@dataclass
class LayoutLMConfig(BertConfig):
    vocab_size: int = 30522
    max_2d_position_embeddings: int = 1024

    @staticmethod
    def tiny(**kw):
        return LayoutLMConfig(**{**dict(vocab_size=128, hidden_size=32,
                                        num_hidden_layers=2,
                                        num_attention_heads=2,
                                        intermediate_size=64,
                                        max_position_embeddings=64,
                                        max_2d_position_embeddings=128),
                                 **kw})


class LayoutLMModel(_Encoder):
    """``forward(input_ids, bbox, token_type_ids=None, attention_mask=None,
    generator=None)`` -> (sequence output, pooled)."""

    def __init__(self, cfg: LayoutLMConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        h, p2 = cfg.hidden_size, cfg.max_2d_position_embeddings
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, h,
                                             **kw)
        self.x_position_embeddings = Embedding(p2, h, **kw)
        self.y_position_embeddings = Embedding(p2, h, **kw)
        self.h_position_embeddings = Embedding(p2, h, **kw)
        self.w_position_embeddings = Embedding(p2, h, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h, **kw)
        self.emb_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                  dtype=cfg.dtype, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.layers = nn.ModuleList(BertLayer(cfg, device, gen)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = Linear(h, h, dtype=cfg.dtype, device=device,
                             generator=gen)

    def forward(self, input_ids, bbox, token_type_ids=None,
                attention_mask=None, generator=None):
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos)
             + self.x_position_embeddings(bbox[..., 0])
             + self.y_position_embeddings(bbox[..., 1])
             + self.x_position_embeddings(bbox[..., 2])
             + self.y_position_embeddings(bbox[..., 3])
             + self.h_position_embeddings(bbox[..., 3] - bbox[..., 1])
             + self.w_position_embeddings(bbox[..., 2] - bbox[..., 0])
             + self.token_type_embeddings(token_type_ids))
        x = self.dropout(self.emb_norm(x), generator)
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask, generator=generator)
        return x, torch.tanh(self.pooler(x[:, 0]))


class LayoutLMForMaskedLM(_Encoder):
    def __init__(self, cfg: LayoutLMConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.layoutlm = LayoutLMModel(cfg, device, generator=gen)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    generator=gen, **kw)
        self.mlm_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                  **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))

    def forward(self, input_ids, bbox, token_type_ids=None,
                attention_mask=None):
        seq, _ = self.layoutlm(input_ids, bbox, token_type_ids,
                               attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        return lm_head(h, self.layoutlm.word_embeddings, self.mlm_bias)
