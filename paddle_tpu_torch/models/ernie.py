"""ERNIE — counterpart of ``paddle_tpu/models/ernie.py`` (PaddleNLP
``paddlenlp/transformers/ernie``, ERNIE 1.0 / 3.0).

A BERT-style post-LN encoder (the blocks ARE ``BertLayer``) plus ERNIE's
task-type embedding: a third id stream (``task_type_ids``) added into
the embedding sum when ``use_task_id`` (ERNIE 3.0 checkpoints). An
``attention_mask`` becomes the additive mask, so attention with one
takes the eager path, as the reference's takes ``xla_attention``; without
one every layer takes the flash kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import (BertConfig, BertLayer, _Encoder,
                                          additive_mask, lm_head,
                                          masked_lm_loss)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                        init_generator)


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    use_task_id: bool = True
    task_type_vocab_size: int = 3
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw):
        return ErnieConfig(**{**dict(vocab_size=128, hidden_size=32,
                                     num_hidden_layers=2,
                                     num_attention_heads=2,
                                     intermediate_size=64,
                                     max_position_embeddings=64), **kw})

    def _bert_view(self):
        """The shared-field view ``BertLayer`` reads."""
        return BertConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            hidden_dropout_prob=self.hidden_dropout_prob,
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=self.type_vocab_size,
            layer_norm_eps=self.layer_norm_eps,
            initializer_range=self.initializer_range, dtype=self.dtype)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, h,
                                             **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, h, **kw)
        self.task_type_embeddings = (
            Embedding(cfg.task_type_vocab_size, h, **kw)
            if cfg.use_task_id else None)
        self.layer_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                    dtype=cfg.dtype, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None, generator=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros_like(input_ids)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x), generator)


class ErnieModel(_Encoder):
    """``forward(input_ids, token_type_ids=None, attention_mask=None,
    task_type_ids=None, generator=None)`` -> (sequence output, pooled)."""

    def __init__(self, cfg: ErnieConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        bcfg = cfg._bert_view()
        self.embeddings = ErnieEmbeddings(cfg, device, gen)
        self.layers = nn.ModuleList(BertLayer(bcfg, device, gen)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size,
                             dtype=cfg.dtype, device=device, generator=gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, generator=None):
        if attention_mask is not None:
            attention_mask = additive_mask(attention_mask)
        x = self.embeddings(input_ids, token_type_ids,
                            task_type_ids=task_type_ids, generator=generator)
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask, generator=generator)
        return x, torch.tanh(self.pooler(x[:, 0]))


class ErnieForMaskedLM(_Encoder):
    """MLM head (HF ``ErnieForMaskedLM``): transform + LN + tied decoder."""

    def __init__(self, cfg: ErnieConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, device, generator=gen)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    generator=gen, **kw)
        self.mlm_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                  **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, generator=None):
        seq, _ = self.ernie(input_ids, token_type_ids, attention_mask,
                            task_type_ids=task_type_ids, generator=generator)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        return lm_head(h, self.ernie.embeddings.word_embeddings,
                       self.mlm_bias)

    def loss(self, input_ids, mlm_labels, token_type_ids=None,
             attention_mask=None, task_type_ids=None, generator=None):
        logits = self(input_ids, token_type_ids, attention_mask,
                      task_type_ids=task_type_ids, generator=generator)
        return masked_lm_loss(logits, mlm_labels)


class ErnieForSequenceClassification(_Encoder):
    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        self.cfg = cfg
        self.ernie = ErnieModel(cfg, device, generator=gen)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 dtype=cfg.dtype, device=device,
                                 generator=gen)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None, generator=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                               task_type_ids=task_type_ids,
                               generator=generator)
        return self.classifier(self.dropout(pooled, generator))
