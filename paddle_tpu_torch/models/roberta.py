"""RoBERTa — counterpart of ``paddle_tpu/models/roberta.py`` (PaddleNLP
``paddlenlp/transformers/roberta``).

BERT with two embedding quirks: position ids start at ``padding_idx +
1`` (fairseq's: token i of an unpadded row sits at ``i + 2``, padded
positions keep ``padding_idx``; :func:`roberta_position_ids`), and one
token type. The encoder IS ``BertModel``; the MLM head is dense + gelu +
LayerNorm with the decoder tied to the word embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.models.bert import (BertConfig, BertModel, _Encoder,
                                          lm_head, masked_lm_loss)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import LayerNorm, Linear, init_generator


@dataclass
class RobertaConfig(BertConfig):
    vocab_size: int = 50265
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1

    @staticmethod
    def tiny(**kw):
        return RobertaConfig(**{**dict(vocab_size=128, hidden_size=32,
                                       num_hidden_layers=2,
                                       num_attention_heads=2,
                                       intermediate_size=64,
                                       max_position_embeddings=66), **kw})


def roberta_position_ids(input_ids, pad_token_id):
    """fairseq-style: pad positions stay at ``pad_token_id``; real tokens
    get ``pad_token_id`` + their 1-based index among the non-pad tokens."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


class RobertaModel(_Encoder):
    def __init__(self, cfg: RobertaConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        self.bert = BertModel(cfg, device, generator=gen)

    def forward(self, input_ids, attention_mask=None, generator=None):
        pos = roberta_position_ids(input_ids, self.cfg.pad_token_id)
        return self.bert(input_ids, attention_mask=attention_mask,
                         generator=generator, position_ids=pos)


class RobertaForMaskedLM(_Encoder):
    def __init__(self, cfg: RobertaConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.roberta = RobertaModel(cfg, device, generator=gen)
        self.lm_dense = Linear(cfg.hidden_size, cfg.hidden_size,
                               generator=gen, **kw)
        self.lm_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                 **kw)
        self.lm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))

    def forward(self, input_ids, attention_mask=None, generator=None):
        seq, _ = self.roberta(input_ids, attention_mask, generator=generator)
        h = self.lm_norm(F.gelu(self.lm_dense(seq)))
        return lm_head(h, self.roberta.bert.embeddings.word_embeddings,
                       self.lm_bias)

    def loss(self, input_ids, mlm_labels, attention_mask=None,
             generator=None):
        return masked_lm_loss(self(input_ids, attention_mask,
                                   generator=generator), mlm_labels)


class RobertaForSequenceClassification(_Encoder):
    """HF-style classification head over <s> (no pooler tanh): dense +
    tanh + out_proj."""

    def __init__(self, cfg: RobertaConfig, num_classes: int = 2,
                 device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device, generator=gen)
        self.cfg = cfg
        self.roberta = RobertaModel(cfg, device, generator=gen)
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.out_proj = Linear(cfg.hidden_size, num_classes, **kw)

    def forward(self, input_ids, attention_mask=None, generator=None):
        seq, _ = self.roberta(input_ids, attention_mask, generator=generator)
        return self.out_proj(torch.tanh(self.dense(seq[:, 0])))
