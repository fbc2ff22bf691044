"""BERT — counterpart of ``paddle_tpu/models/bert.py`` (PaddleNLP's
``BertModel`` and the reference's BASELINE config 2, BERT-base MLM + NSP
pretraining, ``bench.py`` ``bench_bert_dp``).

A post-LN encoder over ``nn.transformer.MultiHeadAttention``, learned
positions and token types, with the MLM + NSP heads
(``BertForPretraining``; the MLM decoder tied to the word embeddings,
``h @ word_embeddings.weight.T + mlm_bias``) and a pooled classifier
(``BertForSequenceClassification``).

Padding. An ``attention_mask`` [B, S] of 1s and 0s becomes the additive
mask ``(1 - mask) * -1e9`` [B, 1, 1, S], which sends attention to the
eager path (the reference's ``xla_attention``). With
``BertConfig.varlen_attention`` the mask must be a contiguous prefix
(right padding) and becomes per-row lengths ``kv_lens``, which keep the
flash kernel: K2 forward and K5 backward on the card, without a causal
mask, at BERT's head dim 64 (the reference's Pallas dispatch sends head
dim 64 to XLA; the port sends it to its kernels by design). A mask that
is not a prefix raises ``ValueError``; the check reads the mask on the
host, so a mask on the card costs one synchronisation a forward.
Attention dropout while training goes to the eager path too, as the
reference's goes to ``xla_attention``.

Same parameter names and ``[in, out]`` layout as the reference, so
``models.convert.load_jax_state_dict`` fills them name for name. Dropout
draws its masks from the ``generator`` handed to ``forward`` / ``loss``
(the reference's ``rng``): keep rates and scaling are the reference's,
the bits are not.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerNorm, Linear,
                                        init_generator)
from paddle_tpu_torch.nn.transformer import MultiHeadAttention


@dataclass
class BertConfig:
    """The defaults are BERT-base's (12 layers, hidden 768, 12 heads of 64,
    MLP 3072, vocabulary 30 522, 512 positions, 2 token types)."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    # an attention_mask is a contiguous right-padded prefix, passed to the
    # flash kernel as per-row lengths instead of a dense additive mask
    varlen_attention: bool = False

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def large(**kw):
        return BertConfig(**{**dict(hidden_size=1024, num_hidden_layers=24,
                                    num_attention_heads=16,
                                    intermediate_size=4096), **kw})

    @staticmethod
    def tiny(**kw):
        return BertConfig(**{**dict(vocab_size=128, hidden_size=32,
                                    num_hidden_layers=2, num_attention_heads=2,
                                    intermediate_size=64,
                                    max_position_embeddings=64,
                                    type_vocab_size=2), **kw})


class _Encoder(nn.Module):
    """The encoders' common surface: ``device`` (where the parameters
    live)."""

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def additive_mask(attention_mask):
    """[B, S] 1/0 -> the reference's additive mask [B, 1, 1, S] fp32:
    0 where kept, -1e9 where padded."""
    return (1.0 - attention_mask[:, None, None, :].float()) * -1e9


def varlen_lengths(attention_mask):
    """Per-row lengths [B] int32 of a contiguous right-padded mask (1s then
    0s). Any other mask raises ``ValueError``, as the reference's host-side
    check does; the check reads the mask on the host."""
    am = torch.as_tensor(attention_mask)
    lens = am.to(torch.int32).sum(1, dtype=torch.int32)
    prefix = (torch.arange(am.shape[1], device=am.device)[None, :]
              < lens[:, None]).to(am.dtype)
    if not torch.equal(am, prefix):
        raise ValueError(
            "varlen_attention=True requires a CONTIGUOUS right-padded "
            "attention_mask (1s then 0s); got a non-prefix mask — use "
            "varlen_attention=False for arbitrary masks")
    return lens


def lm_head(h, word_embeddings, bias):
    """The tied decoder: ``h @ word_embeddings.T + bias``."""
    return h @ word_embeddings.weight.T + bias


def masked_lm_loss(logits, labels):
    """Mean cross entropy over the positions whose label is >= 0 (the
    reference's masked MLM mean)."""
    ce = F.cross_entropy(logits, torch.clamp(labels, min=0),
                         reduction="none")
    return F.masked_mean(ce, (labels >= 0).float())


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device, gen):
        super().__init__()
        kw = dict(std=cfg.initializer_range, dtype=cfg.dtype, device=device,
                  generator=gen)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size,
                                    epsilon=cfg.layer_norm_eps,
                                    dtype=cfg.dtype, device=device)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                generator=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x), generator)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device, gen):
        super().__init__()
        h = cfg.hidden_size
        kw = dict(dtype=cfg.dtype, device=device)
        self.attention = MultiHeadAttention(
            h, cfg.num_attention_heads,
            dropout=cfg.attention_probs_dropout_prob, generator=gen, **kw)
        self.attn_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.intermediate = Linear(h, cfg.intermediate_size, generator=gen,
                                   **kw)
        self.output = Linear(cfg.intermediate_size, h, generator=gen, **kw)
        self.out_norm = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None, generator=None, kv_lens=None):
        # three dropout draws: attention-internal, post-attention
        # residual, post-FF residual
        h = self.attention(x, attn_mask=attn_mask, generator=generator,
                           kv_lens=kv_lens)
        x = self.attn_norm(x + self.dropout(h, generator))
        h = self.output(F.gelu(self.intermediate(x)))
        return self.out_norm(x + self.dropout(h, generator))


class BertModel(_Encoder):
    """``forward(input_ids, token_type_ids=None, attention_mask=None,
    generator=None, position_ids=None)`` -> (sequence output [B, S, h],
    pooled [B, h]). ``device``: None is the card (raises without one);
    ``seed`` draws the random weights."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, device, gen)
        self.layers = nn.ModuleList(BertLayer(cfg, device, gen)
                                    for _ in range(cfg.num_hidden_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size,
                             dtype=cfg.dtype, device=device, generator=gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None, position_ids=None):
        kv_lens = None
        if attention_mask is not None:
            if self.cfg.varlen_attention:
                kv_lens = varlen_lengths(attention_mask)
                attention_mask = None
            else:
                attention_mask = additive_mask(attention_mask)
        x = self.embeddings(input_ids, token_type_ids,
                            position_ids=position_ids, generator=generator)
        for lyr in self.layers:
            x = lyr(x, attn_mask=attention_mask, generator=generator,
                    kv_lens=kv_lens)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPretraining(_Encoder):
    """MLM + NSP heads: ``forward`` -> (mlm_logits [B, S, V], nsp_logits
    [B, 2]); ``loss(input_ids, mlm_labels, nsp_labels=None, ...)`` the
    masked MLM mean (labels < 0 ignored) plus the NSP cross entropy."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        kw = dict(dtype=cfg.dtype, device=device)
        self.cfg = cfg
        self.bert = BertModel(cfg, device, generator=gen)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    generator=gen, **kw)
        self.mlm_norm = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                  **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **kw))
        self.nsp_head = Linear(cfg.hidden_size, 2, generator=gen, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                                generator=generator)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq)))
        mlm_logits = lm_head(h, self.bert.embeddings.word_embeddings,
                             self.mlm_bias)
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, input_ids, mlm_labels, nsp_labels=None,
             token_type_ids=None, attention_mask=None, generator=None):
        mlm_logits, nsp_logits = self(input_ids, token_type_ids,
                                      attention_mask, generator=generator)
        loss = masked_lm_loss(mlm_logits, mlm_labels)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss


class BertForSequenceClassification(_Encoder):
    """The pooled output through dropout and a ``[h, num_classes]``
    classifier: ``forward`` -> logits [B, num_classes]."""

    def __init__(self, cfg: BertConfig, num_classes: int = 2, device=None,
                 seed: int = 0):
        super().__init__()
        device, gen = init_generator(device, seed, None)
        self.cfg = cfg
        self.bert = BertModel(cfg, device, generator=gen)
        self.classifier = Linear(cfg.hidden_size, num_classes,
                                 dtype=cfg.dtype, device=device,
                                 generator=gen)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                generator=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              generator=generator)
        return self.classifier(self.dropout(pooled, generator))


def num_flops_per_token(cfg: BertConfig, seq_len: int) -> float:
    """Training FLOPs a token of ``BertForPretraining`` (for MFU): 3 x the
    forward's matmul FLOPs — per layer q, k, v and out (4 x 2 h^2), the
    MLP (2 x 2 h I) and the attention products QK^T and PV (2 x 2 S h) —
    plus the MLM head's transform (2 h^2) and tied decoder (2 h V). The
    pooler and the NSP head, once a sequence, are left out."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    per_layer = 8 * h * h + 4 * h * cfg.intermediate_size + 4 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * h + 2 * h * v)
