"""BLOOM decoder LM — counterpart of ``paddle_tpu/models/bloom.py``.

The ALiBi-positioned member of the zoo: no rotary or learned positions;
attention carries per-head linear distance penalties, which
``ops.attention.scaled_dot_product_attention(alibi_slopes=...)`` hands to
the flash kernel (K2 forward, K5 backward: the bias is added in the tile
from the indices, no [S, Sk] bias tensor exists).

Same parameter names and ``[in, out]`` layout as the reference, so
``models.convert.load_jax_state_dict`` loads a reference model's
``state_dict()`` as it is: the fused ``qkv`` is ``[h, 3h]`` with columns
``[q all heads | k | v]``. Blocks: [LayerNorm -> fused-QKV attention ->
dense] and [LayerNorm -> h->4h gelu(tanh) -> 4h->h]; the word embeddings
carry a LayerNorm and are tied to the head. ``remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, the counterpart of
the reference's per-block ``jax.checkpoint``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import attention as A


def alibi_slopes(n_heads: int, device=None):
    """The ALiBi slope schedule (HF ``build_alibi_tensor``'s head
    geometry): powers of ``2^(-8/n)`` for the closest power-of-two head
    count, interleaved extras when n is not a power of two. fp32 [n] on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    p = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(p) - 3)))
    slopes = [base ** (i + 1) for i in range(p)]
    if p < n_heads:
        extra = 2.0 ** (-(2.0 ** -(math.log2(2 * p) - 3)))
        slopes += [extra ** (2 * i + 1) for i in range(n_heads - p)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


@dataclass
class BloomConfig:
    """The defaults are ``bigscience/bloom-560m``'s ``config.json``."""
    vocab_size: int = 250880
    hidden_size: int = 1024
    n_layer: int = 24
    n_head: int = 16
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @staticmethod
    def tiny(**kw):
        return BloomConfig(**{**dict(vocab_size=128, hidden_size=32,
                                     n_layer=2, n_head=4, dtype=torch.float32,
                                     remat=False), **kw})


def _layer_norm(cfg, init):
    return LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                     dtype=cfg.dtype, device=init.device)


class BloomBlock(nn.Module):
    def __init__(self, cfg: BloomConfig, init: _Init):
        super().__init__()
        h = cfg.hidden_size
        self.input_layernorm = _layer_norm(cfg, init)
        # [h, 3h]: columns [q all heads | k | v]
        self.qkv = init.normal(h, 3 * h)
        self.qkv_bias = init.fill(0.0, 3 * h)
        self.dense = init.normal(h, h)
        self.dense_bias = init.fill(0.0, h)
        self.post_attention_layernorm = _layer_norm(cfg, init)
        self.h_to_4h = init.normal(h, 4 * h)
        self.h_to_4h_bias = init.fill(0.0, 4 * h)
        self.four_h_to_h = init.normal(4 * h, h)
        self.four_h_to_h_bias = init.fill(0.0, h)
        self.n_head = cfg.n_head
        self.head_dim = h // cfg.n_head

    def forward(self, x, slopes):
        b, s, hd = x.shape
        nh, d = self.n_head, self.head_dim
        h = self.input_layernorm(x)
        q, k, v = torch.split(h @ self.qkv + self.qkv_bias, hd, dim=-1)
        att = A.scaled_dot_product_attention(
            q.reshape(b, s, nh, d), k.reshape(b, s, nh, d),
            v.reshape(b, s, nh, d), is_causal=True, alibi_slopes=slopes)
        x = x + att.reshape(b, s, hd) @ self.dense + self.dense_bias
        h2 = self.post_attention_layernorm(x)
        m = F.gelu(h2 @ self.h_to_4h + self.h_to_4h_bias, approximate=True)
        return x + m @ self.four_h_to_h + self.four_h_to_h_bias


class BloomForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: BloomConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.word_embeddings = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.word_embeddings_layernorm = _layer_norm(cfg, init)
        self.h = nn.ModuleList(BloomBlock(cfg, init)
                               for _ in range(cfg.n_layer))
        self.ln_f = _layer_norm(cfg, init)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    def forward(self, input_ids):
        slopes = alibi_slopes(self.cfg.n_head, self.device)
        x = self.word_embeddings_layernorm(self.word_embeddings[input_ids])
        remat = self.cfg.remat and torch.is_grad_enabled()
        for lyr in self.h:
            x = (checkpoint(lyr, x, slopes, use_reentrant=False) if remat
                 else lyr(x, slopes))
        return self.ln_f(x) @ self.word_embeddings.T      # tied head

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)


def causal_lm_loss(logits, labels):
    """The BLOOM/Falcon reference loss: fp32 log-softmax, the label's term
    by gather (labels clamped at 0), mean over the labels >= 0."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    return F.masked_mean(-ll, (labels >= 0).float())


def num_flops_per_token(cfg: BloomConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU), the Llama count's formula: 3 x the
    forward's matmul FLOPs (fused QKV, dense, the 4h MLP, the tied
    250 880-wide head) plus the attention products QK^T and PV."""
    h, L, v = cfg.hidden_size, cfg.n_layer, cfg.vocab_size
    per_layer = 2 * h * 3 * h + 2 * h * h + 2 * h * 4 * h * 2
    attn = L * 2 * 2 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * v + attn)
