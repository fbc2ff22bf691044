"""Falcon decoder LM — counterpart of ``paddle_tpu/models/falcon.py``.

The three block shapes of the reference, chosen by the config:
- falcon-7b: ONE shared K/V head (``multi_query``) under a single-LN
  parallel block (attention and MLP both read ``input_layernorm(x)``);
- the 40b/180b "new decoder architecture": grouped K/V heads with
  separate ``ln_attn`` / ``ln_mlp``;
- falcon-rw: sequential residuals (``parallel_attn=False``) with ALiBi
  instead of rotary, BLOOM's slope schedule times 2/sqrt(d) (the
  reference reproduces HF's double add), and biases.

Rotary goes through ``ops.attention.apply_rope`` (K7 on the card),
attention through ``scaled_dot_product_attention`` (K2/K5; ALiBi in the
tile). Same parameter names and ``[in, out]`` layout as the reference;
the biases and LayerNorms a config turns off are ``None`` there and are
not parameters here, so ``models.convert.load_jax_state_dict`` neither
expects nor invents them. Word embeddings are tied to the head.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.bloom import alibi_slopes, causal_lm_loss
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import attention as A


@dataclass
class FalconConfig:
    """The defaults are ``tiiuae/falcon-7b``'s ``config.json``."""
    vocab_size: int = 65024
    hidden_size: int = 4544
    num_hidden_layers: int = 32
    num_attention_heads: int = 71
    num_kv_heads: int | None = None    # new_decoder_architecture only
    new_decoder_architecture: bool = False
    multi_query: bool = True
    parallel_attn: bool = True
    bias: bool = False
    alibi: bool = False
    rope_theta: float = 10000.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def kv_heads(self):
        if self.new_decoder_architecture:
            return self.num_kv_heads or self.num_attention_heads
        return 1 if self.multi_query else self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        return FalconConfig(**{**dict(vocab_size=128, hidden_size=32,
                                      num_hidden_layers=2,
                                      num_attention_heads=4,
                                      dtype=torch.float32, remat=False),
                               **kw})


class FalconDecoderLayer(nn.Module):
    def __init__(self, cfg: FalconConfig, init: _Init):
        super().__init__()
        h, nkv = cfg.hidden_size, cfg.kv_heads
        d = h // cfg.num_attention_heads

        def ln():
            return LayerNorm(h, epsilon=cfg.layer_norm_epsilon,
                             dtype=cfg.dtype, device=init.device)
        if cfg.new_decoder_architecture:
            self.ln_attn, self.ln_mlp = ln(), ln()
            self.input_layernorm = self.post_attention_layernorm = None
        else:
            self.input_layernorm = ln()
            self.ln_attn = self.ln_mlp = None
            self.post_attention_layernorm = (None if cfg.parallel_attn
                                             else ln())
        self.wq = init.normal(h, h)
        self.wk = init.normal(h, nkv * d)
        self.wv = init.normal(h, nkv * d)
        self.dense = init.normal(h, h)
        self.h_to_4h = init.normal(h, 4 * h)
        self.four_h_to_h = init.normal(4 * h, h)

        def bias(n):
            return init.fill(0.0, n) if cfg.bias else None
        self.wq_bias, self.wk_bias = bias(h), bias(nkv * d)
        self.wv_bias, self.dense_bias = bias(nkv * d), bias(h)
        self.h_to_4h_bias, self.four_h_to_h_bias = bias(4 * h), bias(h)
        self.num_heads, self.num_kv_heads = cfg.num_attention_heads, nkv
        self.parallel, self.alibi = cfg.parallel_attn, cfg.alibi

    @staticmethod
    def _proj(x, w, b):
        y = x @ w
        return y if b is None else y + b

    def _attn(self, h, cos, sin, slopes):
        b, s, hd = h.shape
        nh, nkv = self.num_heads, self.num_kv_heads
        d = hd // nh
        q = self._proj(h, self.wq, self.wq_bias).reshape(b, s, nh, d)
        k = self._proj(h, self.wk, self.wk_bias).reshape(b, s, nkv, d)
        v = self._proj(h, self.wv, self.wv_bias).reshape(b, s, nkv, d)
        if not self.alibi:
            q, k = A.apply_rope(q, cos, sin), A.apply_rope(k, cos, sin)
        att = A.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             alibi_slopes=slopes)
        return self._proj(att.reshape(b, s, hd), self.dense, self.dense_bias)

    def _mlp(self, h):
        m = F.gelu(self._proj(h, self.h_to_4h, self.h_to_4h_bias),
                   approximate=False)
        return self._proj(m, self.four_h_to_h, self.four_h_to_h_bias)

    def forward(self, x, cos, sin, slopes):
        if self.ln_attn is not None:        # new decoder architecture
            return (x + self._attn(self.ln_attn(x), cos, sin, slopes)
                    + self._mlp(self.ln_mlp(x)))
        h = self.input_layernorm(x)
        att = self._attn(h, cos, sin, slopes)
        if self.parallel:                   # 7b: ONE ln feeds attn and mlp
            return x + att + self._mlp(h)
        x = x + att                         # falcon-rw: sequential
        return x + self._mlp(self.post_attention_layernorm(x))


def falcon_alibi_slopes(cfg: FalconConfig, device=None):
    """The [H] fp32 slopes the attention kernels get under ``cfg.alibi``
    (None without it). HF Falcon folds alibi / sqrt(d) into the causal mask
    AND adds alibi again before the 1/sqrt(d) scale: the effective slope is
    2 m / sqrt(d), which the reference reproduces."""
    if not cfg.alibi:
        return None
    d = cfg.hidden_size // cfg.num_attention_heads
    return (alibi_slopes(cfg.num_attention_heads, resolve_device(device))
            * (2.0 * d ** -0.5))


class FalconForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: FalconConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.word_embeddings = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.h = nn.ModuleList(FalconDecoderLayer(cfg, init)
                               for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                              dtype=cfg.dtype, device=init.device)

    @property
    def device(self) -> torch.device:
        return self.word_embeddings.device

    def forward(self, input_ids):
        cfg, dev = self.cfg, self.device
        d = cfg.hidden_size // cfg.num_attention_heads
        cos = sin = None
        slopes = falcon_alibi_slopes(cfg, dev)
        if not cfg.alibi:
            cos, sin = A.rope_cos_sin(input_ids.shape[1], d,
                                      base=cfg.rope_theta, device=dev)
        x = self.word_embeddings[input_ids]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.h:
            x = (checkpoint(lyr, x, cos, sin, slopes, use_reentrant=False)
                 if remat else lyr(x, cos, sin, slopes))
        return self.ln_f(x) @ self.word_embeddings.T      # tied head

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)


def num_flops_per_token(cfg: FalconConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU), the Llama count's formula: 3 x the
    forward's matmul FLOPs (q, k, v, dense, the 4h MLP, the tied head)
    plus the attention products QK^T and PV."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    kv = cfg.kv_heads * (h // cfg.num_attention_heads)
    per_layer = 2 * h * (h + 2 * kv) + 2 * h * h + 2 * h * 4 * h * 2
    attn = L * 2 * 2 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * v + attn)
