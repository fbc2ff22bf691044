"""Phi-1 / 1.5 / 2 decoder LM — counterpart of ``paddle_tpu/models/phi.py``.

Single-LN parallel block (attention and MLP both read
``input_layernorm(x)`` and sum into one residual), rotate-half rope over
the first ``partial_rotary_factor`` of each head (GPT-NeoX's pairing,
:func:`~paddle_tpu_torch.models.gpt_neox._rope_partial`, K7 on the card),
biased q/k/v/dense, a tanh-GELU MLP and an untied biased head over a
final LayerNorm. Phi-2 runs 32 heads of 80, so its attention is K2 / K5
at head dim 80 on the card.

Same parameter names and ``[in, out]`` layout as the reference (the
fused ``qkv_proj`` is ``[h, (nh + 2 nkv) d]``), so ``models.convert.
load_jax_state_dict`` fills them name for name.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.bloom import causal_lm_loss
from paddle_tpu_torch.models.gpt_neox import _rope_partial
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import attention as A


@dataclass
class PhiConfig:
    """The defaults are ``microsoft/phi-2``'s ``config.json``."""
    vocab_size: int = 51200
    hidden_size: int = 2560
    intermediate_size: int = 10240
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    partial_rotary_factor: float = 0.4
    rope_theta: float = 10000.0
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @staticmethod
    def tiny(**kw):
        return PhiConfig(**{**dict(vocab_size=128, hidden_size=32,
                                   intermediate_size=64,
                                   num_hidden_layers=2,
                                   num_attention_heads=4,
                                   num_key_value_heads=2,
                                   partial_rotary_factor=0.5,
                                   max_position_embeddings=64,
                                   dtype=torch.float32, remat=False), **kw})


class PhiDecoderLayer(nn.Module):
    def __init__(self, cfg: PhiConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        d = h // nh
        self.input_layernorm = LayerNorm(h, epsilon=cfg.layer_norm_eps,
                                         dtype=cfg.dtype, device=init.device)
        self.qkv_proj = init.normal(h, (nh + 2 * nkv) * d)
        self.qkv_bias = init.fill(0.0, (nh + 2 * nkv) * d)
        self.dense = init.normal(h, h)
        self.dense_bias = init.fill(0.0, h)
        self.fc1 = init.normal(h, m)
        self.fc1_bias = init.fill(0.0, m)
        self.fc2 = init.normal(m, h)
        self.fc2_bias = init.fill(0.0, h)
        self.dims = (nh, nkv, d, int(d * cfg.partial_rotary_factor))

    def forward(self, x, cos, sin):
        b, s, hd = x.shape
        nh, nkv, d, rot = self.dims
        h = self.input_layernorm(x)          # ONE LN feeds attn AND mlp
        qkv = h @ self.qkv_proj + self.qkv_bias
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
        q = _rope_partial(q.reshape(b, s, nh, d), cos, sin, rot)
        k = _rope_partial(k.reshape(b, s, nkv, d), cos, sin, rot)
        att = A.scaled_dot_product_attention(q, k, v.reshape(b, s, nkv, d),
                                             is_causal=True)
        att = att.reshape(b, s, hd) @ self.dense + self.dense_bias
        m = F.gelu(h @ self.fc1 + self.fc1_bias, approximate=True)
        return x + att + (m @ self.fc2 + self.fc2_bias)


class PhiForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: PhiConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(PhiDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size,
                                         epsilon=cfg.layer_norm_eps,
                                         dtype=cfg.dtype, device=init.device)
        self.lm_head = init.normal(cfg.hidden_size, cfg.vocab_size)
        self.lm_head_bias = init.fill(0.0, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, input_ids):
        cfg = self.cfg
        d = cfg.hidden_size // cfg.num_attention_heads
        rot = int(d * cfg.partial_rotary_factor)
        cos, sin = A.rope_cos_sin(input_ids.shape[1], rot,
                                  base=cfg.rope_theta, device=self.device)
        x = self.embed_tokens[input_ids]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            x = (checkpoint(lyr, x, cos, sin, use_reentrant=False) if remat
                 else lyr(x, cos, sin))
        return self.final_layernorm(x) @ self.lm_head + self.lm_head_bias

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)


def num_flops_per_token(cfg: PhiConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU): 3 x the forward's matmul FLOPs
    (fused QKV, dense, fc1, fc2, the untied head) plus the attention
    products QK^T and PV."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    d = h // cfg.num_attention_heads
    qkv = h * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * d
    per_layer = 2 * (qkv + h * h) + 2 * h * cfg.intermediate_size * 2
    attn = L * 2 * 2 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * v + attn)
