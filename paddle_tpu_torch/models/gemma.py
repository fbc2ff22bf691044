"""Gemma decoder LM — counterpart of ``paddle_tpu/models/gemma.py``.

The zero-centred-norm member of the zoo, with three departures from the
Llama recipe that make it no config of ``LlamaForCausalLM``:
  * RMSNorm multiplies by ``1 + weight`` (weights stored zero-centred, in
    plain PyTorch here as in the reference, which does not call its
    Pallas ``rms_norm`` for it);
  * ``head_dim`` is decoupled from ``hidden_size / num_heads`` (gemma-7b:
    16 heads x 256 dims on a 3072 hidden; gemma-2b: 8 heads x 256 over one
    KV head on 2048) — q/k/v project h -> nh*hd and o projects nh*hd -> h;
  * embeddings are scaled by ``sqrt(hidden_size)`` at the input (the scale
    cast to the activations' dtype first) and the MLP is tanh-gelu; the
    head is tied to the embeddings.

Rotary goes through ``ops.attention.apply_rope`` (K7 on the card),
attention through ``scaled_dot_product_attention`` (K2/K5 at head dim
256). Same parameter names and ``[in, out]`` layout as the reference, so
``models.convert.load_jax_state_dict`` fills them name for name.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.bloom import causal_lm_loss
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as A


@dataclass
class GemmaConfig:
    """The defaults are ``google/gemma-7b``'s ``config.json``."""
    vocab_size: int = 256000
    hidden_size: int = 3072
    intermediate_size: int = 24576
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 256
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @staticmethod
    def tiny(**kw):
        return GemmaConfig(**{**dict(vocab_size=128, hidden_size=32,
                                     intermediate_size=64,
                                     num_hidden_layers=2,
                                     num_attention_heads=4,
                                     num_key_value_heads=2, head_dim=16,
                                     max_position_embeddings=64,
                                     dtype=torch.float32, remat=False),
                              **kw})


class GemmaRMSNorm(nn.Module):
    """RMSNorm with a zero-centred weight: y = norm(x) * (1 + w), fp32
    math and one cast back to x's dtype."""

    def __init__(self, size, eps, init: _Init):
        super().__init__()
        self.weight = init.fill(0.0, size)
        self.eps = eps

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + self.eps)
        return (h * (1.0 + self.weight.float())).to(x.dtype)


class GemmaDecoderLayer(nn.Module):
    def __init__(self, cfg: GemmaConfig, init: _Init):
        super().__init__()
        h, hd = cfg.hidden_size, cfg.head_dim
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        self.input_layernorm = GemmaRMSNorm(h, cfg.rms_norm_eps, init)
        self.qkv_proj = init.normal(h, (nh + 2 * nkv) * hd)
        self.o_proj = init.normal(nh * hd, h)
        self.post_attention_layernorm = GemmaRMSNorm(h, cfg.rms_norm_eps,
                                                     init)
        self.gate_up_proj = init.normal(h, 2 * cfg.intermediate_size)
        self.down_proj = init.normal(cfg.intermediate_size, h)
        self.dims = (nh, nkv, hd)

    def forward(self, x, cos, sin):
        b, s, _ = x.shape
        nh, nkv, hd = self.dims
        qkv = self.input_layernorm(x) @ self.qkv_proj
        q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
        q = A.apply_rope(q.reshape(b, s, nh, hd), cos, sin)
        k = A.apply_rope(k.reshape(b, s, nkv, hd), cos, sin)
        att = A.scaled_dot_product_attention(q, k, v.reshape(b, s, nkv, hd),
                                             is_causal=True)
        x = x + att.reshape(b, s, nh * hd) @ self.o_proj
        gate, up = torch.chunk(self.post_attention_layernorm(x)
                               @ self.gate_up_proj, 2, dim=-1)
        return x + (F.gelu(gate, approximate=True) * up) @ self.down_proj


class GemmaForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: GemmaConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GemmaDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = GemmaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, init)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, input_ids):
        cfg, dev = self.cfg, self.device
        cos, sin = A.rope_cos_sin(input_ids.shape[1], cfg.head_dim,
                                  base=cfg.rope_theta, device=dev)
        x = self.embed_tokens[input_ids]
        # the scale in the activations' dtype first (bf16: sqrt(3072) =
        # 55.43 becomes 55.5), as the reference casts it
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype,
                             device=dev)
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            x = (checkpoint(lyr, x, cos, sin, use_reentrant=False)
                 if remat else lyr(x, cos, sin))
        return self.norm(x) @ self.embed_tokens.T        # tied head

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)


def num_flops_per_token(cfg: GemmaConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU), the Llama count's formula: 3 x the
    forward's matmul FLOPs (fused qkv, o, the gate/up and down products,
    the tied head) plus the attention products QK^T and PV over the
    nh * head_dim width."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim)
    inter = cfg.intermediate_size
    per_layer = (2 * h * (nh + 2 * nkv) * hd + 2 * nh * hd * h
                 + 2 * h * 2 * inter + 2 * inter * h)
    attn = L * 2 * 2 * seq_len * nh * hd
    return 3.0 * (L * per_layer + 2 * h * v + attn)
