"""GLM-4 decoder LM (the ChatGLM lineage, HF ``GlmForCausalLM``) —
counterpart of ``paddle_tpu/models/glm.py``.

GLM rotates the first ``partial_rotary_factor`` of each head with
GPT-J-style INTERLEAVED even/odd pairs (its ``rotate_half`` interleaves
despite the name): ``ops.attention.apply_rope_interleaved``, plain
PyTorch as the reference's is plain ``jnp`` (K7 rotates halves, not
pairs). Attention carries q/k/v biases (no o bias) and GQA (GLM-4-9B:
32 query heads over 2 KV heads, through K2 / K5 by index), the MLP is a
fused gate_up SwiGLU, the head is untied. The norms
(:class:`GlmRMSNorm`) compute exactly K1's function — an fp32 mean of
squares, the weight in fp32, one cast — so they go through
``ops.fused_rms_norm`` (K1 on the card).

Same parameter names and ``[in, out]`` layout as the reference, so
``models.convert.load_jax_state_dict`` fills them name for name; with
``attention_bias=False`` there is no ``qkv_bias`` parameter, as the
reference's is ``None``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.bloom import causal_lm_loss
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops import fused_rms_norm


@dataclass
class GlmConfig:
    """The defaults are GLM-4-9B's (``THUDM/glm-4-9b``'s HF config)."""
    vocab_size: int = 151552
    hidden_size: int = 4096
    intermediate_size: int = 13696
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    partial_rotary_factor: float = 0.5
    max_position_embeddings: int = 131072
    rms_norm_eps: float = 1.5625e-07
    rope_theta: float = 10000.0
    attention_bias: bool = True
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @staticmethod
    def tiny(**kw):
        return GlmConfig(**{**dict(vocab_size=128, hidden_size=32,
                                   intermediate_size=64,
                                   num_hidden_layers=2,
                                   num_attention_heads=4,
                                   num_key_value_heads=2,
                                   max_position_embeddings=64,
                                   rms_norm_eps=1e-6,
                                   dtype=torch.float32, remat=False), **kw})


class GlmRMSNorm(nn.Module):
    """The reference's norm: x in fp32, times rsqrt(mean(x^2) + eps), times
    the weight in fp32, one cast to x's type — K1's function
    (``ops.fused_rms_norm``)."""

    def __init__(self, size, eps, init: _Init):
        super().__init__()
        self.weight = init.fill(1.0, size)
        self.eps = eps

    def forward(self, x):
        return fused_rms_norm(x, self.weight, self.eps)


class GlmDecoderLayer(nn.Module):
    def __init__(self, cfg: GlmConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
        d = h // nh
        self.input_layernorm = GlmRMSNorm(h, cfg.rms_norm_eps, init)
        self.qkv_proj = init.normal(h, (nh + 2 * nkv) * d)
        self.qkv_bias = (init.fill(0.0, (nh + 2 * nkv) * d)
                         if cfg.attention_bias else None)
        self.o_proj = init.normal(h, h)
        self.post_attention_layernorm = GlmRMSNorm(h, cfg.rms_norm_eps, init)
        self.gate_up_proj = init.normal(h, 2 * m)
        self.down_proj = init.normal(m, h)
        self.dims = (nh, nkv, d, int(d * cfg.partial_rotary_factor))

    def forward(self, x, cos, sin):
        b, s, hd = x.shape
        nh, nkv, d, rd = self.dims
        qkv = self.input_layernorm(x) @ self.qkv_proj
        if self.qkv_bias is not None:
            qkv = qkv + self.qkv_bias
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)

        def rope(t, n):
            t = t.reshape(b, s, n, d)
            return torch.cat([A.apply_rope_interleaved(t[..., :rd], cos, sin),
                              t[..., rd:]], dim=-1)

        att = A.scaled_dot_product_attention(rope(q, nh), rope(k, nkv),
                                             v.reshape(b, s, nkv, d),
                                             is_causal=True)
        x = x + att.reshape(b, s, hd) @ self.o_proj
        gate, up = torch.chunk(self.post_attention_layernorm(x)
                               @ self.gate_up_proj, 2, dim=-1)
        return x + (up * torch.nn.functional.silu(gate)) @ self.down_proj


class GlmForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: GlmConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GlmDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = GlmRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, init)
        self.lm_head = init.normal(cfg.hidden_size, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, input_ids):
        cfg = self.cfg
        d = cfg.hidden_size // cfg.num_attention_heads
        rd = int(d * cfg.partial_rotary_factor)
        cos, sin = A.rope_cos_sin(input_ids.shape[1], rd,
                                  base=cfg.rope_theta, device=self.device)
        x = self.embed_tokens[input_ids]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            x = (checkpoint(lyr, x, cos, sin, use_reentrant=False) if remat
                 else lyr(x, cos, sin))
        return self.norm(x) @ self.lm_head

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)

