"""GPT-NeoX decoder LM (Pythia) — counterpart of
``paddle_tpu/models/gpt_neox.py``.

The partial-rotary, parallel-residual member of the zoo: rope covers the
first ``rotary_pct`` of each head's dims (Pythia: 25%) through
``ops.attention.apply_rope`` (K7 on the card) and the rest passes through
(:func:`_rope_partial`); with ``use_parallel_residual`` attention and MLP
both read the block input through their own LayerNorms and are summed
with the residual in one add (the sequential form for the other
configs); the head ``embed_out`` is untied. Attention goes through
``ops.attention.scaled_dot_product_attention`` (K2 / K5 on the card).

Same parameter names and ``[in, out]`` layout as the reference (the
fused ``qkv`` is ``[h, 3h]`` with columns ``[q all heads | k | v]``; the
HF loader re-lays HF's head-interleaved fused QKV), so
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
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import attention as A


@dataclass
class GPTNeoXConfig:
    """The defaults are the reference's (Pythia-160m's widths); the
    vocabulary is Pythia's 50 432."""
    vocab_size: int = 50432
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    rotary_pct: float = 0.25
    rotary_emb_base: float = 10000.0
    max_position_embeddings: int = 2048
    use_parallel_residual: bool = True
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @staticmethod
    def tiny(**kw):
        return GPTNeoXConfig(**{**dict(vocab_size=128, hidden_size=32,
                                       num_hidden_layers=2,
                                       num_attention_heads=4,
                                       intermediate_size=64,
                                       max_position_embeddings=64,
                                       dtype=torch.float32, remat=False),
                                **kw})


def _rope_partial(x, cos, sin, rot_dims):
    """Rotate-half rope of the first ``rot_dims`` of each head (K7 on the
    card: the slice is copied to a contiguous buffer first, its rows being
    ``D`` apart); the tail passes through."""
    rot, rest = x[..., :rot_dims], x[..., rot_dims:]
    return torch.cat([A.apply_rope(rot, cos, sin), rest], dim=-1)


def _layer_norm(cfg, init):
    return LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                     dtype=cfg.dtype, device=init.device)


class GPTNeoXLayer(nn.Module):
    def __init__(self, cfg: GPTNeoXConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.input_layernorm = _layer_norm(cfg, init)
        self.post_attention_layernorm = _layer_norm(cfg, init)
        # [h, 3h]: columns [q all heads | k | v]
        self.qkv = init.normal(h, 3 * h)
        self.qkv_bias = init.fill(0.0, 3 * h)
        self.dense = init.normal(h, h)
        self.dense_bias = init.fill(0.0, h)
        self.h_to_4h = init.normal(h, m)
        self.h_to_4h_bias = init.fill(0.0, m)
        self.four_h_to_h = init.normal(m, h)
        self.four_h_to_h_bias = init.fill(0.0, h)
        self.n_head = cfg.num_attention_heads
        self.parallel = cfg.use_parallel_residual

    def _attn(self, h, cos, sin, rot_dims):
        b, s, hd = h.shape
        nh = self.n_head
        d = hd // nh
        q, k, v = torch.chunk(h @ self.qkv + self.qkv_bias, 3, dim=-1)
        q = _rope_partial(q.reshape(b, s, nh, d), cos, sin, rot_dims)
        k = _rope_partial(k.reshape(b, s, nh, d), cos, sin, rot_dims)
        att = A.scaled_dot_product_attention(q, k, v.reshape(b, s, nh, d),
                                             is_causal=True)
        return att.reshape(b, s, hd) @ self.dense + self.dense_bias

    def _mlp(self, h):
        m = F.gelu(h @ self.h_to_4h + self.h_to_4h_bias, approximate=False)
        return m @ self.four_h_to_h + self.four_h_to_h_bias

    def forward(self, x, cos, sin, rot_dims):
        att = self._attn(self.input_layernorm(x), cos, sin, rot_dims)
        if self.parallel:
            return x + att + self._mlp(self.post_attention_layernorm(x))
        x = x + att
        return x + self._mlp(self.post_attention_layernorm(x))


class GPTNeoXForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: GPTNeoXConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_in = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(GPTNeoXLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = _layer_norm(cfg, init)
        self.embed_out = init.normal(cfg.hidden_size, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed_in.device

    def forward(self, input_ids):
        cfg = self.cfg
        d = cfg.hidden_size // cfg.num_attention_heads
        rot = int(d * cfg.rotary_pct)
        cos, sin = A.rope_cos_sin(input_ids.shape[1], rot,
                                  base=cfg.rotary_emb_base,
                                  device=self.device)
        x = self.embed_in[input_ids]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            x = (checkpoint(lyr, x, cos, sin, rot, use_reentrant=False)
                 if remat else lyr(x, cos, sin, rot))
        return self.final_layer_norm(x) @ self.embed_out

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)

