"""OPT decoder LM — counterpart of ``paddle_tpu/models/opt.py``.

The learned-position member of the zoo: no rotary and no ALiBi;
positions come from a trained table read at ``position + 2`` (HF's
offset, inherited from fairseq's padding index). HF ``OPTModel``'s
architecture: word embeddings (projected in and out when
``word_embed_proj_dim != hidden_size``, the 350m shape), blocks of
[LayerNorm -> attention -> LayerNorm -> fc1 relu fc2], pre-norm when
``do_layer_norm_before`` (every size but 350m) and post-norm otherwise,
a final LayerNorm (pre-norm only), and the head tied to the word
embeddings. Attention goes through
``ops.attention.scaled_dot_product_attention`` (K2 / K5 on the card).

Same parameter names and ``[in, out]`` layout as the reference; the
projections and the final LayerNorm a config leaves out are ``None``
there and are not parameters here, so ``models.convert.
load_jax_state_dict`` neither expects nor invents them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.bloom import causal_lm_loss
from paddle_tpu_torch.models.gpt_neox import _layer_norm
from paddle_tpu_torch.models.llama import _Init
from paddle_tpu_torch.ops import attention as A


@dataclass
class OPTConfig:
    """The defaults are the reference's (OPT-125m's widths)."""
    vocab_size: int = 50272
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    do_layer_norm_before: bool = True
    word_embed_proj_dim: int | None = None   # != hidden_size only for 350m
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    def __post_init__(self):
        if self.word_embed_proj_dim is None:
            self.word_embed_proj_dim = self.hidden_size

    @staticmethod
    def tiny(**kw):
        return OPTConfig(**{**dict(vocab_size=128, hidden_size=32,
                                   ffn_dim=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=64,
                                   dtype=torch.float32, remat=False), **kw})


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg: OPTConfig, init: _Init):
        super().__init__()
        h, f = cfg.hidden_size, cfg.ffn_dim
        self.self_attn_layer_norm = _layer_norm(cfg, init)
        self.q_proj = init.normal(h, h)
        self.k_proj = init.normal(h, h)
        self.v_proj = init.normal(h, h)
        self.out_proj = init.normal(h, h)
        self.q_bias = init.fill(0.0, h)
        self.k_bias = init.fill(0.0, h)
        self.v_bias = init.fill(0.0, h)
        self.out_bias = init.fill(0.0, h)
        self.final_layer_norm = _layer_norm(cfg, init)
        self.fc1 = init.normal(h, f)
        self.fc1_bias = init.fill(0.0, f)
        self.fc2 = init.normal(f, h)
        self.fc2_bias = init.fill(0.0, h)
        self.n_head = cfg.num_attention_heads
        self.pre_norm = cfg.do_layer_norm_before

    def forward(self, x):
        b, s, hd = x.shape
        nh = self.n_head
        d = hd // nh
        h = self.self_attn_layer_norm(x) if self.pre_norm else x
        q = (h @ self.q_proj + self.q_bias).reshape(b, s, nh, d)
        k = (h @ self.k_proj + self.k_bias).reshape(b, s, nh, d)
        v = (h @ self.v_proj + self.v_bias).reshape(b, s, nh, d)
        att = A.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + att.reshape(b, s, hd) @ self.out_proj + self.out_bias
        if not self.pre_norm:
            x = self.self_attn_layer_norm(x)
        h2 = self.final_layer_norm(x) if self.pre_norm else x
        m = torch.relu(h2 @ self.fc1 + self.fc1_bias)
        x = x + m @ self.fc2 + self.fc2_bias
        if not self.pre_norm:
            x = self.final_layer_norm(x)
        return x


class OPTForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: OPTConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        e, h = cfg.word_embed_proj_dim, cfg.hidden_size
        self.embed_tokens = init.normal(cfg.vocab_size, e)
        # HF's offset: row p + 2 holds position p
        self.embed_positions = init.normal(cfg.max_position_embeddings + 2, h)
        self.project_in = None if e == h else init.normal(e, h)
        self.project_out = None if e == h else init.normal(h, e)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = (_layer_norm(cfg, init)
                                 if cfg.do_layer_norm_before else None)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, input_ids):
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embed_tokens[input_ids]
        if self.project_in is not None:
            x = x @ self.project_in
        x = x + self.embed_positions[2:s + 2]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            x = (checkpoint(lyr, x, use_reentrant=False) if remat
                 else lyr(x))
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        if self.project_out is not None:
            x = x @ self.project_out
        return x @ self.embed_tokens.T              # tied head

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)

