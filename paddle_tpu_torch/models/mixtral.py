"""Mixtral — counterpart of ``paddle_tpu/models/mixtral.py``
(Mixtral-8x7B-class sparse MoE).

LLaMA attention (GQA, optional sliding window, no biases) with every MLP
a routed-expert block: softmax -> top-k -> RENORMALISED gates (unlike
Qwen2-MoE's raw mass), no shared expert, on ``distributed.moe.MoELayer``
in dropless mode. The parameters hang directly off the LM
(``embed_tokens``, ``layers.N...``, ``norm``, ``lm_head``) under the
reference's names, so ``load_jax_state_dict`` is a name-for-name copy.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed.moe import MoELayer
from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaRMSNorm, _Init)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.quantization import wo_matmul


@dataclass
class MixtralConfig(LlamaConfig):
    rms_norm_eps: float = 1e-5
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02

    @staticmethod
    def tiny(**kw):
        return MixtralConfig(**{**dict(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            num_local_experts=4, num_experts_per_tok=2,
            dtype=torch.float32, remat=False), **kw})


def masked_lm_loss(logits, labels):
    """Mean cross entropy over the positions with ``labels >= 0`` (the
    ignore index is -100), in fp32."""
    ce = F.cross_entropy(logits.float(), torch.clamp(labels, min=0),
                         reduction="none")
    mask = (labels >= 0).float()
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def rope_tables(cfg, seq_len, device):
    return A.rope_cos_sin(
        seq_len, cfg.hidden_size // cfg.num_attention_heads,
        base=cfg.rope_theta, scaling=cfg.rope_scaling,
        max_position_embeddings=cfg.max_position_embeddings, device=device)


class MixtralDecoderLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig, init: _Init):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                            cfg.rms_norm_eps, init)
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, init)
        self.moe = MoELayer(cfg.hidden_size, cfg.intermediate_size,
                            cfg.num_local_experts,
                            k=cfg.num_experts_per_tok,
                            capacity_factor=None,      # dropless (exact)
                            norm_topk_prob=True,       # Mixtral renorms
                            init=init)

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        y, aux = self.moe(self.post_attention_layernorm(x))
        return x + y, aux


class MixtralForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: MixtralConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MixtralDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, init)
        self.lm_head = init.normal(cfg.hidden_size, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def _forward(self, input_ids):
        cos, sin = rope_tables(self.cfg, input_ids.shape[1], self.device)
        x = self.embed_tokens[input_ids]
        aux_total = 0.0
        for lyr in self.layers:
            x, aux = lyr(x, cos, sin)
            aux_total = aux_total + aux
        return wo_matmul(self.norm(x), self.lm_head), aux_total

    def forward(self, input_ids):
        return self._forward(input_ids)[0]

    def loss(self, input_ids, labels):
        logits, aux = self._forward(input_ids)
        return (masked_lm_loss(logits, labels)
                + self.cfg.router_aux_loss_coef * aux)
