"""MoE decoder LM — counterpart of ``paddle_tpu/models/moe_llm.py`` (the
ERNIE-MoE-class family).

A LLaMA-style decoder whose MLP is a top-k ``MoELayer`` every
``moe_every``-th layer, with a capacity factor (1.25 by default: routing
choices past an expert's capacity are dropped). The gate aux loss is
summed into the LM loss. The Llama fields live in ``cfg.base``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed.moe import MoELayer
from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaDecoderLayer, LlamaRMSNorm,
                                           _Init)
from paddle_tpu_torch.nn.functional import (masked_mean,
                                             parallel_cross_entropy)
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.quantization import wo_matmul


@dataclass
class MoEConfig:
    base: LlamaConfig = None
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2          # every k-th layer is MoE
    aux_loss_weight: float = 0.01

    @staticmethod
    def tiny(**kw):
        return MoEConfig(base=LlamaConfig.tiny(), **kw)


class MoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MoEConfig, init: _Init):
        super().__init__()
        b = cfg.base
        self.input_layernorm = LlamaRMSNorm(b.hidden_size, b.rms_norm_eps,
                                            init)
        self.self_attn = LlamaAttention(b, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            b.hidden_size, b.rms_norm_eps, init)
        self.moe = MoELayer(b.hidden_size, b.intermediate_size,
                            cfg.num_experts, k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor, init=init)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        y, aux = self.moe(self.post_attention_layernorm(x))
        return x + y, aux


class MoEForCausalLM(nn.Module):
    """``forward`` returns ``(logits, aux_total)``, as the reference's
    ``__call__`` does. ``device``: ``None`` means the card (raises without
    one); tests pass ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: MoEConfig, device=None, seed: int = 0):
        super().__init__()
        b = cfg.base
        init = _Init(b, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(b.vocab_size, b.hidden_size)
        self.layers = nn.ModuleList(
            MoEDecoderLayer(cfg, init) if (i + 1) % cfg.moe_every == 0
            else LlamaDecoderLayer(b, init)
            for i in range(b.num_hidden_layers))
        self.norm = LlamaRMSNorm(b.hidden_size, b.rms_norm_eps, init)
        self.lm_head = init.normal(b.hidden_size, b.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def forward(self, input_ids):
        b = self.cfg.base
        x = self.embed_tokens[input_ids]
        cos, sin = A.rope_cos_sin(input_ids.shape[1],
                                  b.hidden_size // b.num_attention_heads,
                                  base=b.rope_theta, device=self.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for lyr in self.layers:
            if isinstance(lyr, MoEDecoderLayer):
                x, aux = lyr(x, cos, sin)
                aux_total = aux_total + aux
            else:
                x = lyr(x, cos, sin)
        return wo_matmul(self.norm(x), self.lm_head), aux_total

    def loss(self, input_ids, labels):
        logits, aux = self(input_ids)
        per_tok = parallel_cross_entropy(logits, torch.clamp(labels, min=0))
        lm = masked_mean(per_tok, (labels >= 0).float())
        return lm + self.cfg.aux_loss_weight * aux
