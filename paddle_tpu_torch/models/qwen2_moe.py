"""Qwen2-MoE — counterpart of ``paddle_tpu/models/qwen2_moe.py`` (the
Qwen1.5/2-MoE-A2.7B family).

Qwen2 attention (biased fused QKV, GQA, rope 1e6) with every MLP replaced
by a sparse block = sort-based top-k routed experts
(``distributed.moe.MoELayer`` in dropless ``capacity_factor=None`` mode,
``norm_topk_prob`` per config — Qwen defaults to NOT renormalising the
top-k mass) PLUS a dense shared expert scaled by a per-token sigmoid gate.
``decoder_sparse_step`` and ``mlp_only_layers`` choose which layers are
sparse; the others carry a dense ``LlamaMLP``. Parameter names are the
reference's, so ``load_jax_state_dict`` is a name-for-name copy.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed.moe import MoELayer
from paddle_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                           LlamaMLP, LlamaRMSNorm, _Init)
from paddle_tpu_torch.models.mixtral import masked_lm_loss, rope_tables
from paddle_tpu_torch.quantization import wo_matmul


@dataclass
class Qwen2MoeConfig(LlamaConfig):
    rms_norm_eps: float = 1e-6           # Qwen2-MoE convention (not 1e-5)
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    norm_topk_prob: bool = False
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple = ()
    router_aux_loss_coef: float = 0.001

    @staticmethod
    def tiny(**kw):
        return Qwen2MoeConfig(**{**dict(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            attention_bias=True, num_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=16, shared_expert_intermediate_size=48,
            dtype=torch.float32, remat=False), **kw})


class Qwen2MoeSparseBlock(nn.Module):
    """Routed experts + sigmoid-gated shared expert (HF
    Qwen2MoeSparseMoeBlock)."""

    def __init__(self, cfg: Qwen2MoeConfig, init: _Init):
        super().__init__()
        h = cfg.hidden_size
        self.moe = MoELayer(h, cfg.moe_intermediate_size, cfg.num_experts,
                            k=cfg.num_experts_per_tok,
                            capacity_factor=None,      # dropless (exact)
                            norm_topk_prob=cfg.norm_topk_prob, init=init)
        self.shared_gate_up = init.normal(
            h, 2 * cfg.shared_expert_intermediate_size)
        self.shared_down = init.normal(cfg.shared_expert_intermediate_size, h)
        self.shared_gate = init.normal(h, 1)

    def forward(self, x):
        y, aux = self.moe(x)
        gate, up = torch.chunk(x @ self.shared_gate_up, 2, dim=-1)
        shared = (torch.nn.functional.silu(gate) * up) @ self.shared_down
        sg = torch.sigmoid(x @ self.shared_gate)
        return y + sg * shared, aux


class Qwen2MoeDecoderLayer(nn.Module):
    def __init__(self, cfg: Qwen2MoeConfig, layer_idx: int, init: _Init):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size,
                                            cfg.rms_norm_eps, init)
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, init)
        sparse = (layer_idx not in tuple(cfg.mlp_only_layers)
                  and cfg.num_experts > 0
                  and (layer_idx + 1) % cfg.decoder_sparse_step == 0)
        self.mlp = (Qwen2MoeSparseBlock(cfg, init) if sparse
                    else LlamaMLP(cfg, init))
        self.sparse = sparse

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        h = self.post_attention_layernorm(x)
        if self.sparse:
            y, aux = self.mlp(h)
        else:
            y, aux = self.mlp(h), 0.0
        return x + y, aux


class Qwen2MoeForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: Qwen2MoeConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            Qwen2MoeDecoderLayer(cfg, i, init)
            for i in range(cfg.num_hidden_layers))
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
