"""Mistral-7B family — counterpart of ``paddle_tpu/models/mistral.py``.

LLaMA plus a causal sliding window (window 4096, GQA with 8 KV heads,
rope theta 1e6 from v0.2 on). The decoder stack is
:mod:`paddle_tpu_torch.models.llama`'s: the window is a loop bound of the
flash kernel (K2) in prefill and training and of the paged decode kernel
(K4) in serving, where ``serving.LLMEngine`` recycles the blocks that
fall out of it.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                           LlamaForCausalLM, LlamaModel,
                                           num_flops_per_token)


class MistralConfig(LlamaConfig):
    @staticmethod
    def mistral_7b(**kw):
        return MistralConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=32768,
            rope_theta=1e6, sliding_window=4096), **kw})

    @staticmethod
    def tiny(**kw):
        return MistralConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            sliding_window=16, dtype=torch.float32, remat=False), **kw})


class MistralModel(LlamaModel):
    pass


class MistralForCausalLM(LlamaForCausalLM):
    pass
