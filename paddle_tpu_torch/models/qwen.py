"""Qwen2 family — counterpart of ``paddle_tpu/models/qwen.py``.

LLaMA plus a bias on the fused q/k/v projection (``attention_bias``),
GQA, rope theta 1e6 and tied embeddings on the small variants; the
decoder stack is :mod:`paddle_tpu_torch.models.llama`'s.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.models.llama import (LlamaConfig,  # noqa: F401
                                           LlamaForCausalLM, LlamaModel,
                                           num_flops_per_token)


class Qwen2Config(LlamaConfig):
    @staticmethod
    def qwen2_7b(**kw):
        return Qwen2Config(**{**dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28,
            num_key_value_heads=4, max_position_embeddings=32768,
            rope_theta=1e6, attention_bias=True), **kw})

    @staticmethod
    def qwen2_0_5b(**kw):
        return Qwen2Config(**{**dict(
            vocab_size=151936, hidden_size=896, intermediate_size=4864,
            num_hidden_layers=24, num_attention_heads=14,
            num_key_value_heads=2, max_position_embeddings=32768,
            rope_theta=1e6, attention_bias=True,
            tie_word_embeddings=True), **kw})

    @staticmethod
    def tiny(**kw):
        return Qwen2Config(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            attention_bias=True, tie_word_embeddings=True,
            dtype=torch.float32, remat=False), **kw})


class Qwen2Model(LlamaModel):
    pass


class Qwen2ForCausalLM(LlamaForCausalLM):
    pass
