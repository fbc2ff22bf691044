"""GPT-J and CodeGen decoder LMs — counterpart of
``paddle_tpu/models/gptj.py``.

The interleaved-rotary member of the zoo: rope pairs are the even/odd
lanes ``(x[2i], x[2i+1])`` over the first ``rotary_dim`` dims
(``ops.attention.apply_rope_interleaved``, plain PyTorch as in the
reference: K7 rotates halves, not pairs), attention and MLP read the same
LayerNorm output and sum into one residual (single-LN parallel block),
q/k/v/out carry no bias, ``fc_in`` / ``fc_out`` do, and the LM head is a
separate biased linear (untied). GPT-J-6B runs 16 heads of 256, so its
attention is K2/K5 at head dim 256 on the card. CodeGen is the GPT-J block
(its checkpoint's fused, TPU-core-grouped QKV is unpacked by a loader).

Same parameter names and ``[in, out]`` layout as the reference, so
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
class GPTJConfig:
    """The defaults are ``EleutherAI/gpt-j-6b``'s ``config.json``."""
    vocab_size: int = 50400
    n_embd: int = 4096
    n_layer: int = 28
    n_head: int = 16
    rotary_dim: int = 64
    n_inner: int | None = None             # default 4 * n_embd
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    def __post_init__(self):
        if self.n_inner is None:
            self.n_inner = 4 * self.n_embd

    @staticmethod
    def tiny(**kw):
        return GPTJConfig(**{**dict(vocab_size=128, n_embd=32, n_layer=2,
                                    n_head=4, rotary_dim=4,
                                    dtype=torch.float32, remat=False),
                             **kw})


class GPTJBlock(nn.Module):
    def __init__(self, cfg: GPTJConfig, init: _Init):
        super().__init__()
        h = cfg.n_embd
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_epsilon,
                              dtype=cfg.dtype, device=init.device)
        self.q_proj = init.normal(h, h)          # no biases (GPT-J)
        self.k_proj = init.normal(h, h)
        self.v_proj = init.normal(h, h)
        self.out_proj = init.normal(h, h)
        self.fc_in = init.normal(h, cfg.n_inner)
        self.fc_in_bias = init.fill(0.0, cfg.n_inner)
        self.fc_out = init.normal(cfg.n_inner, h)
        self.fc_out_bias = init.fill(0.0, h)
        self.n_head, self.rotary_dim = cfg.n_head, cfg.rotary_dim

    def forward(self, x, cos, sin):
        b, s, hd = x.shape
        nh, rot = self.n_head, self.rotary_dim
        d = hd // nh
        h = self.ln_1(x)                        # ONE LN feeds attn AND mlp

        def rope(t):
            r = A.apply_rope_interleaved(t[..., :rot], cos, sin)
            return torch.cat([r, t[..., rot:]], dim=-1)
        q = rope((h @ self.q_proj).reshape(b, s, nh, d))
        k = rope((h @ self.k_proj).reshape(b, s, nh, d))
        v = (h @ self.v_proj).reshape(b, s, nh, d)
        att = A.scaled_dot_product_attention(q, k, v, is_causal=True)
        att = att.reshape(b, s, hd) @ self.out_proj
        m = F.gelu(h @ self.fc_in + self.fc_in_bias, approximate=True)
        return x + att + (m @ self.fc_out + self.fc_out_bias)


class GPTJForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: GPTJConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.wte = init.normal(cfg.vocab_size, cfg.n_embd)
        self.h = nn.ModuleList(GPTJBlock(cfg, init)
                               for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, epsilon=cfg.layer_norm_epsilon,
                              dtype=cfg.dtype, device=init.device)
        self.lm_head = init.normal(cfg.n_embd, cfg.vocab_size)
        self.lm_head_bias = init.fill(0.0, cfg.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def forward(self, input_ids):
        cfg = self.cfg
        cos, sin = A.rope_cos_sin(input_ids.shape[1], cfg.rotary_dim,
                                  device=self.device)
        x = self.wte[input_ids]
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.h:
            x = (checkpoint(lyr, x, cos, sin, use_reentrant=False)
                 if remat else lyr(x, cos, sin))
        return self.ln_f(x) @ self.lm_head + self.lm_head_bias

    def loss(self, input_ids, labels):
        """Causal LM loss, labels = ids shifted by one; label < 0 ignored."""
        return causal_lm_loss(self(input_ids), labels)


@dataclass
class CodeGenConfig(GPTJConfig):
    """CodeGen (PaddleNLP ``codegen``): the GPT-J block; its checkpoint's
    fused QKV (mp_num = 4 groups, split order q, v, k) is unpacked to
    separate projections at load."""
    vocab_size: int = 50400

    @staticmethod
    def tiny(**kw):
        return CodeGenConfig(**{**dict(vocab_size=128, n_embd=32, n_layer=2,
                                       n_head=4, rotary_dim=4,
                                       dtype=torch.float32, remat=False),
                                **kw})


class CodeGenForCausalLM(GPTJForCausalLM):
    pass


def num_flops_per_token(cfg: GPTJConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU), the Llama count's formula: 3 x the
    forward's matmul FLOPs (q, k, v, out, fc_in, fc_out, the untied head)
    plus the attention products QK^T and PV."""
    h, L, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    per_layer = 2 * h * 4 * h + 2 * h * cfg.n_inner * 2
    attn = L * 2 * 2 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * v + attn)
