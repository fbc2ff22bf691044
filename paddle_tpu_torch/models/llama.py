"""LLaMA-2 family — counterpart of ``paddle_tpu/models/llama.py``.

Same parameter names and the reference's ``[in, out]`` weight layout:
the fused ``self_attn.qkv_proj`` is ``[h, (nh + 2*nkv)*d]`` and the fused
``mlp.gate_up_proj`` ``[h, 2*m]``, both applied as ``x @ W``, so
:func:`paddle_tpu_torch.models.convert.load_jax_state_dict` loads a
reference model's ``state_dict()`` with no per-model table. Norms go
through ``ops.fused_rms_norm`` (K1 on the card) and attention through
``ops.attention.scaled_dot_product_attention`` (K2 forward and K5
backward on the card).

The parameters are trainable: :meth:`LlamaForCausalLM.loss` is what the
train step differentiates (``train.step.make_train_step``). ``remat``
recomputes each decoder layer in the backward pass
(``torch.utils.checkpoint``, the counterpart of the per-layer
``jax.checkpoint``); of the reference's selective ``remat_policy`` modes
only ``None``/``"full"`` are ported. fp8, scanned layers and sequence
parallelism are later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.nn.functional import parallel_cross_entropy
from paddle_tpu_torch.ops import fused_rms_norm
from paddle_tpu_torch.quantization import wo_matmul

# remat_policy modes of the reference that save named activations; the
# port recomputes the whole layer ("full") or nothing
_SELECTIVE_REMAT = ("hidden", "no_ffn", "dots")


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # None/"full": recompute the whole layer in backward; the selective
    # modes "hidden", "no_ffn", "dots" raise (ROADMAP.md queue 1 item 4)
    remat_policy: str | None = None
    sliding_window: int | None = None  # Mistral-style causal window
    attention_bias: bool = False       # Qwen2: bias on fused qkv only
    rope_scaling: dict | None = None   # linear | ntk | dynamic

    def __post_init__(self):
        if self.remat_policy in _SELECTIVE_REMAT:
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} (selective remat) is "
                f"not ported yet (ROADMAP.md queue 1 item 4, remat "
                f"policies); use None or 'full'")
        if self.remat_policy not in (None, "full"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected one "
                f"of {sorted(_SELECTIVE_REMAT + ('full',))} or None")

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**{**dict(hidden_size=4096, intermediate_size=11008,
                                     num_hidden_layers=32,
                                     num_attention_heads=32), **kw})

    @staticmethod
    def tiny(**kw):
        return LlamaConfig(**{**dict(vocab_size=256, hidden_size=64,
                                     intermediate_size=128,
                                     num_hidden_layers=2,
                                     num_attention_heads=4,
                                     num_key_value_heads=2,
                                     max_position_embeddings=128,
                                     dtype=torch.float32, remat=False),
                              **kw})


class _Init:
    """Normal(0, std) parameters drawn on the target device from one
    seeded generator (random weights; a real checkpoint goes through
    ``models.convert``)."""

    def __init__(self, cfg, device, seed):
        self.cfg, self.device = cfg, device
        self.gen = generator(seed, device)

    def normal(self, *shape, dtype=None):
        w = torch.empty(shape, dtype=dtype or self.cfg.dtype,
                        device=self.device)
        w.normal_(0.0, self.cfg.initializer_range, generator=self.gen)
        return nn.Parameter(w)

    def fill(self, value, *shape):
        return nn.Parameter(torch.full(shape, value, dtype=self.cfg.dtype,
                                       device=self.device))


class LlamaRMSNorm(nn.Module):
    def __init__(self, size, eps, init: _Init):
        super().__init__()
        self.weight = init.fill(1.0, size)
        self.eps = eps

    def forward(self, x):
        return fused_rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        h, nh, nkv = (cfg.hidden_size, cfg.num_attention_heads,
                      cfg.num_key_value_heads)
        self.head_dim = h // nh
        self.qkv_proj = init.normal(h, (nh + 2 * nkv) * self.head_dim)
        self.o_proj = init.normal(nh * self.head_dim, h)
        self.qkv_bias = (init.fill(0.0, (nh + 2 * nkv) * self.head_dim)
                         if cfg.attention_bias else None)
        self.num_heads, self.num_kv_heads = nh, nkv
        self.window = cfg.sliding_window

    def forward(self, x, cos, sin, attn_mask=None):
        b, s, _ = x.shape
        nh, nkv, d = self.num_heads, self.num_kv_heads, self.head_dim
        qkv = wo_matmul(x, self.qkv_proj)
        if self.qkv_bias is not None:
            qkv = qkv + self.qkv_bias
        q, k, v = torch.split(qkv, [nh * d, nkv * d, nkv * d], dim=-1)
        q = A.apply_rope(q.reshape(b, s, nh, d), cos, sin)
        k = A.apply_rope(k.reshape(b, s, nkv, d), cos, sin)
        v = v.reshape(b, s, nkv, d)
        out = A.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=True,
                                             window=self.window)
        return wo_matmul(out.reshape(b, s, nh * d), self.o_proj)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = init.normal(h, 2 * m)   # fused gate+up (SwiGLU)
        self.down_proj = init.normal(m, h)
        self.intermediate_size = m

    def forward(self, x):
        gate, up = torch.chunk(wo_matmul(x, self.gate_up_proj), 2, dim=-1)
        return wo_matmul(torch.nn.functional.silu(gate) * up, self.down_proj)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                            init)
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = LlamaRMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, init)
        self.mlp = LlamaMLP(cfg, init)

    def forward(self, x, cos, sin, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, init)

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        cfg = self.cfg
        x = self.embed_tokens[input_ids]
        cos, sin = A.rope_cos_sin(
            input_ids.shape[1], cfg.hidden_size // cfg.num_attention_heads,
            base=cfg.rope_theta, position_ids=position_ids,
            scaling=cfg.rope_scaling,
            max_position_embeddings=cfg.max_position_embeddings,
            device=x.device)
        remat = cfg.remat and torch.is_grad_enabled()
        for lyr in self.layers:
            if remat:
                x = checkpoint(lyr, x, cos, sin, attn_mask,
                               use_reentrant=False)
            else:
                x = lyr(x, cos, sin, attn_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Decoder LM. ``device``: ``None`` means the card (raises without
    one); tests pass ``"cpu"``. ``seed`` draws the random weights."""

    def __init__(self, cfg: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        init = _Init(cfg, dev, seed)
        self.cfg = cfg
        self.model = LlamaModel(cfg, init)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else init.normal(cfg.hidden_size, cfg.vocab_size))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.device

    def logits(self, hidden):
        w = (self.model.embed_tokens.T if self.lm_head is None
             else self.lm_head)
        return wo_matmul(hidden, w)

    def forward(self, input_ids, attn_mask=None, position_ids=None):
        return self.logits(self.model(input_ids, attn_mask, position_ids))

    def loss(self, input_ids, labels, attn_mask=None):
        """Causal LM loss; labels = input shifted, ignore_index=-100."""
        logits = self(input_ids, attn_mask)
        per_tok = parallel_cross_entropy(logits, torch.clamp(labels, min=0))
        mask = (labels >= 0).float()
        return (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def num_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs/token ~ 6*N_params + attention term (for MFU)."""
    h, m = cfg.hidden_size, cfg.intermediate_size
    L, v = cfg.num_hidden_layers, cfg.vocab_size
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = h // nh
    per_layer = (2 * h * (nh + 2 * nkv) * d + 2 * nh * d * h + 2 * h * 2 * m
                 + 2 * m * h)
    n_matmul = L * per_layer + 2 * h * v  # fwd matmul FLOPs per token
    attn = L * 2 * 2 * seq_len * nh * d   # qk^T and pv per token
    return 3.0 * (n_matmul + attn)        # fwd + 2x bwd
