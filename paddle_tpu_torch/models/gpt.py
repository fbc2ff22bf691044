"""GPT-3 style decoder — counterpart of ``paddle_tpu/models/gpt.py``.

Pre-LN GPT with learned positions, a tanh-GELU MLP, residual dropout
(``cfg.dropout``) and a head tied to the word embeddings (``x @ wte.T``).
Attention goes through ``nn.functional.scaled_dot_product_attention``
with the block's ``training`` flag and no ``dropout_p``, as the
reference calls it, so every call takes the flash kernel (K2 forward, K5
backward on the card). ``GPTConfig()`` is GPT-3 1.3B, the reference's
``bench.py`` ``bench_gpt3_tp`` model.

Same parameter names and ``[in, out]`` layout as the reference, so
``models.convert.load_jax_state_dict`` fills them name for name (the
fused ``qkv`` is ``[h, 3h]`` with columns ``[q all heads | k | v]``).

Tensor parallelism (``distributed.shard_module`` over a mesh with tp > 1)
follows the reference's specs: ``qkv``, ``qkv_bias``, ``fc1`` and
``fc1_bias`` column-sharded, ``proj`` and ``fc2`` row-sharded, ``wte``
sharded over the vocabulary. A tp rank holds ``[q_i|k_i|v_i]``, whole
heads (``GPTBlock.tp_perm``, undone by ``state_dict()``), and runs the
Megatron pair around its local products (``copy_to_group`` before the
column products, ``reduce_from_group`` after the row products). The
embedding lookup is ``vocab_parallel_lookup`` and the tied head gives
this rank's vocab shard of the logits, so the loss is the vocab-parallel
cross entropy; the lookup's and the head's gradients both land in the
rank's ``wte`` shard, where autograd sums them.

Dropout draws its masks from the ``generator`` handed to ``forward`` /
``loss`` (the counterpart of the reference's ``rng``); each block's masks
are drawn before the block runs and passed to it, so a block recomputed
under remat applies the masks of its first run.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.sharded import set_pspec
from paddle_tpu_torch.distributed.tensor_parallel import (
    _vocab_parallel_ce, vocab_parallel_lookup)
from paddle_tpu_torch.models.llama import (_Init, _refuse_tp, _sp_mesh,
                                           _tp_interleave_perm)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout, LayerNorm


@dataclass
class GPTConfig:
    """The defaults are GPT-3 1.3B (24 layers, hidden 2048, 16 heads of
    128, MLP 8192, vocabulary 50 304, 2048 positions)."""
    vocab_size: int = 50304
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 8192
    max_position_embeddings: int = 2048
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @staticmethod
    def gpt3_1p3b(**kw):
        return GPTConfig(**kw)

    @staticmethod
    def tiny(**kw):
        return GPTConfig(**{**dict(vocab_size=128, hidden_size=32,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   intermediate_size=64,
                                   max_position_embeddings=64,
                                   dtype=torch.float32, remat=False), **kw})


class GPTBlock(nn.Module):
    _pt_tp = None   # distributed.sharded.TpInfo once tp-sharded

    def __init__(self, cfg: GPTConfig, init: _Init):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.ln1 = LayerNorm(h, epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                             device=init.device)
        self.qkv = init.normal(h, 3 * h)
        self.qkv_bias = init.fill(0.0, 3 * h)
        self.proj = init.normal(h, h)
        self.proj_bias = init.fill(0.0, h)
        self.ln2 = LayerNorm(h, epsilon=cfg.layer_norm_eps, dtype=cfg.dtype,
                             device=init.device)
        self.fc1 = init.normal(h, m)
        self.fc1_bias = init.fill(0.0, m)
        self.fc2 = init.normal(m, h)
        self.fc2_bias = init.fill(0.0, h)
        for name, spec in (("qkv", (None, "tp")), ("qkv_bias", ("tp",)),
                           ("proj", ("tp", None)), ("fc1", (None, "tp")),
                           ("fc1_bias", ("tp",)), ("fc2", ("tp", None))):
            set_pspec(self, name, spec)
        self.num_heads = cfg.num_attention_heads
        self.intermediate_size = m
        self.dropout = Dropout(cfg.dropout)

    def shard_check(self, mesh):
        _refuse_tp("num_attention_heads", self.num_heads, mesh.size("tp"))
        _refuse_tp("intermediate_size", self.intermediate_size,
                   mesh.size("tp"))

    def tp_perm(self, name, tp):
        if name in ("qkv", "qkv_bias"):
            d = self.qkv.shape[0] // self.num_heads
            n = self.num_heads
            return _tp_interleave_perm([n, n, n], d, tp)
        return None

    def _col(self, x):
        return x if self._pt_tp is None else C.copy_to_group(x,
                                                             self._pt_tp.group)

    def _row(self, y):
        return y if self._pt_tp is None else C.reduce_from_group(
            y, self._pt_tp.group)

    def forward(self, x, keep=None):
        """``keep``: the block's two dropout masks (None: no dropout)."""
        b, s, h = x.shape
        tp = 1 if self._pt_tp is None else self._pt_tp.size
        nh = self.num_heads // tp
        d = h // self.num_heads
        k1, k2 = (None, None) if keep is None else keep
        y = self.ln1(x)
        qkv = self._col(y) @ self.qkv + self.qkv_bias
        q, k, v = (t.reshape(b, s, nh, d) for t in torch.chunk(qkv, 3, -1))
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              training=self.training)
        y = self._row(attn.reshape(b, s, nh * d) @ self.proj) + self.proj_bias
        x = x + self.dropout(y, keep=k1)
        y = F.gelu(self._col(self.ln2(x)) @ self.fc1 + self.fc1_bias,
                   approximate=True)
        y = self._row(y @ self.fc2) + self.fc2_bias
        return x + self.dropout(y, keep=k2)


class GPTForCausalLM(nn.Module):
    """``device``: ``None`` means the card (raises without one); tests pass
    ``"cpu"``. ``seed`` draws the random weights."""

    _pt_tp = None

    def __init__(self, cfg: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        init = _Init(cfg, resolve_device(device), seed)
        self.cfg = cfg
        self.wte = init.normal(cfg.vocab_size, cfg.hidden_size)
        self.wpe = init.normal(cfg.max_position_embeddings, cfg.hidden_size)
        set_pspec(self, "wte", ("tp", None))
        self.blocks = nn.ModuleList(GPTBlock(cfg, init)
                                    for _ in range(cfg.num_hidden_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                              dtype=cfg.dtype, device=init.device)

    def shard_check(self, mesh):
        _refuse_tp("vocab_size", self.cfg.vocab_size, mesh.size("tp"))

    @property
    def device(self) -> torch.device:
        return self.wte.device

    def _keep(self, x, generator):
        """Each block's two dropout masks, drawn now (None without
        dropout)."""
        p = self.cfg.dropout
        if not self.training or p == 0.0:
            return [None] * len(self.blocks)
        return [tuple(F.dropout_keep(x.shape, p, generator, x.device)
                      for _ in range(2)) for _ in self.blocks]

    def hidden(self, input_ids, generator=None):
        """The final LayerNorm's output [B, S, h]."""
        if _sp_mesh() is not None:
            raise NotImplementedError(
                "GPT under a mesh with sp > 1: its learned positions would "
                "need each rank's global offset; train it over dp / fsdp / tp")
        s = input_ids.shape[1]
        x = vocab_parallel_lookup(self.wte, input_ids, self._pt_tp)
        x = x + self.wpe[:s]
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk, keep in zip(self.blocks, self._keep(x, generator)):
            x = (checkpoint(blk, x, keep, use_reentrant=False) if remat
                 else blk(x, keep))
        return self.ln_f(x)

    def _local_logits(self, hidden):
        """This rank's vocab shard of the tied head's logits (all of them
        without tp)."""
        tp = self._pt_tp
        if tp is not None:
            hidden = C.copy_to_group(hidden, tp.group)
        return hidden @ self.wte.T

    def forward(self, input_ids, generator=None):
        out = self._local_logits(self.hidden(input_ids, generator))
        tp = self._pt_tp
        return (out if tp is None
                else C.gather_last(out, tp.group, tp.size, tp.index))

    def loss(self, input_ids, labels, generator=None):
        """Causal LM loss (labels = ids shifted by one; label < 0 ignored):
        the reference's ``parallel_cross_entropy``, over the vocab shards
        under tp."""
        logits = self._local_logits(self.hidden(input_ids, generator))
        tp, lab = self._pt_tp, torch.clamp(labels, min=0)
        per_tok = (F.parallel_cross_entropy(logits, lab) if tp is None
                   else _vocab_parallel_ce(logits.float(), lab, tp, 0.0))
        return F.masked_mean(per_tok, (labels >= 0).float())


def num_flops_per_token(cfg: GPTConfig, seq_len: int) -> float:
    """Training FLOPs a token (for MFU): 3 x the forward's matmul FLOPs
    (qkv, proj, fc1, fc2, the tied head) plus the attention products
    QK^T and PV."""
    h, L, v = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    per_layer = 2 * h * 4 * h + 2 * h * cfg.intermediate_size * 2
    attn = L * 2 * 2 * seq_len * h
    return 3.0 * (L * per_layer + 2 * h * v + attn)
