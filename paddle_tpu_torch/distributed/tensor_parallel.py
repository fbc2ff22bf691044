"""Tensor (model) parallel layers — counterpart of
``paddle_tpu/distributed/tensor_parallel.py`` (ref: Paddle's
``fleet/layers/mpu/mp_layers.py`` and ``mp_ops.py``).

The reference keeps the full weight with a PartitionSpec over ``tp`` and
lets GSPMD insert the collectives. Here each layer is built from the full
``[in, out]`` weight and :func:`~.sharded.shard_module` (or ``mesh=`` at
construction) leaves each rank its slice; the forward then runs the
collectives the reference's compiler inserts, as the reference's upstream
hand-codes them (column: identity forward / all-reduce backward on the
input; row: all-reduce forward on the output).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.sharded import (TpInfo, set_pspec,
                                                  shard_module)
from paddle_tpu_torch.nn import functional as F


def _normal(shape, std, dtype, device, seed):
    w = torch.empty(shape, dtype=dtype, device=device)
    w.normal_(0.0, std, generator=generator(seed, device))
    return nn.Parameter(w)


class _TpLayer(nn.Module):
    _pt_tp = None     # TpInfo once sharded over a tp axis of size > 1

    def _place(self, mesh):
        if mesh is not None:
            shard_module(self, mesh, stage=1)


class ColumnParallelLinear(_TpLayer):
    """weight [in, out] sharded on out (tp); ``gather_output`` gathers the
    output's columns back on every rank."""

    def __init__(self, in_features, out_features, bias_attr=True,
                 gather_output=False, weight_init=None, dtype=torch.float32,
                 device=None, seed: int = 0, mesh=None):
        super().__init__()
        device = resolve_device(device)
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = (weight_init((in_features, out_features), dtype, device)
                       if weight_init else _normal((in_features, out_features),
                                                   std, dtype, device, seed))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias_attr else None)
        set_pspec(self, "weight", (None, "tp"))
        if bias_attr:
            set_pspec(self, "bias", ("tp",))
        self.gather_output = gather_output
        self._place(mesh)

    def forward(self, x):
        tp = self._pt_tp
        if tp is not None:
            x = C.copy_to_group(x, tp.group)
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        if tp is not None and self.gather_output:
            y = C.gather_last(y, tp.group, tp.size, tp.index)
        return y


class RowParallelLinear(_TpLayer):
    """weight [in, out] sharded on in (tp); the input arrives tp-sharded
    from a column-parallel layer (``input_is_parallel``) or is split here,
    and the partial products are all-reduced."""

    def __init__(self, in_features, out_features, bias_attr=True,
                 input_is_parallel=True, weight_init=None,
                 dtype=torch.float32, device=None, seed: int = 0, mesh=None):
        super().__init__()
        device = resolve_device(device)
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = (weight_init((in_features, out_features), dtype, device)
                       if weight_init else _normal((in_features, out_features),
                                                   std, dtype, device, seed))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias_attr else None)
        set_pspec(self, "weight", ("tp", None))
        self.input_is_parallel = input_is_parallel
        self._place(mesh)

    def forward(self, x):
        tp = self._pt_tp
        if tp is None:
            y = x @ self.weight
        else:
            if not self.input_is_parallel:
                x = C.split_last(x, tp.group, tp.size, tp.index)
            y = C.reduce_from_group(x @ self.weight, tp.group)
        return y if self.bias is None else y + self.bias


def vocab_parallel_lookup(weight, ids, tp):
    """Rows of a vocab-sharded table: each rank looks up the ids in its
    range (zeros elsewhere) and the rows are summed over tp."""
    if tp is None:
        return weight[ids]
    v = weight.shape[0]
    local = ids - tp.index * v
    ok = (local >= 0) & (local < v)
    rows = weight[local.clamp(0, v - 1)]
    rows = torch.where(ok.unsqueeze(-1), rows, torch.zeros_like(rows))
    return C.reduce_from_group(rows, tp.group)


class VocabParallelEmbedding(_TpLayer):
    """Embedding table sharded over vocab (tp): masked local lookup and an
    all-reduce, the reference's masked lookup."""

    def __init__(self, num_embeddings, embedding_dim, weight_init=None,
                 dtype=torch.float32, device=None, seed: int = 0, mesh=None):
        super().__init__()
        device = resolve_device(device)
        self.weight = (weight_init((num_embeddings, embedding_dim), dtype,
                                   device)
                       if weight_init else _normal(
                           (num_embeddings, embedding_dim), 0.02, dtype,
                           device, seed))
        set_pspec(self, "weight", ("tp", None))
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self._place(mesh)

    def forward(self, x):
        return vocab_parallel_lookup(self.weight, x, self._pt_tp)


def _vocab_parallel_ce(logits32, labels, tp, label_smoothing):
    """Cross-entropy over vocab-sharded fp32 logits (Megatron's
    vocab-parallel CE): the max and the sum of exponentials are reduced
    over tp, and the true logit is picked on the rank that holds it."""
    v = logits32.shape[-1]
    m = logits32.detach().amax(-1, keepdim=True).contiguous()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
    shifted = logits32 - m
    sumexp = C.reduce_from_group(torch.exp(shifted).sum(-1), tp.group)
    lse = torch.log(sumexp) + m.squeeze(-1)
    local = labels - tp.index * v
    ok = (local >= 0) & (local < v)
    picked = torch.gather(logits32, -1,
                          local.clamp(0, v - 1).unsqueeze(-1)).squeeze(-1)
    true_logit = C.reduce_from_group(
        torch.where(ok, picked, torch.zeros_like(picked)), tp.group)
    loss = lse - true_logit
    if label_smoothing > 0.0:
        mean_logit = C.reduce_from_group(logits32.sum(-1),
                                         tp.group) / (v * tp.size)
        loss = (1 - label_smoothing) * loss + label_smoothing * (
            lse - mean_logit)
    return loss


def parallel_cross_entropy(logits, labels, *, label_smoothing=0.0,
                           axis_name=None, mesh=None):
    """Per-token cross-entropy in fp32 (ref mp_ops
    ``c_softmax_with_cross_entropy``). With ``axis_name`` the logits are
    this rank's vocab shard over that axis of the active mesh (or
    ``mesh=``): the softmax is reduced over it without gathering the
    full logits on any rank. Without, the logits are whole."""
    if axis_name is not None:
        _, group, n, idx = C._axis(axis_name, mesh)
        if n > 1:
            return _vocab_parallel_ce(logits.float(), labels,
                                      TpInfo(group, n, idx), label_smoothing)
    return F.parallel_cross_entropy(logits, labels,
                                    label_smoothing=label_smoothing)
