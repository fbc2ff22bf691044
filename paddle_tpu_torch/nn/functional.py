"""The Llama slice of ``paddle_tpu/nn/functional.py``: ``silu``,
``swiglu``, ``embedding`` and ``rms_norm``, on tensors, and the loss the
Llama train step needs, ``parallel_cross_entropy``.

Weights keep the reference's ``[in, out]`` layout where a layout exists.
"""
from __future__ import annotations

import torch


def silu(x):
    return torch.nn.functional.silu(x)


def swiglu(x, y=None):
    """Ref: paddle.incubate.nn.functional.swiglu (LLaMA MLP gate)."""
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return torch.nn.functional.silu(x) * y


def embedding(x, weight, padding_idx=None):
    out = weight[x]
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def rms_norm(x, weight=None, epsilon=1e-6):
    """Same rounding as the reference's jnp version: normalise in fp32,
    cast back, THEN multiply by the weight. (The fused kernel path,
    ``ops.fused_rms_norm``, follows the Pallas kernel instead and casts
    once after the weight; the two agree exactly in fp32.)"""
    x32 = x.float()
    out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + epsilon)
    out = out.to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def parallel_cross_entropy(logits, labels, *, label_smoothing=0.0):
    """Per-token cross entropy [...] of ``logits`` [..., V] against integer
    ``labels`` [...] in fp32: the tp = 1 math of the reference's
    ``paddle_tpu/distributed/tensor_parallel.py`` ``parallel_cross_entropy``
    (log-sum-exp with the max detached, the true logit by gather, optional
    label smoothing toward the mean logit). The tp-sharded form comes with
    ``distributed/`` (ROADMAP.md queue 1 item 7)."""
    logits32 = logits.float()
    m = logits32.max(-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(logits32 - m).sum(-1)) + m.squeeze(-1)
    true_logit = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    loss = lse - true_logit
    if label_smoothing > 0.0:
        loss = ((1 - label_smoothing) * loss
                + label_smoothing * (lse - logits32.mean(-1)))
    return loss
