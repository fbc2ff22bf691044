"""The Llama, MoE and BLOOM/Falcon slice of ``paddle_tpu/nn/functional.py``:
``silu``, ``swiglu``, ``gelu``, ``embedding``, ``rms_norm`` and
``layer_norm``, on tensors, and the losses the train steps need:
``parallel_cross_entropy`` (Llama, moe_llm) and ``cross_entropy``
(Mixtral, Qwen2-MoE). ``gelu`` and ``layer_norm`` are plain PyTorch: XLA
fuses them in the reference, which has no Pallas kernel for them.

Weights keep the reference's ``[in, out]`` layout where a layout exists.
"""
from __future__ import annotations

import torch


def silu(x):
    return torch.nn.functional.silu(x)


def gelu(x, approximate=False):
    """``jax.nn.gelu``: the tanh approximation with ``approximate=True``
    (BLOOM), the exact erf form without (Falcon)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """The reference's rounding: mean and variance in fp32 (bf16 statistics
    lose ~3 digits, visible in deep pre-LN stacks), the weight and bias
    applied in fp32, one cast back to x's type. ``weight``/``bias`` None
    skip that term."""
    n = ((normalized_shape,) if isinstance(normalized_shape, int)
         else tuple(normalized_shape))
    dims = tuple(range(x.ndim - len(n), x.ndim))
    x32 = x.float()
    mean = x32.mean(dims, keepdim=True)
    var = (x32 - mean).square().mean(dims, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


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


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0):
    """Reference: paddle.nn.functional.cross_entropy — ``input`` is logits.
    The reference's fp32 log-softmax math; a hard label's term is taken by
    gather, not through a one-hot target (at a vocabulary of 151 936 the
    one-hot of a 4096-token batch is 2.5 GB)."""
    logp = torch.log_softmax(input.float(), dim=axis)
    num_classes = input.shape[axis]
    if soft_label:
        loss = -(label.float() * logp).sum(axis)
    else:
        idx = torch.clamp(label.long(), 0, num_classes - 1)
        loss = -torch.gather(logp, axis, idx.unsqueeze(axis)).squeeze(axis)
        # a label outside [0, C) has an all-zero one-hot row
        loss = loss * ((label >= 0) & (label < num_classes)).to(loss.dtype)
        if label_smoothing > 0.0:
            loss = ((1 - label_smoothing) * loss
                    - label_smoothing * logp.mean(axis))
    if weight is not None and not soft_label:
        loss = loss * weight[torch.clamp(label.long(), 0, num_classes - 1)]
    if not soft_label and ignore_index is not None:
        mask = (label != ignore_index).to(loss.dtype)
        loss = loss * mask
        if reduction == "mean":
            return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
