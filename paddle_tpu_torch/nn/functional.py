"""The Llama, MoE, BLOOM/Falcon and GPT slice of
``paddle_tpu/nn/functional.py``: ``silu``, ``swiglu``, ``gelu``,
``embedding``, ``rms_norm``, ``layer_norm``, ``dropout`` and
``scaled_dot_product_attention``, on tensors, and the losses the train
steps need:
``parallel_cross_entropy`` (Llama, moe_llm), ``cross_entropy``
(Mixtral, Qwen2-MoE) and ``masked_mean``, the reduction of every model's
loss. ``gelu`` and ``layer_norm`` are plain PyTorch: XLA fuses them in
the reference, which has no Pallas kernel for them.

Weights keep the reference's ``[in, out]`` layout where a layout exists.
"""
from __future__ import annotations

import contextvars

import torch

# The denominator of ``masked_mean`` as a function of the local count of
# kept positions; None: that count. ``distributed.sharded.data_parallel``
# sets it for a train step over a mesh's data axes.
MEAN_DENOMINATOR = contextvars.ContextVar("masked_mean_denominator",
                                          default=None)


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


def dropout_keep(shape, p, generator=None, device=None, axis=None):
    """The keep mask of :func:`dropout`: bool, True with probability
    ``1 - p``, drawn from ``generator`` (default: torch's generator of
    ``device``); with ``axis`` the mask varies only along those dims and
    broadcasts over the others, as the reference's does."""
    shape = list(shape)
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout(x, p=0.5, training=True, *, generator=None, axis=None,
            keep=None):
    """``paddle_tpu.nn.functional.dropout``: zero each element with
    probability ``p`` and scale the kept ones by ``1 / (1 - p)``; the
    identity when not training or ``p == 0``. The mask is drawn from
    ``generator`` (the port's counterpart of the reference's ``rng`` key),
    or is ``keep`` (a :func:`dropout_keep` mask drawn before, so that a
    block recomputed under remat applies the masks of its first run)."""
    if not training or p == 0.0:
        return x
    if keep is None:
        keep = dropout_keep(x.shape, p, generator, x.device, axis)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, *, generator=None,
                                 scale=None, window=None, kv_lens=None):
    """[B, S, H, D] layout (the reference's flash-attention convention):
    ``ops.attention.scaled_dot_product_attention``, the flash kernel (K2
    forward, K5 backward on the card) for every call it takes and the
    eager path for a dense mask or dropout, as the reference dispatches."""
    from paddle_tpu_torch.ops import attention as _attn
    return _attn.scaled_dot_product_attention(
        query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
        is_causal=is_causal, training=training, generator=generator,
        scale=scale, window=window, kv_lens=kv_lens)


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
    label smoothing toward the mean logit). The tp-sharded form is
    ``distributed.tensor_parallel.parallel_cross_entropy(axis_name="tp")``."""
    logits32 = logits.float()
    m = logits32.max(-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(logits32 - m).sum(-1)) + m.squeeze(-1)
    true_logit = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    loss = lse - true_logit
    if label_smoothing > 0.0:
        loss = ((1 - label_smoothing) * loss
                + label_smoothing * (lse - logits32.mean(-1)))
    return loss


def masked_mean(values, mask):
    """``(values * mask).sum() / max(mask.sum(), 1)``: the mean over the
    kept positions (``mask`` 1.0, the rest 0.0). Inside
    ``distributed.sharded.data_parallel(mesh)`` the denominator is this
    rank's share of the count over the data axes, so the ranks' mean of
    the value is the mean over the whole global batch, as the reference's
    loss of the global batch is."""
    count = mask.sum()
    denominator = MEAN_DENOMINATOR.get()
    count = (torch.clamp(count, min=1.0) if denominator is None
             else denominator(count))
    return (values * mask).sum() / count


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
        if reduction == "mean":
            return masked_mean(loss, mask)
        loss = loss * mask
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
