"""Quantized serving — counterpart of ``paddle_tpu/serving/quant.py``.

The weight side of quantized serving (the int8 paged KV cache lives in
``models/paged.py`` and ``LLMEngine(kv_dtype="int8")``):

* :func:`quantize_for_serving` — weight-only int8 / packed int4 of any
  model the paged forwards drive, IN PLACE: the dense projections
  (qkv/o/gate_up/down and an untied lm_head) become
  :class:`~paddle_tpu_torch.quantization.QuantizedWeight`, MoE expert
  stacks :class:`QuantizedExpertStack` (dequantized on the fly by
  ``distributed.moe``, so the grouped GEMM K6a runs on them unchanged);
  the fp32 router gate is never quantized. Round-to-nearest, or GPTQ
  (``gptq_int8``/``gptq_int4``, dense Llama-family models, calibrated by
  ``calib_ids``: ``quantization.quantize_llama_weights``).
  ``PT_QUANT_WEIGHTS=0`` makes it the identity.
* :func:`smooth_for_serving` — SmoothQuant-style per-channel migration
  folded out of the RMSNorm weight and into the projections that read
  its output (the product is unchanged): with ``calib_ids`` the measured
  activation absmax of one capture forward (dense Llama-family models),
  without it the weight-balancing heuristic.
* :func:`quant_quality` — logit MSE and greedy match rate against a
  reference, published as ``serving_quant_*`` gauges.

A projection of an ``nn.Module`` is a registered ``Parameter``, and
``nn.Module.__setattr__`` refuses any other value under its name, so the
parameter is unregistered before its quantized module takes the name.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.models.paged import _backbone, is_moe_model
from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.quantization import (BITS, QuantizedWeight,
                                           _capture_calib, _pack_nibbles,
                                           _rtn, _swap, _unpack_nibbles,
                                           quantize_llama_weights,
                                           weight_quantize)

__all__ = [
    "QuantizedExpertStack", "expert_stack_quantize", "weights_quant_enabled",
    "quantize_for_serving", "smooth_for_serving", "quant_quality",
    "quantized_weight_bytes",
]

_Q_BITS = METRICS.gauge(
    "serving_quant_weight_bits",
    "Weight-only quantization bit-width of the last model passed through "
    "quantize_for_serving (0 = unquantized / kill switch active)")
_Q_LAYERS = METRICS.gauge(
    "serving_quant_layers",
    "Decoder layers whose projections were converted to quantized weights "
    "by the last quantize_for_serving call")
_Q_WEIGHT_BYTES = METRICS.gauge(
    "serving_quant_weight_bytes",
    "Device bytes of the quantized projection/head weights (codes + "
    "scales) after the last quantize_for_serving call")
_Q_SMOOTHED = METRICS.gauge(
    "serving_quant_smoothed",
    "1 when SmoothQuant-style activation smoothing was folded into the "
    "weights before quantization, else 0")
_Q_MSE = METRICS.gauge(
    "serving_quant_logit_mse",
    "Mean squared error between reference and quantized logits from the "
    "last quant_quality probe")
_Q_MATCH = METRICS.gauge(
    "serving_quant_greedy_match_rate",
    "Fraction of positions whose argmax token matches the reference in "
    "the last quant_quality probe")


def weights_quant_enabled() -> bool:
    """``PT_QUANT_WEIGHTS=0`` kill switch, read when a model is quantized
    (``quantize_for_serving`` becomes the identity); an already-quantized
    model keeps serving."""
    return os.environ.get("PT_QUANT_WEIGHTS", "1").strip().lower() \
        not in ("0", "off")


class QuantizedExpertStack(nn.Module):
    """int8/int4 expert weight stack [E, K, N] + per-(expert, out-channel)
    fp32 scale [E, 1, N]. int4 packs two codes per byte along K ->
    [E, ceil(K/2), N] (low nibble = even k)."""

    def __init__(self, q, scale, bits: int, k: int):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bits = int(bits)
        self.k = int(k)

    @property
    def shape(self):
        return (self.q.shape[0], self.k, self.q.shape[-1])

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    def unpack(self):
        """int8 [E, K, N] values (sign-extended nibbles for int4)."""
        if self.bits == 8:
            return self.q
        return _unpack_nibbles(self.q, 1)[:, : self.k]

    def dequantize(self, dtype=torch.float32):
        return (self.unpack().float() * self.scale).to(dtype)


def expert_stack_quantize(w, algo: str = "weight_only_int8"):
    """RTN per-(expert, out-channel) symmetric quantization of a [E, K, N]
    expert stack."""
    bits = BITS[algo]
    q, scale = _rtn(w.detach(), bits, 1)
    if bits == 4:
        q = _pack_nibbles(q, 1)
    return QuantizedExpertStack(q, scale, bits, w.shape[1])


def _moe(lyr):
    """The layer's ``MoELayer`` (Mixtral and moe_llm: ``.moe``; Qwen2-MoE:
    inside the sparse block at ``.mlp``), None for a dense MLP."""
    blk = lyr.moe if hasattr(lyr, "moe") else lyr.mlp
    blk = getattr(blk, "moe", blk)
    return blk if hasattr(blk, "experts") else None


# ---- SmoothQuant-style activation smoothing ---------------------------------

@torch.no_grad()
def _fold(norm, s, *targets):
    """Exact migration norm/s <-> W*s: the norm output shrinks by s per
    channel and every consumer of that output grows its matching input
    rows by s (in place)."""
    w = norm.weight
    w.copy_((w.float() / s).to(w.dtype))
    for t in targets:
        shape = (1, -1, 1) if t.dim() == 3 else (-1, 1)
        t.copy_((t.float() * s.reshape(shape)).to(t.dtype))


def _smooth_scale(a_x, w, alpha):
    """s = a_x^alpha / a_w^(1-alpha) per in-channel, clipped to keep the
    fold numerically sane. ``a_x``: the activation absmax per in-channel
    (ones: weight balancing); ``w``: [K, N] or [E, K, N]."""
    f = w.detach().float().abs()
    a_w = torch.clamp(f.amax(dim=(0, 2) if f.dim() == 3 else (1,)), min=1e-8)
    return torch.clamp(a_x ** alpha / a_w ** (1.0 - alpha), 1e-3, 1e3)


def smooth_for_serving(model, *, calib_ids=None, alpha: float = 0.5):
    """Fold per-channel smoothing into the weights IN PLACE (before
    :func:`quantize_for_serving`; the model computes the same function up
    to float rounding). Seams per layer: input_layernorm <-> qkv_proj, and
    post_attention_layernorm <-> gate_up (the dense MLP, or every expert
    plus the router gate and a shared expert, which read the same normed
    activations). ``calib_ids`` [B, S]: the migration follows the
    activation absmax that one capture forward of the unsmoothed model
    measures (``quantization._capture_calib``; dense Llama-family models
    only); None balances the weights alone (a_x = 1)."""
    bb = _backbone(model)
    stats = None
    if calib_ids is not None:
        if is_moe_model(model) or not hasattr(model, "model"):
            raise NotImplementedError(
                "activation-calibrated smoothing needs the dense "
                "Llama-family capture forward; smooth MoE models without "
                "calib_ids (weight-balancing heuristic)")
        stats = _capture_calib(model, calib_ids)

    def a_x(li, key, w):
        if stats is None:
            return torch.ones(w.shape[-2], dtype=torch.float32,
                              device=w.device)
        act = stats[li].pop(key)                     # [M, K] float32
        return torch.clamp(act.abs().amax(dim=0), min=1e-8)

    for li, lyr in enumerate(bb.layers):
        att = lyr.self_attn
        s = _smooth_scale(a_x(li, "qkv", att.qkv_proj), att.qkv_proj, alpha)
        _fold(lyr.input_layernorm, s, att.qkv_proj)
        moe = _moe(lyr)
        if moe is None:
            gu = lyr.mlp.gate_up_proj
            _fold(lyr.post_attention_layernorm,
                  _smooth_scale(a_x(li, "gate_up", gu), gu, alpha), gu)
            continue
        blk = lyr.moe if hasattr(lyr, "moe") else lyr.mlp
        shared = [getattr(blk, n) for n in ("shared_gate_up", "shared_gate")
                  if hasattr(blk, n)]
        gu = moe.experts.gate_up
        _fold(lyr.post_attention_layernorm,
              _smooth_scale(a_x(li, "gate_up", gu), gu, alpha), gu,
              moe.gate_w, *shared)
    model._smoothed = True
    return model


# ---- engine-facing entry point ----------------------------------------------

def quantized_weight_bytes(model) -> int:
    """Device bytes of the quantized projections/head (codes + scales)."""
    return sum(m.nbytes() for m in model.modules()
               if isinstance(m, (QuantizedWeight, QuantizedExpertStack)))


GPTQ_ALGOS = ("gptq_int8", "gptq_int4")


def quantize_for_serving(model, algo: str = "weight_only_int8", *,
                         calib_ids=None, smooth: bool = False,
                         smooth_alpha: float = 0.5, percdamp: float = 0.01,
                         timings=None):
    """Weight-only quantize a model IN PLACE for the paged serving stack
    and return it. ``algo``: weight_only_int8 | weight_only_int4 |
    gptq_int8 | gptq_int4 (GPTQ needs ``calib_ids`` [B, S] and a dense
    Llama-family model: the capture forward is structure-specific; damping
    ``percdamp``; ``timings`` collects its capture / Hessian / recursion
    seconds). ``smooth=True`` folds :func:`smooth_for_serving` (with the
    same ``calib_ids``) in first. Under ``PT_QUANT_WEIGHTS=0`` the model
    is returned untouched and the bits gauge reads 0."""
    if not weights_quant_enabled():
        _Q_BITS.set(0)
        return model
    if algo not in BITS and algo not in GPTQ_ALGOS:
        raise ValueError(f"unknown algo {algo!r}: one of "
                         f"{sorted(BITS) + list(GPTQ_ALGOS)}")
    gptq = algo in GPTQ_ALGOS
    layers = _backbone(model).layers
    if any(getattr(lyr.self_attn, "fp8_meta", None) is not None
           for lyr in layers):
        raise ValueError(
            "weight-only quantization and the fp8 training path are "
            "mutually exclusive; rebuild the model with fp8=False")
    if gptq and (is_moe_model(model) or not hasattr(model, "model")):
        raise NotImplementedError(
            "GPTQ for serving supports dense Llama-family models only (the "
            "calibration capture forward is structure-specific); use "
            "weight_only_int8/int4")
    bits = 4 if algo.endswith("int4") else 8
    if smooth:
        smooth_for_serving(model, calib_ids=calib_ids, alpha=smooth_alpha)
    if gptq:
        quantize_llama_weights(model, algo, calib_ids=calib_ids,
                               percdamp=percdamp, timings=timings)
        layers = ()
    for lyr in layers:
        att = lyr.self_attn
        for name in ("qkv_proj", "o_proj"):
            _swap(att, name, weight_quantize(getattr(att, name), algo))
        moe = _moe(lyr)
        if moe is None:
            for name in ("gate_up_proj", "down_proj"):
                _swap(lyr.mlp, name, weight_quantize(getattr(lyr.mlp, name),
                                                     algo))
        else:
            for name in ("gate_up", "down"):
                _swap(moe.experts, name,
                      expert_stack_quantize(getattr(moe.experts, name), algo))
    if not gptq and getattr(model, "lm_head", None) is not None:
        _swap(model, "lm_head", weight_quantize(model.lm_head, algo))
    model._wo_bits = bits
    _Q_BITS.set(bits)
    _Q_LAYERS.set(len(_backbone(model).layers))
    _Q_SMOOTHED.set(1 if getattr(model, "_smoothed", False) else 0)
    _Q_WEIGHT_BYTES.set(quantized_weight_bytes(model))
    return model


# ---- quality instrumentation ------------------------------------------------

def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def quant_quality(ref_logits, q_logits) -> dict:
    """Logit MSE + greedy match rate of quantized vs reference logits (any
    matching [..., V] shapes). Publishes both gauges and returns
    ``{"logit_mse", "greedy_match_rate"}``."""
    ref, q = _np(ref_logits), _np(q_logits)
    if ref.shape != q.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {q.shape}")
    mse = float(np.mean((ref - q) ** 2))
    match = float(np.mean(ref.argmax(-1) == q.argmax(-1)))
    _Q_MSE.set(mse)
    _Q_MATCH.set(match)
    return {"logit_mse": mse, "greedy_match_rate": match}
