"""Weight-only int8/int4 inference quantization — counterpart of the
weight-only part of ``paddle_tpu/quantization.py``.

:class:`QuantizedWeight` holds the int8 codes (int4: two codes packed
per byte along K) and the per-out-channel fp32 scale of a ``[in, out]``
projection as buffers of an ``nn.Module``, so ``.to(device)``, ``state_dict``
and ``deepcopy`` carry them. :func:`weight_only_linear` computes
``(x @ q) * scale`` in the reference's order: the codes are cast to the
activation's type (every code in [-127, 127] is exact in bf16) and the
large product stays ``torch.matmul``, as the reference left it to XLA.
The cast writes a compute-type copy of the weight on every call; a fused
dequantizing product is later work (ROADMAP.md). GPTQ and the fake-quant
training API are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn


class QuantizedWeight(nn.Module):
    """int8/int4 weight + per-out-channel scale.

    Layout: original weight [K, N] (in, out). int8 stores ``q`` as [K, N]
    int8; int4 packs two 4-bit values per byte ALONG K -> [ceil(K/2), N]
    int8 (low nibble = even k, high nibble = odd k). ``scale`` [1, N]
    fp32."""

    def __init__(self, q, scale, bits: int, k: int):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bits = int(bits)
        self.k = int(k)

    @property
    def shape(self):
        return (self.k, self.q.shape[-1])

    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    def unpack(self):
        """int8 [K, N] values (sign-extended nibbles for int4)."""
        if self.bits == 8:
            return self.q
        return _unpack_nibbles(self.q, 0)[: self.k]

    def dequantize(self, dtype=torch.float32):
        return (self.unpack().float() * self.scale).to(dtype)


def _unpack_nibbles(packed, axis):
    """Two sign-extended 4-bit values per byte of ``packed``, interleaved
    along ``axis`` (low nibble first)."""
    p = packed.to(torch.int32)
    low = ((p & 0xF) ^ 8) - 8
    high = p >> 4                        # arithmetic: sign-extends
    out = torch.stack([low, high], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    return out.reshape(shape).to(torch.int8)


def _pack_nibbles(q, axis):
    """Inverse of :func:`_unpack_nibbles`: pairs of codes along ``axis``
    (zero-padded to an even length) into one byte each."""
    if q.shape[axis] % 2:
        pad = list(q.shape)
        pad[axis] = 1
        q = torch.cat([q, q.new_zeros(pad)], dim=axis)
    pairs = q.unfold(axis, 2, 2)
    low, high = pairs[..., 0], pairs[..., 1]
    return ((high.to(torch.int32) << 4)
            | (low.to(torch.int32) & 0xF)).to(torch.int8)


def _rtn(w, bits, axis):
    """Symmetric round-to-nearest codes and scales: absmax over ``axis``
    (kept) / qmax, floored at 1e-8 so an all-zero channel has no 0/0."""
    qmax = 2.0 ** (bits - 1) - 1
    f = w.float()
    scale = torch.clamp(f.abs().amax(dim=axis, keepdim=True), min=1e-8) / qmax
    q = torch.clamp(torch.round(f / scale), -qmax, qmax).to(torch.int8)
    return q, scale


BITS = {"weight_only_int8": 8, "weight_only_int4": 4}


def weight_quantize(w, algo: str = "weight_only_int8") -> QuantizedWeight:
    """RTN per-out-channel symmetric quantization (ref ``weight_quantize``)
    of a [K, N] weight."""
    bits = BITS[algo]
    q, scale = _rtn(w.detach(), bits, 0)
    if bits == 4:
        q = _pack_nibbles(q, 0)
    return QuantizedWeight(q, scale, bits, w.shape[0])


def weight_only_linear(x, qw: QuantizedWeight, bias=None):
    """``(x @ q) * scale``: the codes in x's type, the per-out-channel
    scale on the [.., N] result (ref ``weight_only_linear``)."""
    y = (x @ qw.unpack().to(x.dtype)) * qw.scale.to(x.dtype)[0]
    return y if bias is None else y + bias


def wo_matmul(x, w):
    """``x @ w`` with the reference's ``[in, out]`` weight layout, or the
    weight-only quantized product for a :class:`QuantizedWeight`."""
    if isinstance(w, QuantizedWeight):
        return weight_only_linear(x, w)
    return x @ w
