"""Quantization — counterpart of ``paddle_tpu/quantization.py`` (ref:
``python/paddle/quantization/``: QAT fake-quant, PTQ, quantized inference
layers; PaddleNLP ``weight_quantize`` / ``weight_only_linear`` and the
GPTQ algorithm of its llm toolchain).

* Fake quant and the QAT/PTQ API: :func:`fake_quant` is a
  ``torch.autograd.Function`` whose backward is the reference's
  straight-through estimator; :class:`QAT` swaps every
  :class:`~paddle_tpu_torch.nn.layers.Linear` for a :class:`QATLinear`
  (fake-quantized weight), :class:`PTQ` for a :class:`QuantizedLinear`
  (int8 weight, activations quantized per row, an exact int8 x int8 ->
  int32 product, fp32 rescale).
* Weight-only LLM inference: :class:`QuantizedWeight` holds the int8 codes
  (int4: two codes packed per byte along K) and the per-out-channel fp32
  scale of a ``[in, out]`` projection as buffers of an ``nn.Module``, so
  ``.to(device)``, ``state_dict`` and ``deepcopy`` carry them.
  :func:`weight_only_linear` computes ``(x @ q) * scale`` in the
  reference's order: the codes are cast to the activation's type (every
  code in [-127, 127] is exact in bf16) and the large product stays
  ``torch.matmul``, as the reference left it to XLA. The cast writes a
  compute-type copy of the weight on every call; a fused dequantizing
  product is later work (ROADMAP.md).
* GPTQ: :func:`gptq_quantize` rounds the in-dim columns in order and feeds
  each column's error forward through the upper Cholesky factor of the
  damped inverse Hessian ``(2 X^T X)^-1``. On a CPU tensor it is the
  reference's own float64 numpy loop, one rank-1 update per column; on a
  CUDA tensor it runs in float64 on the card (``torch.linalg`` inverse
  and Cholesky) in the lazy-batch form: the columns of a block of
  ``GPTQ_BLOCK`` update only the block, one CUDA graph of the block's
  column loop replayed per block, and each block's errors reach the
  columns after it in one product. The two orders of the same sums agree
  to float64 rounding. :func:`quantize_llama_weights` calibrates every
  projection from one capture forward of the unquantized model
  (:func:`_capture_calib`).
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device

__all__ = [
    "fake_quant", "quantize_weight", "dequantize", "AbsmaxObserver",
    "FakeQuantLayer", "QuantizedLinear", "quant_linear", "QAT", "PTQ",
    # weight-only LLM inference (PaddleNLP weight_only_linear / GPTQ parity)
    "QuantizedWeight", "weight_quantize", "weight_only_linear", "wo_matmul",
    "gptq_quantize", "quantize_llama_weights",
]


# -- fake quant with straight-through estimator ------------------------------

class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = 2.0 ** (bits - 1) - 1
        ctx.save_for_backward(x, scale)
        q = torch.clamp(torch.round(x / scale * qmax), -qmax - 1, qmax)
        return q * scale / qmax

    @staticmethod
    def backward(ctx, g):
        # STE: the gradient passes where |x / scale| <= 1, zero elsewhere;
        # none reaches the scale (the reference's _fq_bwd)
        x, scale = ctx.saved_tensors
        inside = (torch.abs(x / scale) <= 1.0).to(g.dtype)
        return g * inside, torch.zeros_like(scale), None


def fake_quant(x, scale, bits=8):
    """Snap ``x`` to the ``bits``-bit grid of ``scale`` (clipped to
    [-(qmax + 1), qmax] steps) with the straight-through gradient."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return _FakeQuant.apply(x, scale, bits)


def quantize_weight(w, bits=8, axis=None):
    """Symmetric quantization, per channel along ``axis`` when given.
    Returns (int8 codes, fp32 scale)."""
    qmax = 2.0 ** (bits - 1) - 1
    f = w.detach().float()
    if axis is None:
        scale = f.abs().amax()
    else:
        red = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
        scale = f.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(f / scale * qmax), -qmax - 1,
                    qmax).to(torch.int8)
    return q, scale / qmax


def dequantize(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


# -- observers / PTQ ---------------------------------------------------------

class AbsmaxObserver:
    """Running absmax calibration (ref: paddle.quantization observers)."""

    def __init__(self, momentum=0.9):
        self.momentum = momentum
        self.absmax = None

    def observe(self, x):
        cur = float(torch.as_tensor(x).abs().max())
        self.absmax = cur if self.absmax is None else \
            self.momentum * self.absmax + (1 - self.momentum) * cur
        return self.absmax

    @property
    def scale(self):
        return max(self.absmax or 1.0, 1e-8)


class FakeQuantLayer(nn.Module):
    """QAT activation fake-quant node; ``scale`` is a buffer set by
    calibration."""

    def __init__(self, bits=8, init_scale=1.0, device=None):
        super().__init__()
        self.register_buffer("scale", torch.tensor(
            float(init_scale), dtype=torch.float32,
            device=resolve_device(device)))
        self.bits = bits

    def forward(self, x):
        return fake_quant(x, self.scale.to(x.dtype), self.bits).to(x.dtype)


# -- quantized inference layers ----------------------------------------------

def quantize_rows(x, bits=8):
    """Dynamic per-row activation quantization: (int8 codes, fp32 scale
    [.., 1]) with ``scale = max(absmax, 1e-8) / qmax``."""
    qmax = 2.0 ** (bits - 1) - 1
    f = x.float()
    xs = torch.clamp(f.abs().amax(dim=-1, keepdim=True), min=1e-8) / qmax
    return torch.clamp(torch.round(f / xs), -qmax - 1, qmax).to(
        torch.int8), xs


def _pad_to(t, rows, cols):
    return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                       0, rows - t.shape[0]))


def int8_matmul(qx, qw):
    """The exact int8 x int8 -> int32 product of ``qx`` [.., K] and ``qw``
    [K, N]. On the CPU an int32 matmul; on the card ``torch._int_mm``, its
    operands zero-padded to the shapes it takes (more than 16 rows, K and N
    multiples of 8; the zeros add only zero products) and ``qw`` handed
    over column-major, the layout cuBLASLt takes at every row count."""
    lead = qx.shape[:-1]
    a = qx.reshape(-1, qx.shape[-1])
    if not a.is_cuda:
        out = a.to(torch.int32) @ qw.to(torch.int32)
    else:
        m, k = a.shape
        n = qw.shape[1]
        mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        b = _pad_to(qw, kp, np_).T.contiguous().T
        out = torch._int_mm(_pad_to(a, mp, kp), b)[:m, :n]
    return out.reshape(*lead, qw.shape[1])


class QuantizedLinear(nn.Module):
    """int8-weight linear (ref: paddle.nn.quant.Linear after PTQ): the
    weight [in, out] stored int8 with per-out-channel scales, activations
    quantized per row at call time, the product int8 x int8 -> int32
    (:func:`int8_matmul`), then rescaled in fp32."""

    def __init__(self, weight, bias=None, bits=8):
        super().__init__()
        q, scale = quantize_weight(weight, bits=bits, axis=1)  # [in, out]
        self.register_buffer("qweight", q)
        self.register_buffer("wscale", scale.reshape(1, -1))
        self.bias = bias
        self.bits = bits

    def int_product(self, x):
        """(int32 accumulator, per-row activation scale) of ``x``."""
        qx, xs = quantize_rows(x, self.bits)
        return int8_matmul(qx, self.qweight), xs

    def forward(self, x):
        acc, xs = self.int_product(x)
        out = acc.float() * xs * self.wscale
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


def quant_linear(linear, bits=8):
    """Convert a ``Linear`` into a ``QuantizedLinear`` (PTQ weight-only)."""
    return QuantizedLinear(linear.weight, linear.bias, bits=bits)


# -- high-level entry points (ref paddle.quantization.QAT / PTQ) -------------

@dataclass
class QuantConfig:
    bits: int = 8
    activation: bool = True


class QATLinear(nn.Module):
    """Linear whose weight passes through fake_quant at every call (STE
    gradients), with the per-out-channel absmax scale over axis 0 of the
    ``[in, out]`` weight — the reference's QAT-instrumented layer. It
    keeps the Linear's own parameters."""

    def __init__(self, weight, bias=None, bits=8):
        super().__init__()
        self.weight, self.bias, self.bits = weight, bias, bits

    def forward(self, x):
        f = self.weight.float()
        wscale = torch.clamp(f.abs().amax(dim=0, keepdim=True), min=1e-8)
        w = fake_quant(f, wscale, self.bits).to(x.dtype)
        y = x @ w
        return y + self.bias if self.bias is not None else y


def _replace_linears(model, make):
    """A deep copy of ``model`` with every ``Linear`` replaced by
    ``make(linear)``: attributes, lists, tuples, dicts, ``nn.ModuleList``
    (``Sequential.layers`` among them) are walked."""
    from paddle_tpu_torch.nn.layers import Linear

    model = copy.deepcopy(model)

    def convert_item(item):
        if isinstance(item, Linear):
            return make(item)
        if isinstance(item, nn.Module):
            convert_tree(item)
        return item

    def convert_tree(m):
        for name, sub in list(m._modules.items()):
            if isinstance(sub, nn.ModuleList):
                for i in range(len(sub)):
                    sub[i] = convert_item(sub[i])
            elif sub is not None:
                m._modules[name] = convert_item(sub)
        for name, sub in list(vars(m).items()):
            if name.startswith("_"):
                continue
            if isinstance(sub, list):
                for i, item in enumerate(sub):
                    sub[i] = convert_item(item)
            elif isinstance(sub, tuple):
                setattr(m, name, tuple(convert_item(i) for i in sub))
            elif isinstance(sub, dict):
                for k in list(sub):
                    sub[k] = convert_item(sub[k])
        return m

    return convert_tree(model)


class QAT:
    """Quantization-aware training pass (ref: paddle.quantization.QAT):
    every Linear becomes a fake-quant-weight :class:`QATLinear`."""

    def __init__(self, config: QuantConfig = QuantConfig()):
        self.config = config

    def quantize(self, model):
        return _replace_linears(
            model,
            lambda lin: QATLinear(lin.weight, lin.bias, self.config.bits))


class PTQ:
    """Post-training quantization (ref: paddle.quantization.PTQ): every
    Linear becomes an int8 :class:`QuantizedLinear`."""

    def __init__(self, config: QuantConfig = QuantConfig()):
        self.config = config

    def quantize(self, model):
        return _replace_linears(
            model, lambda lin: quant_linear(lin, self.config.bits))


class quanter:
    """Ref paddle.quantization.quanter namespace: fake-quant factories."""

    FakeQuanterWithAbsMax = FakeQuantLayer


# -- weight-only LLM inference quantization ----------------------------------

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


def _swap(owner, name, value):
    """Put ``value`` under the name of ``owner``'s registered parameter
    (``nn.Module.__setattr__`` refuses any other value under a
    parameter's name, so the parameter is unregistered first)."""
    delattr(owner, name)
    setattr(owner, name, value)


# -- GPTQ --------------------------------------------------------------------

GPTQ_BLOCK = 128      # columns a block of the card's lazy-batch recursion


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gptq_scale_hessian(W, X, qmax, percdamp, xp):
    """The per-row scale of ``W`` [N, K] and the upper Cholesky factor U of
    the damped inverse Hessian (``Hinv = U^T U``), in float64 with ``xp``
    (numpy: the reference's own calls; torch: ``torch.linalg``)."""
    if xp is np:
        scale = np.maximum(np.abs(W).max(axis=1, keepdims=True), 1e-8) / qmax
        H = 2.0 * (X.T @ X)
        damp = percdamp * float(np.mean(np.diag(H)) or 1.0)
        H[np.diag_indices(H.shape[0])] += damp
        return scale, np.linalg.cholesky(np.linalg.inv(H)).T
    scale = torch.clamp(W.abs().amax(dim=1, keepdim=True), min=1e-8) / qmax
    H = 2.0 * (X.T @ X)
    damp = percdamp * (float(H.diagonal().mean()) or 1.0)
    H.diagonal().add_(damp)
    return scale, torch.linalg.cholesky(torch.linalg.inv(H), upper=True)


def _gptq_loop(W, scale, U, qmax):
    """The reference's recursion (numpy float64, in place on ``W``): one
    rank-1 update of every later column per quantized column."""
    k = W.shape[1]
    Q = np.zeros_like(W)
    for j in range(k):
        wc = W[:, j]
        qc = np.clip(np.round(wc / scale[:, 0]), -qmax, qmax)
        Q[:, j] = qc
        err = (wc - qc * scale[:, 0]) / U[j, j]
        if j + 1 < k:
            W[:, j + 1:] -= np.outer(err, U[j, j + 1:])
    return Q


class _BlockGraph:
    """The column loop of one block of ``GPTQ_BLOCK`` columns over static
    float64 buffers (weights ``w`` [N, B], the block of U ``u`` [B, B], the
    row scale ``s``), captured once as a CUDA graph: each replay leaves the
    codes in ``q`` and the fed-forward errors in ``e``. A narrower last
    block pads ``w`` with zero columns and ``u`` with the identity, whose
    codes and errors are 0."""

    def __init__(self, n, qmax, dev):
        b = GPTQ_BLOCK
        f64 = dict(dtype=torch.float64, device=dev)
        self.w, self.q, self.e = (torch.zeros(n, b, **f64) for _ in range(3))
        self.eye = torch.eye(b, **f64)
        self.u = self.eye.clone()
        self.s = torch.ones(n, **f64)
        self.qmax = qmax
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._body()                       # warm-up off the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body()

    def _body(self):
        w, u, s, qmax = self.w, self.u, self.s, self.qmax
        for j in range(GPTQ_BLOCK):
            wc = w[:, j]
            qc = torch.clamp(torch.round(wc / s), -qmax, qmax)
            self.q[:, j] = qc
            err = (wc - qc * s) / u[j, j]
            self.e[:, j] = err
            if j + 1 < GPTQ_BLOCK:
                w[:, j + 1:].sub_(torch.outer(err, u[j, j + 1:]))

    def run(self, W, U, b0, Q):
        """Quantize columns ``b0 ..`` of ``W`` (one block) into ``Q`` and
        feed the block's errors into the columns after it."""
        b1 = min(b0 + GPTQ_BLOCK, W.shape[1])
        width = b1 - b0
        self.w.zero_()
        self.w[:, :width] = W[:, b0:b1]
        self.u.copy_(self.eye)
        self.u[:width, :width] = U[b0:b1, b0:b1]
        self.graph.replay()
        Q[:, b0:b1] = self.q[:, :width]
        if b1 < W.shape[1]:
            W[:, b1:].sub_(self.e[:, :width] @ U[b0:b1, b1:])


def gptq_quantize(w, calib_x, bits: int = 4, percdamp: float = 0.01, *,
                  timings=None, graphs=None):
    """GPTQ: error-compensated rounding with the calibration Hessian
    ``H = 2 X^T X`` (damped by ``percdamp`` of its mean diagonal). The
    in-dim columns are quantized in order, each column's rounding error
    fed into the columns not yet quantized through the upper Cholesky
    factor of ``H^-1``. ``w``: [K, N] (in, out); ``calib_x``: [M, K], the
    activations that feed this product. Returns a :class:`QuantizedWeight`
    with the same packing and per-out-channel scales as RTN
    (:func:`weight_quantize`): only the rounding decisions differ.

    A CPU ``w`` runs the reference's numpy float64 loop (codes and scales
    bit for bit the reference's); a CUDA ``w`` the card's float64 lazy
    batch (module docstring). ``timings`` ({"hessian", "recursion"}:
    seconds) accumulates where the time went; ``graphs`` caches the
    card's block graphs across calls."""
    dev = w.device
    qmax = 2.0 ** (bits - 1) - 1
    k, n = w.shape
    t0 = time.perf_counter()
    if dev.type != "cuda":
        W = w.detach().double().cpu().numpy().T.copy()       # [N, K]
        X = torch.as_tensor(calib_x).detach().double().cpu().numpy()
        scale, U = _gptq_scale_hessian(W, X, qmax, percdamp, np)
        t1 = time.perf_counter()
        Q = _gptq_loop(W, scale, U, qmax)
        q = torch.from_numpy(Q.T.copy()).to(torch.int8)
        scale = torch.from_numpy(scale.T.astype(np.float32))
    else:
        W = w.detach().T.double().contiguous()                # [N, K]
        X = calib_x.detach().to(device=dev, dtype=torch.float64)
        scale, U = _gptq_scale_hessian(W, X, qmax, percdamp, torch)
        del X
        _sync(dev)
        t1 = time.perf_counter()
        graphs = {} if graphs is None else graphs
        key = (n, qmax, dev)
        if key not in graphs:
            graphs[key] = _BlockGraph(n, qmax, dev)
        blk = graphs[key]
        blk.s.copy_(scale[:, 0])
        Q = torch.empty_like(W)
        for b0 in range(0, k, GPTQ_BLOCK):
            blk.run(W, U, b0, Q)
        # the codes in RTN's row-major [K, N] layout: a transposed view
        # would make every unpack and cast of the served weight strided
        q = Q.to(torch.int8).T.contiguous()
        scale = scale.T.float().contiguous()
        _sync(dev)
    t2 = time.perf_counter()
    if timings is not None:
        timings["hessian"] = timings.get("hessian", 0.0) + t1 - t0
        timings["recursion"] = timings.get("recursion", 0.0) + t2 - t1
    if bits == 4:
        q = _pack_nibbles(q, 0)
    return QuantizedWeight(q.to(dev), scale.to(dev), bits, k)


def quantize_llama_weights(model, algo: str = "weight_only_int8",
                           calib_ids=None, percdamp: float = 0.01, *,
                           timings=None):
    """Weight-only quantize a LLaMA-family model IN PLACE for inference:
    the qkv/o/gate_up/down projections (and an untied ``lm_head``) become
    :class:`QuantizedWeight`s, which every forward dispatches through
    :func:`wo_matmul`. ``algo``: weight_only_int8 | weight_only_int4 |
    gptq_int8 | gptq_int4 (GPTQ calibrates each product from one capture
    forward of ``calib_ids`` [B, S] through the unquantized model).
    ``timings`` ({"capture", "hessian", "recursion"}: seconds) records
    where GPTQ's time went."""
    from paddle_tpu_torch.models.llama import refuse_scanned
    refuse_scanned(model, "quantize_llama_weights")
    gptq = algo.startswith("gptq")
    if any(getattr(lyr.self_attn, "fp8_meta", None) is not None
           for lyr in model.model.layers):
        raise ValueError(
            "weight-only quantization and the fp8 training path are "
            "mutually exclusive (fp8_matmul cannot consume QuantizedWeight);"
            " rebuild the model with fp8=False for quantized inference")
    bits = 4 if algo.endswith("int4") else 8
    rtn_algo = f"weight_only_int{bits}"
    timings = {} if timings is None else timings
    calib = None
    if gptq:
        if calib_ids is None:
            raise ValueError("gptq quantization needs calib_ids")
        t0 = time.perf_counter()
        calib = _capture_calib(model, calib_ids)
        _sync(model.model.embed_tokens.device)
        timings["capture"] = timings.get("capture", 0.0) + \
            time.perf_counter() - t0
    graphs = {}

    def quant(owner, name, rec=None, key=None):
        w = getattr(owner, name)
        if gptq:
            qw = gptq_quantize(w, rec.pop(key), bits, percdamp,
                               timings=timings, graphs=graphs)
        else:
            qw = weight_quantize(w, rtn_algo)
        _swap(owner, name, qw)

    for li, lyr in enumerate(model.model.layers):
        att, mlp = lyr.self_attn, lyr.mlp
        c = calib[li] if gptq else None
        quant(att, "qkv_proj", c, "qkv")
        quant(att, "o_proj", c, "o")
        quant(mlp, "gate_up_proj", c, "gate_up")
        quant(mlp, "down_proj", c, "down")
    if getattr(model, "lm_head", None) is not None:
        quant(model, "lm_head", calib[-1] if gptq else None, "head")
    return model


@torch.no_grad()
def _capture_calib(model, ids):
    """One forward through the unquantized model recording the input of
    each projection of every decoder layer, flattened to [B*S, K] float32
    on the model's device; the last layer's record also carries the
    ``lm_head`` input (the final norm's output) under ``"head"``. Attention
    honours the model's sliding window."""
    from paddle_tpu_torch.models.llama import refuse_scanned
    from paddle_tpu_torch.ops import attention as A
    refuse_scanned(model, "_capture_calib")
    cfg = model.cfg
    dev = model.model.embed_tokens.device
    ids = torch.as_tensor(ids, device=dev).long()
    x = model.model.embed_tokens[ids]
    d = cfg.hidden_size // cfg.num_attention_heads
    cos, sin = A.rope_cos_sin(ids.shape[1], d, base=cfg.rope_theta,
                              scaling=cfg.rope_scaling,
                              max_position_embeddings=
                              cfg.max_position_embeddings, device=dev)

    def rec(t):
        return t.reshape(-1, t.shape[-1]).float()

    out = []
    for lyr in model.model.layers:
        att, mlp = lyr.self_attn, lyr.mlp
        r = {}
        h = lyr.input_layernorm(x)
        r["qkv"] = rec(h)
        b, s, _ = h.shape
        qkv = wo_matmul(h, att.qkv_proj)
        if att.qkv_bias is not None:
            qkv = qkv + att.qkv_bias
        nh, nkv, hd = att.num_heads, att.num_kv_heads, att.head_dim
        q, kk, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
        q = A.apply_rope(q.reshape(b, s, nh, hd), cos, sin)
        kk = A.apply_rope(kk.reshape(b, s, nkv, hd), cos, sin)
        ctx = A.scaled_dot_product_attention(
            q, kk, v.reshape(b, s, nkv, hd), is_causal=True,
            window=att.window).reshape(b, s, nh * hd)
        r["o"] = rec(ctx)
        x = x + wo_matmul(ctx, att.o_proj)
        h2 = lyr.post_attention_layernorm(x)
        r["gate_up"] = rec(h2)
        gate, up = torch.chunk(wo_matmul(h2, mlp.gate_up_proj), 2, dim=-1)
        act = torch.nn.functional.silu(gate) * up
        r["down"] = rec(act)
        x = x + wo_matmul(act, mlp.down_proj)
        out.append(r)
    out[-1]["head"] = rec(model.model.norm(x))
    return out
