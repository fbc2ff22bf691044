"""fp8 training with delayed scaling — counterpart of
``paddle_tpu/amp/fp8.py`` (the TransformerEngine recipe).

  * e4m3 forward operands and e5m2 gradients, with per-tensor scales
    derived from rolling amax HISTORIES (delayed scaling: the scale used
    at step t comes from steps < t).
  * :func:`fp8_matmul` is a ``torch.autograd.Function``. On the card both
    products of the forward and dx run on ``torch._scaled_mm`` (e4m3 x
    e4m3 forward, e5m2 x e4m3 for dx, e4m3 x e5m2 for dw); the reference's
    product is XLA's, not a Pallas kernel, so a stock fp8 product stands
    in for it. On the CPU the quantized operands are upcast to bfloat16
    and multiplied in float32, as the reference does.
  * The histories are registered BUFFERS of an :class:`Fp8Meta` module:
    the optimizer and the global-norm clip, which walk parameters, never
    see them. The reference threads them as a custom-vjp "cotangent" the
    optimizer overwrites; here the backward rolls them in place. Under
    remat a layer's forward re-runs inside the backward before any of its
    products' backward, so the recompute reads the scales the first
    forward read, and each history rolls once a step.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
FP8_META_MARKER = "fp8_meta"  # name of the attribute holding the meta
ROLES = ("x", "w", "g")


class Fp8Meta(nn.Module):
    """Delayed-scaling state of one product: an amax history per operand
    role (x activation, w weight, g upstream gradient) as float32 buffers
    ``amax_x`` / ``amax_w`` / ``amax_g``. Scales are derived from them at
    use time."""

    def __init__(self, history_len: int = 16, device=None):
        super().__init__()
        dev = resolve_device(device)
        for role in ROLES:
            self.register_buffer(f"amax_{role}", torch.zeros(
                history_len, dtype=torch.float32, device=dev))

    def histories(self):
        return tuple(getattr(self, f"amax_{r}") for r in ROLES)


def new_fp8_meta(history_len: int = 16, device=None) -> Fp8Meta:
    return Fp8Meta(history_len, device)


def _compute_scale(history, fp8_max, margin: float = 0.0):
    """Scale mapping the history's amax to ``fp8_max`` (1 before any
    history exists)."""
    amax = history.max()
    scale = fp8_max / torch.clamp(amax, min=1e-12) / (2.0 ** margin)
    return torch.where(amax > 0, scale, torch.ones_like(scale))


def _quant(x, scale, dtype, fp8_max):
    return torch.clamp(x.float() * scale, -fp8_max, fp8_max).to(dtype)


@torch.no_grad()
def _roll(history, amax_now):
    history.copy_(torch.cat([amax_now.reshape(1).to(history.dtype),
                             history[:-1]]))


def _scaled_mm(a, b, inv_a, inv_b, out_dtype):
    """``a @ b * inv_a * inv_b`` on the card's fp8 tensor cores: a
    row-major [M, K], b column-major [K, N], K and N multiples of 16."""
    out = torch._scaled_mm(a, b, scale_a=inv_a, scale_b=inv_b,
                           out_dtype=out_dtype)
    return out[0] if isinstance(out, tuple) else out


def _colmajor(t):
    return t.t().contiguous().t()


def _product(a, b, sa, sb, out_dtype, plain):
    """(a / sa) @ (b / sb) of two quantized 2-D operands: ``_scaled_mm``
    on the card, float32 products of their bfloat16 upcasts on the CPU (or
    anywhere with ``plain``)."""
    if a.is_cuda and not plain:
        return _scaled_mm(a.contiguous(), _colmajor(b),
                          (1.0 / sa).float(), (1.0 / sb).float(), out_dtype)
    y = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    return (y / (sa * sb)).to(out_dtype)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, hx, hw, hg, plain):
        sx = _compute_scale(hx, E4M3_MAX)
        sw = _compute_scale(hw, E4M3_MAX)
        x2 = x.reshape(-1, x.shape[-1])
        qx = _quant(x2, sx, torch.float8_e4m3fn, E4M3_MAX)
        qw = _quant(w, sw, torch.float8_e4m3fn, E4M3_MAX)
        y = _product(qx, qw, sx, sw, x.dtype, plain)
        ctx.save_for_backward(qx, qw, sx, sw, x2.abs().max(), w.abs().max())
        ctx.hist = (hx, hw, hg)
        ctx.shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        ctx.plain = plain
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw, ax, aw = ctx.saved_tensors
        hx, hw, hg = ctx.hist
        g2 = g.reshape(-1, g.shape[-1])
        sg = _compute_scale(hg, E5M2_MAX)
        qg = _quant(g2, sg, torch.float8_e5m2, E5M2_MAX)
        dx = _product(qg, qw.t(), sg, sw, ctx.x_dtype,
                      ctx.plain).reshape(ctx.shape)
        dw = _product(qx.t(), qg, sx, sg, ctx.w_dtype, ctx.plain)
        # the histories roll here, once a step, after every read of them
        _roll(hx, ax)
        _roll(hw, aw)
        _roll(hg, g2.abs().max())
        return dx, dw, None, None, None, None


_PLAIN = [False]


@contextlib.contextmanager
def plain_products():
    """Every :func:`fp8_matmul` of the block runs the CPU's upcast
    products, on any device: a whole fp8 model's plain version, which the
    card's ``_scaled_mm`` run is held to."""
    prev, _PLAIN[0] = _PLAIN[0], True
    try:
        yield
    finally:
        _PLAIN[0] = prev


def fp8_matmul(x, w, meta: Fp8Meta, plain: bool = False):
    """``x @ w`` with e4m3 operands under delayed scaling. x [..., K],
    w [K, N]; the backward quantizes the upstream gradient to e5m2 and
    rolls ``meta``'s histories in place. ``plain`` (or an enclosing
    :func:`plain_products`) runs the CPU's upcast products on any device
    (what the card's result is held to)."""
    return _Fp8Matmul.apply(x, w, *meta.histories(), plain or _PLAIN[0])


def is_fp8_meta_path(path_str: str) -> bool:
    return FP8_META_MARKER in path_str


class Fp8Linear(nn.Module):
    """Linear layer through :func:`fp8_matmul`: ``weight`` [in, out]
    (Xavier-uniform from ``gen``) and ``bias`` train normally;
    ``fp8_meta`` holds the scaling state as buffers."""

    def __init__(self, in_features, out_features, bias_attr=True,
                 history_len: int = 16, dtype=torch.bfloat16, device=None,
                 gen=None):
        super().__init__()
        dev = resolve_device(device)
        bound = (6.0 / (in_features + out_features)) ** 0.5
        w = torch.empty((in_features, out_features), dtype=torch.float32,
                        device=dev)
        w.uniform_(-bound, bound, generator=gen)
        self.weight = nn.Parameter(w.to(dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=dev))
                     if bias_attr else None)
        self.fp8_meta = new_fp8_meta(history_len, dev)

    def forward(self, x):
        y = fp8_matmul(x, self.weight, self.fp8_meta)
        return y if self.bias is None else y + self.bias
