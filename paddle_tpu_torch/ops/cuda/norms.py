"""K1: fused RMSNorm — counterpart of ``paddle_tpu/ops/pallas/norms.py``.

``rms_norm`` is differentiable (a :class:`torch.autograd.Function`, the
counterpart of the reference's ``custom_vjp``). Its forward launches
``csrc/rms_norm.cu`` on a CUDA tensor (or raises) and runs
:func:`rms_norm_plain` on a CPU tensor; both round like the Pallas kernel:
fp32 math, the weight read in its own type and multiplied in fp32, one
cast at the end. Its backward is :func:`rms_norm_bwd`, the reference's
``_rms_bwd`` in plain PyTorch on both devices, as the reference computes
it in XLA and not in Pallas. ``rms_norm.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.cuda import _build


def rms_norm_plain(x, weight, epsilon=1e-6):
    """y = x * rsqrt(mean(x^2) + eps) * w in fp32, cast once."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + epsilon)
    return (y * weight.float()).to(x.dtype)


def rms_norm_bwd(x, weight, g, epsilon=1e-6):
    """(dx, dw) of ``rms_norm`` for the cotangent ``g`` — the reference's
    ``_rms_bwd``: fp32 math, ``dx`` cast to ``x.dtype``, ``dw`` summed over
    the rows and cast to the weight's type."""
    x32, g32, w32 = x.float(), g.float(), weight.float()
    inv = torch.rsqrt(x32.square().mean(-1, keepdim=True) + epsilon)
    xhat = x32 * inv
    dw = (g32 * xhat).reshape(-1, x.shape[-1]).sum(0)
    gw = g32 * w32
    dx = inv * (gw - xhat * (gw * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), dw.to(weight.dtype)


_sig_set = False


def _lib():
    global _sig_set
    lib = _build.library("rms_norm")
    if not _sig_set:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.rms_norm_fwd.argtypes = [i, i, i, v, v, v, i, i, ctypes.c_float,
                                     v]
        lib.rms_norm_fwd.restype = ctypes.c_int
        _sig_set = True
    return lib


def _rms_norm_cuda(x, weight, epsilon):
    """One launch of the K1 kernel (CUDA tensors)."""
    h = x.shape[-1]
    if weight.shape != (h,) or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} on "
                         f"{weight.device} for x {tuple(x.shape)} on {x.device}")
    code = _build.dtype_code(x, "rms_norm")
    wcode = _build.dtype_code(weight, "rms_norm weight")
    x2 = x.contiguous()
    w = weight.contiguous()
    y = torch.empty_like(x2)
    rows = x2.numel() // h if h else 0
    vec_elems = 16 // x2.element_size()
    vec = int(h % vec_elems == 0
              and all(t.data_ptr() % 16 == 0 for t in (x2, y))
              and w.data_ptr() % (vec_elems * w.element_size()) == 0)
    lib = _lib()
    rc = lib.rms_norm_fwd(code, wcode, 16 if vec else 1, _build.ptr(x2),
                          _build.ptr(w), _build.ptr(y), rows, h,
                          float(epsilon), _build.stream(x2))
    _build.check(lib, rc, "rms_norm")
    _build.count(rms_norm, x)
    return y


def _rms_norm_fwd(x, weight, epsilon):
    if x.is_cuda:
        return _rms_norm_cuda(x, weight, epsilon)
    return rms_norm_plain(x, weight, epsilon)


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, epsilon):
        ctx.save_for_backward(x, weight)
        ctx.epsilon = epsilon
        return _rms_norm_fwd(x, weight, epsilon)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, g, ctx.epsilon)
        return dx, dw, None


def rms_norm(x, weight=None, epsilon=1e-6):
    """x [..., H], weight [H] -> like x. Kernel on CUDA, plain on CPU;
    differentiable in x and weight. ``weight`` None is a unit weight: the
    kernel reads a ones vector in x's type (a product by 1 is exact, so
    the result is the unweighted norm). When no graph is recorded (grad
    mode off, as on the serving path, or no input requiring grad) the
    forward runs without the autograd ``Function``."""
    if weight is None:
        weight = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x, weight, epsilon)
    return _rms_norm_fwd(x, weight, epsilon)


rms_norm.launches = 0
rms_norm.f16 = _build.f16_counter()
