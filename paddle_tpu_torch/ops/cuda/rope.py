"""K7: fused rotate-half rotary embedding — counterpart of
``paddle_tpu/ops/pallas/rope.py``.

``fused_rope(x, cos, sin)`` rotates each head of ``x`` [..., H, D]:
``cat(x1 * cos - x2 * sin, x2 * cos + x1 * sin)`` in fp32, cast once to
``x.dtype``. ``cos``/``sin`` are fp32 tables [R, D/2]: with the leading
dims of ``x`` flattened to N rows, row n reads table row n % R — R = S
for one [S, D/2] table shared by a [B, S, H, D] batch, R = N for per-row
tables (dynamic-NTK prefill [B, S, D/2], the decode step's [B, D/2]).

On a CUDA tensor it launches ``csrc/rope.cu`` (or raises), which reads a
strided q/k view of the fused QKV product in place; on a CPU tensor it
runs :func:`fused_rope_plain`. The two agree to the bit on the card. The
result is contiguous. It is differentiable in ``x`` (a
:class:`torch.autograd.Function`): the backward is the same kernel run
on the gradient with ``-sin``, the rotation's transpose. The tables get
no gradient. ``fused_rope.launches`` counts kernel launches, backward
ones included.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.cuda import _build


def _tables(x, cos, sin):
    """(rows N, table rows R, cos, sin as fp32 [R, D/2]); R must divide N.
    A table that is already fp32 [R, D/2] passes untouched: every rope of
    the decode tick comes through here."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rope: head_dim {d} is odd")
    half = d // 2
    if cos.dim() != 2 or cos.shape[1] != half:
        cos = cos.reshape(-1, half)
    if sin.dim() != 2 or sin.shape[1] != half:
        sin = sin.reshape(-1, half)
    if cos.dtype != torch.float32:
        cos = cos.float()
    if sin.dtype != torch.float32:
        sin = sin.float()
    n = x.numel() // (x.shape[-2] * d) if x.numel() else 0
    r = cos.shape[0]
    if sin.shape != cos.shape or r == 0 or n % r:
        raise ValueError(f"rope: tables {tuple(cos.shape)}/{tuple(sin.shape)}"
                         f" for {n} rows of x {tuple(x.shape)}")
    return n, r, cos, sin


def fused_rope_plain(x, cos, sin):
    """The plain PyTorch version: x [..., H, D], tables [R, D/2] (any shape
    that reshapes to it), row n of x's flattened leading dims reading table
    row n % R. fp32 math, one cast; a contiguous result shaped like x."""
    n, r, c, s = _tables(x, cos, sin)
    h, d = x.shape[-2:]
    x32 = x.reshape(n // r, r, h, d).float()
    c, s = c[None, :, None, :], s[None, :, None, :]
    x1, x2 = x32[..., :d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype).reshape(x.shape)


_sig_set = False


def _lib():
    global _sig_set
    lib = _build.library("rope")
    if not _sig_set:
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rope_fwd.argtypes = [i, i, v, v, v, v, ll, i, i, ll, ll, i, v]
        lib.rope_fwd.restype = ctypes.c_int
        _sig_set = True
    return lib


def _rows_view(x):
    """x as [N, H, D] rows with D contiguous and H heads D apart, and the
    row stride: a view (no copy) wherever the leading dims collapse, as
    they do for q/k split out of the fused QKV product."""
    h, d = x.shape[-2:]
    if x.stride(-1) != 1 or x.stride(-2) != d:
        x = x.contiguous()
    try:
        rows = x.view(-1, h, d)
    except RuntimeError:
        rows = x.contiguous().view(-1, h, d)
    return rows, rows.stride(0)


def _rope_cuda(x, cos, sin, neg=False):
    """One launch of the K7 kernel (CUDA tensors)."""
    code = _build.dtype_code(x, "rope")
    n, r, c, s = _tables(x, cos, sin)
    if c.get_device() != x.get_device() or s.get_device() != x.get_device():
        raise ValueError(f"rope: tables on {c.device} for x on {x.device}")
    if not c.is_contiguous():
        c = c.contiguous()
    if not s.is_contiguous():
        s = s.contiguous()
    h, d = x.shape[-2:]
    rows, stride = _rows_view(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    es = x.element_size()
    xp, op, cp, sp = (rows.data_ptr(), out.data_ptr(), c.data_ptr(),
                      s.data_ptr())
    vec = ((d // 2) % (16 // es) == 0 and (stride * es) % 16 == 0
           and (xp | op | cp | sp) % 16 == 0)
    lib = _lib()
    rc = lib.rope_fwd(code, 16 if vec else 1, xp, cp, sp, op, n, h, d, stride,
                      r, int(neg), _build.stream(x))
    _build.check(lib, rc, "rope")
    fused_rope.launches += 1
    return out


def _rope_fwd(x, cos, sin, neg=False):
    if x.is_cuda:
        return _rope_cuda(x, cos, sin, neg)
    return fused_rope_plain(x, cos, -sin if neg else sin)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope_fwd(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return _rope_fwd(g, cos, sin, neg=True), None, None


def fused_rope(x, cos, sin):
    """x [..., H, D] (bf16 or fp32; a strided q/k view is read in place),
    cos/sin fp32 [R, D/2] with R dividing the row count -> contiguous, like
    x. Kernel on CUDA, plain on CPU; differentiable in x. When no graph is
    recorded the forward runs without the autograd ``Function``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, cos, sin)
    return _rope_fwd(x, cos, sin)


fused_rope.launches = 0
