"""K6: grouped (ragged) matmul — counterpart of
``paddle_tpu/ops/pallas/grouped_matmul.py``.

``grouped_matmul(lhs, rhs, group_sizes)`` computes, for rows of ``lhs``
sorted so that each group's (expert's) rows are contiguous,

    out[r] = lhs[r] @ rhs[g(r)]        g(r) = the group owning row r,

with fp32 accumulation and one cast to ``lhs.dtype``. It is differentiable
(a :class:`torch.autograd.Function`, the counterpart of the reference's
``custom_vjp``): the forward launches K6a from ``csrc/grouped_matmul.cu`` on
CUDA tensors (or raises) and runs :func:`grouped_matmul_plain` on CPU
tensors; the backward computes ``dlhs`` with K6a against ``rhs`` read
transposed in the kernel (no transposed copy) and ``drhs`` with K6b, or
:func:`grouped_matmul_bwd_plain` on the CPU. ``group_sizes`` gets no
gradient and is never read back to the host on the kernel path: the launch
covers the static bound of row tiles and each block finds its group on the
device. :func:`fwd_route` names the kernel a K6a launch runs: the few-rows
kernel at the decode shape, the tensor cores (``wgmma``) for bf16 at the
prefill and train shapes, forward and dlhs alike, fp32 FMAs for float32;
:func:`dw_route` the kernel of a K6b launch: the tensor cores for bf16,
fp32 FMAs for float32. ``grouped_matmul.launches`` counts K6a launches
(forward and dlhs), ``grouped_matmul.route_launches`` the K6a launches of
each kernel (``"rows"``, ``"wgmma"``, ``"fma"``), ``grouped_dw.launches``
K6b launches and
``grouped_dw.route_launches`` the K6b launches of each kernel (``"wgmma"``,
``"fma"``).

``PT_GROUPED_GEMM=0`` (:func:`grouped_gemm_enabled`) keeps its meaning: the
MoE layer then takes its dense capacity path and never comes here.
"""
from __future__ import annotations

import ctypes
import os

import torch

from paddle_tpu_torch.ops.cuda import _build

# mean rows per group at or below which K6a runs its few-rows kernel (the
# decode shape: a few rows spread over many groups, each group's weights
# streamed once)
ROWS_KERNEL_MAX_ROWS_PER_GROUP = 8
# the kernel code grouped_fwd in csrc/grouped_matmul.cu takes for a route
_KIND = {"fma": 0, "rows": 1, "wgmma": 2}


def fwd_route(m, e, k, n, dtype, trans=False, aligned=True) -> str:
    """The kernel one K6a launch of ``lhs [m, k]`` against ``E = e``
    groups' weights (``[e, k, n]``, or ``[e, n, k]`` read transposed when
    ``trans``: the backward's dlhs) runs, from the static shapes, the dtype
    and whether the weights are 16-byte aligned (``aligned``) alone:

    * ``"rows"``: the few-rows kernel, for the decode shape (at most
      ``ROWS_KERNEL_MAX_ROWS_PER_GROUP`` rows a group on average, n a
      whole number of 16-byte loads, no transposed weights);
    * ``"wgmma"``: bf16 on the tensor cores (k and n multiples of 8);
    * ``"fma"``: fp32 FMAs, for float32 and whatever the other two refuse.

    Every route is a kernel: a CUDA tensor never reaches
    :func:`grouped_matmul_plain`."""
    if (not trans and m <= ROWS_KERNEL_MAX_ROWS_PER_GROUP * e
            and n % (16 // dtype.itemsize) == 0 and aligned):
        return "rows"
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "fma"


# groups whose row offsets K6b's tensor-core kernel keeps in shared memory
DW_WGMMA_MAX_GROUPS = 1024


def dw_route(m, e, k, n, dtype, aligned=True) -> str:
    """The kernel one K6b launch (``drhs [e, k, n]`` from ``lhs [m, k]``
    and ``g [m, n]``) runs, from the static shapes, the dtype and whether
    lhs, g and the result are 16-byte aligned (``aligned``) alone:

    * ``"wgmma"``: bf16 on the tensor cores (k and n multiples of 8, at
      most ``DW_WGMMA_MAX_GROUPS`` groups);
    * ``"fma"``: fp32 FMAs, for float32 and whatever ``"wgmma"`` refuses.

    ``m`` does not choose (the group sizes stay on the device); every
    route is a kernel: a CUDA tensor never reaches the plain version."""
    if (dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0 and aligned
            and e <= DW_WGMMA_MAX_GROUPS):
        return "wgmma"
    return "fma"


def grouped_gemm_enabled() -> bool:
    """Kill switch: ``PT_GROUPED_GEMM=0`` restores the dense path."""
    return os.environ.get("PT_GROUPED_GEMM", "1") != "0"


def _segments(group_sizes, m):
    """[(group, start, end)] of the non-empty groups, clipped to ``m``
    rows (reads the sizes on the host: the plain versions only)."""
    out, start = [], 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), m)
        if end > start:
            out.append((g, start, end))
        start = end
    return out


def grouped_matmul_plain(lhs, rhs, group_sizes, trans_rhs=False):
    """The same function in plain PyTorch: one fp32 ``matmul`` per
    non-empty segment, cast once to ``lhs.dtype``. ``trans_rhs`` reads
    ``rhs`` as ``[E, n, k]``. Rows past ``sum(group_sizes)`` are zero."""
    m = lhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    parts, end = [], 0
    for g, start, end in _segments(group_sizes, m):
        w = rhs[g].float()
        parts.append((lhs[start:end].float() @ (w.T if trans_rhs else w))
                     .to(lhs.dtype))
    if end < m or not parts:
        parts.append(lhs.new_zeros((m - end, n)))
    return torch.cat(parts, 0)


def grouped_matmul_bwd_plain(lhs, rhs, group_sizes, g):
    """(dlhs, drhs) of ``grouped_matmul`` for the cotangent ``g`` [m, n] in
    plain PyTorch: ``dlhs[r] = g[r] @ rhs[g(r)]^T`` in ``lhs.dtype``,
    ``drhs[e] = lhs[seg(e)]^T @ g[seg(e)]`` in fp32, cast to ``rhs.dtype``,
    exactly 0 for an empty group."""
    dlhs = grouped_matmul_plain(g, rhs, group_sizes, trans_rhs=True)
    drhs = torch.zeros_like(rhs)
    for e, start, end in _segments(group_sizes, lhs.shape[0]):
        drhs[e] = (lhs[start:end].float().T @ g[start:end].float()).to(
            rhs.dtype)
    return dlhs.to(lhs.dtype), drhs


_sig_set = False


def _lib():
    global _sig_set
    lib = _build.library("grouped_matmul")
    if not _sig_set:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.grouped_fwd.argtypes = [i, i, i, v, v, v, v, i, i, i, i, v]
        lib.grouped_fwd.restype = ctypes.c_int
        lib.grouped_dw.argtypes = [i, i, v, v, v, v, i, i, i, i, v]
        lib.grouped_dw.restype = ctypes.c_int
        _sig_set = True
    return lib


def _check(lhs, rhs, group_sizes, trans_rhs=False):
    """The reference's shape errors, then what the kernels take."""
    kdim = 2 if trans_rhs else 1
    if lhs.ndim != 2 or rhs.ndim != 3 or rhs.shape[kdim] != lhs.shape[1]:
        raise ValueError(f"bad grouped_matmul shapes {tuple(lhs.shape)} "
                         f"{tuple(rhs.shape)}")
    if tuple(group_sizes.shape) != (rhs.shape[0],):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != "
                         f"({rhs.shape[0]},)")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"grouped_matmul: lhs {lhs.dtype} and rhs "
                        f"{rhs.dtype} differ (both bfloat16 or both float32)")
    if lhs.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"grouped_matmul takes float32 or bfloat16, got "
                        f"{lhs.dtype}")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"grouped_matmul: group_sizes must be int32, got "
                        f"{group_sizes.dtype}")


def _same_device(what, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")


def grouped_fwd_cuda(lhs, rhs, group_sizes, trans_rhs=False):
    """One launch of K6a on CUDA tensors. ``trans_rhs``: ``rhs`` is
    ``[E, n, k]`` and is read transposed. The kernel is the one
    :func:`fwd_route` names; ``group_sizes`` is not read on the host."""
    _check(lhs, rhs, group_sizes, trans_rhs)
    _same_device("grouped_matmul", lhs, rhs, group_sizes)
    # lhs 16-byte aligned for the tensor-core route's copies (a contiguous
    # view may start mid-allocation); the weights are never copied
    lhs, rhs, sizes = lhs.contiguous(), rhs.contiguous(), \
        group_sizes.contiguous()
    if lhs.data_ptr() % 16:
        lhs = lhs.clone()
    m, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    route = fwd_route(m, e, k, n, lhs.dtype, trans_rhs,
                      rhs.data_ptr() % 16 == 0)
    lib = _lib()
    rc = lib.grouped_fwd(_build.dtype_code(lhs, "grouped_matmul"),
                         int(trans_rhs), _KIND[route], _build.ptr(lhs),
                         _build.ptr(rhs), _build.ptr(sizes), _build.ptr(out),
                         m, k, n, e, _build.stream(lhs))
    _build.check(lib, rc, "grouped_matmul")
    grouped_matmul.launches += 1
    grouped_matmul.route_launches[route] += 1
    return out


def grouped_dw(lhs, g, group_sizes):
    """One launch of K6b on CUDA tensors: ``drhs`` [E, k, n] in the
    operands' type (the weights' too), zeros for empty groups. The kernel
    is the one :func:`dw_route` names; ``group_sizes`` is not read on the
    host."""
    if lhs.ndim != 2 or g.ndim != 2 or g.shape[0] != lhs.shape[0]:
        raise ValueError(f"bad grouped_dw shapes {tuple(lhs.shape)} "
                         f"{tuple(g.shape)}")
    if g.dtype != lhs.dtype:
        raise TypeError(f"grouped_dw: lhs {lhs.dtype} and g {g.dtype} differ")
    if group_sizes.dtype != torch.int32 or group_sizes.ndim != 1:
        raise TypeError("grouped_dw: group_sizes must be int32 [E]")
    _same_device("grouped_dw", lhs, g, group_sizes)
    lhs, g, sizes = lhs.contiguous(), g.contiguous(), group_sizes.contiguous()
    m, k = lhs.shape
    n, e = g.shape[1], sizes.shape[0]
    drhs = torch.empty((e, k, n), dtype=lhs.dtype, device=lhs.device)
    route = dw_route(m, e, k, n, lhs.dtype,
                     all(t.data_ptr() % 16 == 0 for t in (lhs, g, drhs)))
    lib = _lib()
    rc = lib.grouped_dw(_build.dtype_code(lhs, "grouped_dw"), _KIND[route],
                        _build.ptr(lhs), _build.ptr(g), _build.ptr(sizes),
                        _build.ptr(drhs), m, k, n, e, _build.stream(lhs))
    _build.check(lib, rc, "grouped_dw")
    grouped_dw.launches += 1
    grouped_dw.route_launches[route] += 1
    return drhs


def _fwd(lhs, rhs, group_sizes):
    if lhs.is_cuda:
        return grouped_fwd_cuda(lhs, rhs, group_sizes)
    return grouped_matmul_plain(lhs, rhs, group_sizes)


class _Grouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return _fwd(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, sizes = ctx.saved_tensors
        if not lhs.is_cuda:
            dlhs, drhs = grouped_matmul_bwd_plain(lhs, rhs, sizes, g)
            return dlhs, drhs, None
        need_lhs, need_rhs = ctx.needs_input_grad[:2]
        dlhs = (grouped_fwd_cuda(g, rhs, sizes, trans_rhs=True)
                if need_lhs else None)
        drhs = grouped_dw(lhs, g, sizes) if need_rhs else None
        return dlhs, drhs, None


def grouped_matmul(lhs, rhs, group_sizes):
    """Ragged grouped matmul: ``out[r] = lhs[r] @ rhs[group(r)]``.

    lhs ``[m, k]`` rows sorted by group with ``sum(group_sizes) == m``
    (rows past the ragged total produce unspecified output: callers that
    pad must mask); rhs ``[E, k, n]``; group_sizes ``[E]`` int32 (zeros
    fine). lhs and rhs both bfloat16 or both float32. Returns ``[m, n]`` in
    ``lhs.dtype``. Kernel on CUDA, plain on CPU; differentiable in lhs and
    rhs. When no graph is recorded the forward runs without the autograd
    ``Function``."""
    _check(lhs, rhs, group_sizes)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _Grouped.apply(lhs, rhs, group_sizes)
    return _fwd(lhs, rhs, group_sizes)


grouped_matmul.launches = 0
grouped_matmul.route_launches = {"rows": 0, "wgmma": 0, "fma": 0}
grouped_dw.launches = 0
grouped_dw.route_launches = {"wgmma": 0, "fma": 0}
