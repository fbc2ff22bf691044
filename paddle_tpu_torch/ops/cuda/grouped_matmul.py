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
device. :func:`fwd_route` names the kernel a K6a launch runs: the decode
route at the decode shape, the tensor cores (``wgmma``) for bf16 and
float16 at the prefill and train shapes, forward and dlhs alike, fp32
FMAs for float32; :func:`dw_route` the kernel of a K6b launch: the tensor
cores for bf16 and float16, fp32 FMAs for float32.
``grouped_matmul.launches`` counts K6a launches
(forward and dlhs, and the MoE layer's two fused decode products),
``grouped_matmul.route_launches`` the K6a launches of each kernel
(``"decode"``, ``"wgmma"``, ``"fma"``), ``grouped_dw.launches`` K6b
launches and ``grouped_dw.route_launches`` the K6b launches of each
kernel (``"wgmma"``, ``"fma"``).

The MoE layer's decode (``distributed/moe.py`` ``grouped_forward`` where
:func:`moe_decode_route` holds and no gradient is recorded) runs its two
expert products on the decode route with the layer's glue folded in:
:func:`moe_gate_up` reads the tokens through the route's ``tok`` in place
(no expanded copy, no gather), :func:`moe_down` forms SwiGLU from the
gate_up product on load and writes each row, weighted by its cast gate
weight, to its place in the choice-major buffer. Their plain versions
(:func:`moe_gate_up_plain`, :func:`moe_down_plain`) are the unfused
composition step by step.

``PT_GROUPED_GEMM=0`` (:func:`grouped_gemm_enabled`) keeps its meaning: the
MoE layer then takes its dense capacity path and never comes here.

K6a at the multi-LoRA call site (``models/paged.py`` ``_lora_add``) is two
kernels of ``csrc/grouped_lora.cu`` shaped for the rank-r products:
:func:`lora_shrink` (``t = x_sorted @ A[g]``, n = r, k split over blocks,
x read through the row permutation in its own type) and
:func:`lora_expand_add` (``y[src] += cast(t @ B[g])`` in place on the live
rows). Each has its plain version beside it (:func:`lora_shrink_plain`,
:func:`lora_expand_add_plain`: the unfused arithmetic of ``_lora_delta``
step by step) and counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.cuda import _build

# mean rows per group at or below which K6a takes its decode route (a few
# rows spread over many groups, each group's weights streamed once), and
# the rows and groups whose tables the route's kernel keeps in shared
# memory
DECODE_MAX_ROWS_PER_GROUP = 8
DECODE_MAX_ROWS = 1024
DECODE_MAX_GROUPS = 256
# the kernel code grouped_fwd in csrc/grouped_matmul.cu takes for a route
_KIND = {"fma": 0, "decode": 1, "wgmma": 2}
# the 2-byte types the tensor-core routes of K6a and K6b take
HALF_TYPES = (torch.bfloat16, torch.float16)


def fwd_route(m, e, k, n, dtype, trans=False, aligned=True) -> str:
    """The kernel one K6a launch of ``lhs [m, k]`` against ``E = e``
    groups' weights (``[e, k, n]``, or ``[e, n, k]`` read transposed when
    ``trans``: the backward's dlhs) runs, from the static shapes, the dtype
    and whether the weights are 16-byte aligned (``aligned``) alone:

    * ``"decode"``: the decode route, for at most
      ``DECODE_MAX_ROWS_PER_GROUP`` rows a group on average (and at most
      ``DECODE_MAX_ROWS`` rows and ``DECODE_MAX_GROUPS`` groups), k and n
      whole numbers of 16-byte pieces, no transposed weights;
    * ``"wgmma"``: bf16 or f16 on the tensor cores (k and n multiples of
      8);
    * ``"fma"``: fp32 FMAs, for float32 and whatever the other two refuse.

    Every route is a kernel: a CUDA tensor never reaches
    :func:`grouped_matmul_plain`."""
    vec = 16 // dtype.itemsize
    if (not trans and m <= DECODE_MAX_ROWS_PER_GROUP * e
            and m <= DECODE_MAX_ROWS and e <= DECODE_MAX_GROUPS
            and k % vec == 0 and n % vec == 0 and aligned):
        return "decode"
    if dtype in HALF_TYPES and k % 8 == 0 and n % 8 == 0 and aligned:
        return "wgmma"
    return "fma"


def moe_decode_route(m, e, h, inter, dtype, aligned=True) -> bool:
    """Whether an MoE layer of hidden size ``h`` and ``e`` experts of
    ``inter`` runs its ``m`` sorted rows (tokens x top-k) through
    :func:`moe_gate_up` and :func:`moe_down`: both of its products
    (``[m, h] @ [e, h, 2 inter]``, ``[m, inter] @ [e, inter, h]``) on the
    decode route, from the static shapes, the dtype and the weights'
    alignment alone."""
    return (dtype in _build.DTYPE_CODES
            and fwd_route(m, e, h, 2 * inter, dtype, False, aligned)
            == "decode"
            and fwd_route(m, e, inter, h, dtype, False, aligned) == "decode")


# groups whose row offsets K6b's tensor-core kernel keeps in shared memory
DW_WGMMA_MAX_GROUPS = 1024


def dw_route(m, e, k, n, dtype, aligned=True) -> str:
    """The kernel one K6b launch (``drhs [e, k, n]`` from ``lhs [m, k]``
    and ``g [m, n]``) runs, from the static shapes, the dtype and whether
    lhs, g and the result are 16-byte aligned (``aligned``) alone:

    * ``"wgmma"``: bf16 or f16 on the tensor cores (k and n multiples of 8,
      at most ``DW_WGMMA_MAX_GROUPS`` groups);
    * ``"fma"``: fp32 FMAs, for float32 and whatever ``"wgmma"`` refuses.

    ``m`` does not choose (the group sizes stay on the device); every
    route is a kernel: a CUDA tensor never reaches the plain version."""
    if (dtype in HALF_TYPES and k % 8 == 0 and n % 8 == 0 and aligned
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
        lib.grouped_decode.argtypes = [i, i, v, v, v, v, v, v, v, i, i, i,
                                       i, v]
        lib.grouped_decode.restype = ctypes.c_int
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
                        f"{rhs.dtype} differ (both float32, bfloat16 or "
                        f"float16)")
    if lhs.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"grouped_matmul takes float32, bfloat16 or "
                        f"float16, got "
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
    _build.count(grouped_matmul, lhs)
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
    _build.count(grouped_dw, lhs)
    grouped_dw.route_launches[route] += 1
    return drhs


# ------------------------------------- K6a at the MoE layer's decode shape
def moe_gate_up_plain(xt, tok, gate_up, group_sizes):
    """``gu[i] = xt[tok[i]] @ gate_up[g(i)]`` in plain PyTorch, as the
    unfused layer computes it: the tokens gathered into sorted rows, then
    :func:`grouped_matmul_plain`."""
    return grouped_matmul_plain(xt.index_select(0, tok), gate_up,
                                group_sizes)


def moe_down_plain(gu, down, group_sizes, gate, keep, order):
    """The down product and the combine's weighting and unsort in plain
    PyTorch, as the unfused layer computes them: ``act = F.silu(gate half)
    * up half`` of ``gu``, :func:`grouped_matmul_plain` against ``down``,
    each row times ``(gate * keep).to(dtype)``, row i put at ``order[i]``
    of the choice-major buffer. Returns that buffer ``[m, h]``."""
    g, u = torch.chunk(gu, 2, dim=-1)
    y = grouped_matmul_plain(F.silu(g) * u, down, group_sizes)
    wgt = (gate * keep).to(y.dtype)
    return torch.empty_like(y).index_copy_(0, order, y * wgt[:, None])


def _decode_check(what, lhs, rhs, group_sizes, rows, kdim):
    """What both versions of a fused decode product take: lhs [*, kdim]
    and rhs [e, k, n] of one type, group_sizes [e] int32, the per-row
    index tensors in ``rows`` ([m] each) on lhs's device."""
    if lhs.ndim != 2 or rhs.ndim != 3 or lhs.shape[1] != kdim:
        raise ValueError(f"{what}: bad shapes {tuple(lhs.shape)} "
                         f"{tuple(rhs.shape)}")
    if lhs.dtype != rhs.dtype or lhs.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: lhs {lhs.dtype} and rhs {rhs.dtype} must "
                        f"both be float32, bfloat16 or float16")
    if group_sizes.dtype != torch.int32 or tuple(group_sizes.shape) != (
            rhs.shape[0],):
        raise TypeError(f"{what}: group_sizes must be int32 "
                        f"({rhs.shape[0]},)")
    m = rows[0].shape[0]
    if any(t.ndim != 1 or t.shape[0] != m for t in rows):
        raise ValueError(f"{what}: per-row tensors "
                         f"{[tuple(t.shape) for t in rows]} differ")
    _same_device(what, lhs, rhs, group_sizes, *rows)
    return m


def _decode_launch(what, down, lhs, idx, rhs, group_sizes, gate, keep, m, k,
                   n, out=None):
    """One launch of K6a's decode route through the ``grouped_decode``
    entry point (the wrapper's counts: a ``grouped_fwd`` launch on the
    ``"decode"`` route), into ``out`` [m, n] when given (its rows past
    the groups' total are left as they are)."""
    e = rhs.shape[0]
    if fwd_route(m, e, k, n, lhs.dtype, False,
                 rhs.data_ptr() % 16 == 0) != "decode":
        raise ValueError(f"{what}: K6a's decode route does not take m {m}, "
                         f"{e} groups, k {k}, n {n} ({lhs.dtype}; see "
                         f"moe_decode_route)")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    if lhs.data_ptr() % 16:
        lhs = lhs.clone()
    idx, sizes = idx.contiguous(), group_sizes.contiguous()
    if out is None:
        out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    elif (tuple(out.shape) != (m, n) or out.dtype != lhs.dtype
          or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be contiguous {lhs.dtype} "
                         f"({m}, {n})")
    lib = _lib()
    rc = lib.grouped_decode(_build.dtype_code(lhs, what), int(down),
                            _build.ptr(lhs), _build.ptr(idx),
                            _build.ptr(rhs), _build.ptr(sizes),
                            _build.ptr(gate), _build.ptr(keep),
                            _build.ptr(out), m, k, n, e, _build.stream(lhs))
    _build.check(lib, rc, what)
    _build.count(grouped_matmul, lhs)
    grouped_matmul.route_launches["decode"] += 1
    return out


def moe_gate_up(xt, tok, gate_up, group_sizes):
    """The MoE layer's gate_up product at the decode shape: ``gu[i] =
    xt[tok[i]] @ gate_up[g(i)]`` for the m sorted rows, xt [T, h] the
    layer's tokens (read in place through ``tok`` [m] int64: no gathered
    copy), gate_up [e, h, 2 inter], group_sizes [e] int32. Returns gu [m,
    2 inter] in xt's type. On CUDA tensors one launch of K6a's decode
    route (or a ValueError where :func:`moe_decode_route` does not hold),
    else :func:`moe_gate_up_plain`."""
    m = _decode_check("moe_gate_up", xt, gate_up, group_sizes, (tok,),
                      gate_up.shape[1])
    if tok.dtype != torch.int64:
        raise TypeError(f"moe_gate_up: tok must be int64, got {tok.dtype}")
    if not xt.is_cuda:
        return moe_gate_up_plain(xt, tok, gate_up, group_sizes)
    return _decode_launch("moe_gate_up", 0, xt, tok, gate_up, group_sizes,
                          None, None, m, xt.shape[1], gate_up.shape[2])


def moe_down(gu, down, group_sizes, gate, keep, order):
    """The MoE layer's down product at the decode shape with the combine's
    weighting and unsort folded in: ``out[order[i]] = (F.silu(gu_gate[i])
    * gu_up[i]) @ down[g(i)] * (gate[i] * keep[i])``, each step rounded to
    gu's type as the unfused layer rounds it. gu [m, 2 inter] (from
    :func:`moe_gate_up`), down [e, inter, h], group_sizes [e] int32, gate
    [m] float32, keep [m] bool and order [m] int64 in sorted order (the
    route's). Returns the choice-major buffer [m, h] (a dropped
    assignment's row is its product times 0). Rows past
    ``sum(group_sizes)`` are left unwritten on the card (zeros scattered
    by the plain version); the MoE layer's counts cover every row. On CUDA
    tensors one launch of K6a's decode route, else
    :func:`moe_down_plain`."""
    if gu.ndim != 2 or gu.shape[1] % 2:
        raise ValueError(f"moe_down: gu {tuple(gu.shape)} is not [m, 2 "
                         f"inter]")
    m = _decode_check("moe_down", gu, down, group_sizes, (gate, keep, order),
                      2 * down.shape[1])
    if (gate.dtype != torch.float32 or keep.dtype != torch.bool
            or order.dtype != torch.int64):
        raise TypeError(f"moe_down: gate float32, keep bool and order int64, "
                        f"got {gate.dtype}, {keep.dtype}, {order.dtype}")
    if not gu.is_cuda:
        return moe_down_plain(gu, down, group_sizes, gate, keep, order)
    return _decode_launch("moe_down", 1, gu, order, down, group_sizes,
                          gate.contiguous(), keep.contiguous(), m,
                          down.shape[1], down.shape[2])


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
    fine). lhs and rhs both float32, bfloat16 or float16. Returns ``[m, n]`` in
    ``lhs.dtype``. Kernel on CUDA, plain on CPU; differentiable in lhs and
    rhs. When no graph is recorded the forward runs without the autograd
    ``Function``."""
    _check(lhs, rhs, group_sizes)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _Grouped.apply(lhs, rhs, group_sizes)
    return _fwd(lhs, rhs, group_sizes)


# ------------------------------------------------ K6a at the LoRA call site
# the rows of one group a shrink block of csrc/grouped_lora.cu owns, and
# the largest rank the expand keeps in registers
LORA_SHRINK_ROWS = 16
LORA_MAX_RANK = 64
# shrink blocks a launch aims at for each SM (the split of k fills them)
_LORA_BLOCKS_PER_SM = 4


def lora_shrink_schedule(m, e, k, r, sms=132):
    """(splits, ks): the shrink of ``m`` sorted rows over ``e`` groups cuts
    k into ``splits`` runs of ``ks`` rows, from the static shapes alone.
    A pass of a block covers ``2048 / jq`` k rows (``jq`` = 1, 2 or 4
    lanes across the columns for r <= 4, <= 8, above), ``ks`` is a whole
    number of passes, and the splits are as many as make the grid about
    ``_LORA_BLOCKS_PER_SM`` blocks an SM over the static bound of row
    tiles, ``ceil(m / LORA_SHRINK_ROWS) + e`` (the decode shape: 8 splits
    of 512 at k = 4096; prefill: 4 of 1024)."""
    jq = 1 if r <= 4 else 2 if r <= 8 else 4
    kp = 2048 // jq
    blocks = (-(-m // LORA_SHRINK_ROWS) + e) * -(-r // (4 * jq))
    passes = -(-k // kp)
    splits = min(passes, max(1, _LORA_BLOCKS_PER_SM * sms // blocks))
    ks = -(-passes // splits) * kp
    return -(-k // ks), ks


def lora_shrink_plain(x, perm, a_stack, gs):
    """``t = float(x)[perm] @ A[g]`` in plain PyTorch, as the unfused
    correction computes it: x [B, S, k] cast to fp32, its rows permuted
    by ``perm`` [B] and flattened to [B*S, k], then
    :func:`grouped_matmul_plain` against ``a_stack`` [cap, k, r] over the
    token counts ``gs`` [cap]. Returns t fp32 [B*S, r], 0 past
    ``sum(gs)``."""
    b, s, k = x.shape
    xp = x.float()[perm.long()].reshape(b * s, k)
    return grouped_matmul_plain(xp, a_stack, gs)


def lora_expand_add_plain(y, t, b_stack, gs, perm):
    """``y += cast(t @ B[g])`` in plain PyTorch, as the unfused correction
    computes it: :func:`grouped_matmul_plain` of t [B*S, r] against
    ``b_stack`` [cap, r, n], rows past ``sum(gs)`` masked to 0, the rows
    put back in source order (the inverse of ``perm``), cast to y's type
    and added to y [B, S, n] in place (a masked row adds 0). Returns
    y."""
    b, s, n = y.shape
    d = grouped_matmul_plain(t, b_stack, gs)
    live = torch.arange(b * s, device=y.device)[:, None] < gs.sum()
    d = torch.where(live, d, 0.0)
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(b, dtype=perm.dtype, device=perm.device)
    return y.add_(d.reshape(b, s, n)[inv.long()].to(y.dtype))


_lora_sig_set = False


def _lora_lib():
    global _lora_sig_set
    lib = _build.library("grouped_lora")
    if not _lora_sig_set:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.lora_shrink.argtypes = [i, v, v, v, v, v, v, i, i, i, i, i, i, i,
                                    v]
        lib.lora_shrink.restype = ctypes.c_int
        lib.lora_expand_add.argtypes = [i, v, v, v, v, v, i, i, i, i, i, v]
        lib.lora_expand_add.restype = ctypes.c_int
        _lora_sig_set = True
    return lib


def _lora_check(what, act, w, gs, perm, kdim):
    """The shapes and types both versions take: ``act`` [B, S, width]
    float32, bfloat16 or float16, ``w`` [cap, ...] float32 whose dim ``kdim``
    matches ``act``'s last, ``gs`` [cap] and ``perm`` [B] int32."""
    if act.ndim != 3 or w.ndim != 3 or w.shape[kdim] != act.shape[2]:
        raise ValueError(f"{what}: bad shapes {tuple(act.shape)} "
                         f"{tuple(w.shape)}")
    if tuple(gs.shape) != (w.shape[0],) or tuple(perm.shape) != (
            act.shape[0],):
        raise ValueError(f"{what}: gs {tuple(gs.shape)} must be "
                         f"({w.shape[0]},), perm {tuple(perm.shape)} "
                         f"({act.shape[0]},)")
    if act.dtype not in _build.DTYPE_CODES or w.dtype != torch.float32:
        raise TypeError(f"{what}: activations float32, bfloat16 or "
                        f"float16 and float32 adapter stacks, got {act.dtype}, "
                        f"{w.dtype}")
    if gs.dtype != torch.int32 or perm.dtype != torch.int32:
        raise TypeError(f"{what}: gs and perm must be int32, got "
                        f"{gs.dtype}, {perm.dtype}")


def _lora_kernel_takes(what, tensors, aligned):
    """What the kernels of csrc/grouped_lora.cu take beyond the shapes:
    contiguous tensors, the ``aligned`` ones on 16 bytes."""
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{what}: the CUDA kernel takes 16-byte-aligned "
                         f"activations and adapter stacks")


def lora_shrink(x, perm, a_stack, gs):
    """``t[i] = float(x[src(i)]) @ A[g(i)]`` for the sorted rows i of a
    multi-LoRA batch: x [B, S, k] (float32, bfloat16 or float16), ``perm`` [B]
    int32, a permutation of ``range(B)`` (sorted row i is source row
    ``(perm[i // S], i % S)``),
    ``a_stack`` [cap, k, r] float32, ``gs`` [cap] int32 token counts in
    sorted order. Returns t float32 [B*S, r], 0 for rows past ``sum(gs)``.
    On CUDA tensors one launch of the shrink kernel (k a multiple of 8,
    contiguous 16-byte-aligned x and A; ``gs`` is never read on the host),
    else :func:`lora_shrink_plain`."""
    _lora_check("lora_shrink", x, a_stack, gs, perm, 1)
    _same_device("lora_shrink", x, perm, a_stack, gs)
    if not x.is_cuda:
        return lora_shrink_plain(x, perm, a_stack, gs)
    b, s, k = x.shape
    cap, _, r = a_stack.shape
    if k % 8:
        raise ValueError(f"lora_shrink: the CUDA kernel takes k a multiple "
                         f"of 8, got {k}")
    _lora_kernel_takes("lora_shrink", (x, perm, a_stack, gs), (x, a_stack))
    lib = _lora_lib()
    m = b * s
    splits, ks = lora_shrink_schedule(
        m, cap, k, r,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    part = torch.empty((splits, m, r), dtype=torch.float32, device=x.device)
    t = torch.empty((m, r), dtype=torch.float32, device=x.device)
    rc = lib.lora_shrink(_build.dtype_code(x, "lora_shrink"), _build.ptr(x),
                         _build.ptr(perm), _build.ptr(a_stack),
                         _build.ptr(gs), _build.ptr(part), _build.ptr(t),
                         m, s, k, r, cap, splits, ks, _build.stream(x))
    _build.check(lib, rc, "lora_shrink")
    _build.count(lora_shrink, x)
    return t


def lora_expand_add(y, t, b_stack, gs, perm):
    """``y[src(i)] = cast_y(float(y[src(i)]) + float(cast_y(t[i] @
    B[g(i)])))`` for every live sorted row i (``i < sum(gs)``), in place:
    y [B, S, n] (float32, bfloat16 or float16: the projection's output, in the
    type of the activations the correction came from), t float32 [B*S, r]
    (:func:`lora_shrink`), ``b_stack`` [cap, r, n] float32, ``gs`` and
    ``perm`` as there. The correction is an fp32 sum over r rounded once
    to y's type, then added in fp32 and rounded once: the rounding of the
    unfused ``y + d.to(y.dtype)``. Returns y. On CUDA tensors one launch
    of the expand kernel, which leaves the rows past ``sum(gs)`` untouched
    (r <= LORA_MAX_RANK, n a multiple of 4, contiguous 16-byte-aligned y
    and B); else :func:`lora_expand_add_plain`, which adds a masked 0 to
    them (a -0.0 there becomes +0.0: the values compare equal)."""
    _lora_check("lora_expand_add", y, b_stack, gs, perm, 2)
    b, s, n = y.shape
    cap, r, _ = b_stack.shape
    if tuple(t.shape) != (b * s, r) or t.dtype != torch.float32:
        raise ValueError(f"lora_expand_add: t must be float32 "
                         f"({b * s}, {r}), got {t.dtype} {tuple(t.shape)}")
    _same_device("lora_expand_add", y, t, b_stack, gs, perm)
    if not y.is_cuda:
        return lora_expand_add_plain(y, t, b_stack, gs, perm)
    if r > LORA_MAX_RANK or n % 4:
        raise ValueError(f"lora_expand_add: the CUDA kernel takes rank <= "
                         f"{LORA_MAX_RANK} and n a multiple of 4, got r "
                         f"{r}, n {n}")
    _lora_kernel_takes("lora_expand_add", (y, t, b_stack, gs, perm),
                       (y, b_stack))
    lib = _lora_lib()
    rc = lib.lora_expand_add(_build.dtype_code(y, "lora_expand_add"),
                             _build.ptr(y), _build.ptr(t),
                             _build.ptr(b_stack), _build.ptr(gs),
                             _build.ptr(perm), b * s, s, n, r, cap,
                             _build.stream(y))
    _build.check(lib, rc, "lora_expand_add")
    _build.count(lora_expand_add, y)
    return y


grouped_matmul.launches = 0
grouped_matmul.route_launches = {"decode": 0, "wgmma": 0, "fma": 0}
grouped_dw.launches = 0
grouped_dw.route_launches = {"wgmma": 0, "fma": 0}
lora_shrink.launches = 0
lora_expand_add.launches = 0
for _fn in (grouped_matmul, grouped_dw, lora_shrink, lora_expand_add):
    _fn.f16 = _build.f16_counter()
