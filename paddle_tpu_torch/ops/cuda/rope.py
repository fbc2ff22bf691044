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

:func:`rope_kv_write` is K7 folded with the decode tick's KV pool write
(``models/paged.py`` ``llama_decode_step_paged`` over a pool of the
model's type): q and k rotated and k and v written into the layer's pools
at each row's pool position in one launch, bit for bit the unfused
composition (:func:`rope_kv_write_plain`: ``fused_rope_plain`` on q and
on k, then the pools' ``index_put_``). ``rope_kv_write.launches`` counts
its launches.
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
        lib.rope_kv_write.argtypes = [i, i, v, v, v, ll, ll, ll, v, v, v, v,
                                      v, v, i, i, i, i, ll, v]
        lib.rope_kv_write.restype = ctypes.c_int
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
    _build.count(fused_rope, x)
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
    """x [..., H, D] (bf16, f16 or fp32; a strided q/k view is read in place),
    cos/sin fp32 [R, D/2] with R dividing the row count -> contiguous, like
    x. Kernel on CUDA, plain on CPU; differentiable in x. When no graph is
    recorded the forward runs without the autograd ``Function``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, cos, sin)
    return _rope_fwd(x, cos, sin)


def _pool_write(pool, vals, dest):
    """``vals`` [B, 1, H, D] into ``pool`` [N + 1, bs, H, D] at the flat
    pool positions ``dest`` [B] (the paged forwards' ``_scatter``)."""
    flat = pool.view(-1, *pool.shape[2:])
    flat.index_put_((dest.reshape(-1),),
                    vals.reshape(-1, *pool.shape[2:]).to(pool.dtype))


def rope_kv_write_plain(q, k, v, cos, sin, k_pool, v_pool, dest):
    """The unfused composition in plain PyTorch: ``fused_rope_plain`` on q
    and on k, then k rotated and v written into the pools at ``dest``.
    Returns q rotated (contiguous, shaped like q)."""
    q_rot = fused_rope_plain(q, cos, sin)
    _pool_write(k_pool, fused_rope_plain(k, cos, sin), dest)
    _pool_write(v_pool, v, dest)
    return q_rot


def _kv_check(q, k, v, k_pool, v_pool, dest):
    """The shapes and types both versions take."""
    if (q.ndim != 4 or k.ndim != 4 or q.shape[1] != 1
            or k.shape != v.shape or k.shape[:2] != q.shape[:2]
            or k.shape[3] != q.shape[3]):
        raise ValueError(f"rope_kv_write: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, 1, H, D] decode rows")
    if (k_pool.ndim != 4 or k_pool.shape != v_pool.shape
            or tuple(k_pool.shape[2:]) != tuple(k.shape[2:])):
        raise ValueError(f"rope_kv_write: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} for k {tuple(k.shape)}")
    if tuple(dest.shape) != (q.shape[0],) or dest.dtype != torch.int64:
        raise ValueError(f"rope_kv_write: dest must be int64 "
                         f"({q.shape[0]},), got {dest.dtype} "
                         f"{tuple(dest.shape)}")
    if not (q.dtype == k.dtype == v.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError(f"rope_kv_write: q/k/v {q.dtype} and pools "
                        f"{k_pool.dtype} differ (an int8 pool keeps the "
                        f"unfused write)")


def rope_kv_write(q, k, v, cos, sin, k_pool, v_pool, dest):
    """One decode step's rope and pool write of one layer: q [B, 1, Hq,
    D], k and v [B, 1, Hkv, D] (strided views of the fused QKV product are
    read in place), cos/sin fp32 [R, D/2] with R dividing B, the layer's
    pools ``k_pool``/``v_pool`` [N + 1, bs, Hkv, D] of q's type, ``dest``
    [B] int64 flat pool positions. Writes k rotated and v at ``dest``;
    returns q rotated (contiguous [B, 1, Hq, D]). On CUDA tensors one
    launch of the fold (contiguous pools), else
    :func:`rope_kv_write_plain`."""
    _kv_check(q, k, v, k_pool, v_pool, dest)
    if not q.is_cuda:
        return rope_kv_write_plain(q, k, v, cos, sin, k_pool, v_pool, dest)
    code = _build.dtype_code(q, "rope_kv_write")
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    _, r, c, s = _tables(q, cos, sin)
    if any(t.get_device() != q.get_device()
           for t in (k, v, c, s, k_pool, v_pool, dest)):
        raise ValueError("rope_kv_write: tensors on different devices")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("rope_kv_write: the CUDA kernel writes contiguous "
                         "pools")
    c, s, dest = c.contiguous(), s.contiguous(), dest.contiguous()
    (qr, sq), (kr, sk), (vr, sv) = _rows_view(q), _rows_view(k), \
        _rows_view(v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    es = q.element_size()
    ptrs = [t.data_ptr() for t in (qr, kr, vr, c, s, out, k_pool, v_pool)]
    vec = ((d // 2) % (16 // es) == 0
           and all((st * es) % 16 == 0 for st in (sq, sk, sv))
           and all(p % 16 == 0 for p in ptrs))
    lib = _lib()
    rc = lib.rope_kv_write(code, 16 if vec else 1, qr.data_ptr(),
                           kr.data_ptr(), vr.data_ptr(), sq, sk, sv,
                           c.data_ptr(), s.data_ptr(), out.data_ptr(),
                           k_pool.data_ptr(), v_pool.data_ptr(),
                           dest.data_ptr(), b, hq, hkv, d, r,
                           _build.stream(q))
    _build.check(lib, rc, "rope_kv_write")
    _build.count(rope_kv_write, q)
    return out


fused_rope.launches = 0
fused_rope.f16 = _build.f16_counter()
rope_kv_write.launches = 0
rope_kv_write.f16 = _build.f16_counter()
