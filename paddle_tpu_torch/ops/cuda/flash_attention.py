"""K2 and K5: flash attention, forward and backward — counterpart of
``paddle_tpu/ops/pallas/flash_attention.py`` (``flash_attention``: the
forward ``_fwd_kernel`` and the backward ``_dq_kernel`` / ``_dkv_kernel``
of ``_flash_bwd``).

``flash_attention`` is a :class:`torch.autograd.Function` (the counterpart
of the reference's ``custom_vjp``). On CUDA tensors its forward launches
``csrc/flash_fwd.cu`` (K2), which also writes the log-sum-exp, and its
backward launches the two kernels of ``csrc/flash_bwd.cu`` (K5a dq, K5b
dk/dv) from the saved O and LSE; a CUDA tensor the kernels cannot take
raises. :func:`kernel_route` names the kernel K2, K5a and K5b run for a
dtype and head dim (:data:`HEAD_DIMS`: 64, 80, 128, 256): bf16 and float16
run on the tensor cores (``wgmma``, see ``csrc/hopper_mma.cuh``), float32 on fp32
FMAs (exact to 1e-4). On CPU tensors the same ``Function`` runs
:func:`flash_attention_fwd_plain` and :func:`flash_attention_bwd_plain`.
``kv_lens`` and the ALiBi slopes get no gradient. Launch counters:
``flash_attention.launches`` (K2), ``flash_bwd_dq.launches`` (K5a),
``flash_bwd_dkv.launches`` (K5b); the ALiBi mode of each is counted apart,
in :data:`flash_fwd_alibi`, :data:`flash_bwd_dq_alibi` and
:data:`flash_bwd_dkv_alibi`.

ALiBi (the reference's ``_alibi_add``): ``alibi_slopes`` [H] or [B, H]
positive fp32 slopes m, indexed by the query head (not the KV head under
GQA), add ``-m * (q_pos - k_pos)`` to the scaled scores under ``causal``
and ``-m * |q_pos - k_pos|`` without it, before the masks, with the
masks' query positions (:func:`_masked_scores`).

As in the reference, query rows in the padding of a ``kv_lens`` batch
are unspecified under ``causal``: callers mask them out, and give them a
zero cotangent, which also makes their gradients zero.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from paddle_tpu_torch.ops.cuda import _build

# head dims the three kernels are built for: 80 is Phi-2's (kept at a
# padded width with zero columns: 128 on the tensor cores, 96 on the FMA
# route), 256 Gemma's and GPT-J's (K5b's tensor-core route splits dK and
# dV over two blocks there)
HEAD_DIMS = (64, 80, 128, 256)
# the kernel each of ROUTED launches for each input dtype
ROUTES = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
          torch.float32: "fma"}
# the kernels whose route kernel_route names: K2, K5a (dq), K5b (dk/dv)
ROUTED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# most-negative bf16-representable, as in ops/attention.py
_NEG_INF = -2.3819763e38

# launches of the ALiBi mode of K2 / K5a / K5b (``ops.cuda.kernels()``)
flash_fwd_alibi = SimpleNamespace(launches=0, f16=_build.f16_counter())
flash_bwd_dq_alibi = SimpleNamespace(launches=0, f16=_build.f16_counter())
flash_bwd_dkv_alibi = SimpleNamespace(launches=0, f16=_build.f16_counter())


def _masked_scores(q, k, causal, scale, window, kv_lens, alibi_slopes=None):
    """fp32 scores [B, H, S, Sk] of q [B, S, H, D] against k [B, Sk, Hkv,
    D] (GQA by repeat) and the keep mask [B|1, 1, S, Sk] of the forward:
    causal, sliding window and ``kv_lens``, queries end-aligned to the key
    axis (to each row's valid length with ``kv_lens`` and S < Sk), the
    reference's ``_band_mask`` rule. With ``alibi_slopes`` ([H], [B, H] or
    [B * H]) the scaled scores carry the ALiBi bias from the same query
    positions (the reference's ``_q_offset``)."""
    b, s, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    dev = q.device
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, device=dev)
    kt = k.repeat_interleave(h // h_kv, dim=2) if h_kv != h else k
    scores = torch.matmul(q.transpose(1, 2).float(),
                          kt.transpose(1, 2).float().transpose(-1, -2)) * scale
    k_pos = torch.arange(sk, device=dev)
    if kv_lens is not None and s < sk:
        q_pos = (kv_lens.to(torch.int64)[:, None] - s
                 + torch.arange(s, device=dev)[None, :])
    else:
        q_pos = (torch.arange(s, device=dev) + (sk - s))[None, :]
    diff = q_pos[:, :, None] - k_pos[None, None, :]            # [B|1, S, Sk]
    if alibi_slopes is not None:
        m = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                            device=dev).detach().reshape(-1, h)
        dist = (diff if causal else diff.abs()).float()
        scores = scores - m[:, :, None, None] * dist[:, None]
    keep = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window is not None:
        keep = keep & (diff < window)
    if kv_lens is not None:
        keep = keep & (k_pos[None, None, :] < kv_lens[:, None, None])
    return scores, keep[:, None]


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None, window=None,
                              kv_lens=None, alibi_slopes=None):
    """(o, lse) in plain PyTorch: the reference's XLA attention (softmax in
    fp32, probabilities cast to the value dtype before P@V) and the
    log-sum-exp [B, H, S] fp32 of the masked scaled (and ALiBi-biased)
    scores, 0 for a row with no live key (as K2 writes it)."""
    h, h_kv = q.shape[2], k.shape[2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores, keep = _masked_scores(q, k, causal, scale, window, kv_lens,
                                  alibi_slopes)
    scores = scores.masked_fill(~keep, _NEG_INF)
    lse = torch.where(keep.any(-1), torch.logsumexp(scores, -1), 0.0)
    vt = v.repeat_interleave(h // h_kv, dim=2) if h_kv != h else v
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.matmul(probs, vt.transpose(1, 2)).transpose(1, 2)
    return o.to(q.dtype).contiguous(), lse


def flash_attention_plain(q, k, v, causal=False, scale=None, window=None,
                          kv_lens=None, alibi_slopes=None):
    """The forward's output alone, in plain PyTorch."""
    return flash_attention_fwd_plain(q, k, v, causal, scale, window,
                                     kv_lens, alibi_slopes)[0]


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None,
                              window=None, kv_lens=None, alibi_slopes=None):
    """(dq, dk, dv) in plain PyTorch: the flash-2 recomputation from the
    saved O and LSE, in fp32 — P = exp(S * scale + bias - lse) under the
    forward's masks (bias: the ALiBi term, 0 without slopes), dP = dO V^T,
    dS = P (dP - delta) scale with delta = sum(dO O), dq = dS K,
    dk = dS^T Q, dv = P^T dO, then the GQA group sum."""
    b, s, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    scores, keep = _masked_scores(q, k, causal, scale, window, kv_lens,
                                  alibi_slopes)
    p = torch.where(keep, torch.exp(scores - lse[..., None]), 0.0)
    do32 = do.transpose(1, 2).float()                         # [B, H, S, D]
    delta = (do32 * o.transpose(1, 2).float()).sum(-1, keepdim=True)
    rep = h // h_kv
    vt = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    kt = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    dp = torch.matmul(do32, vt.transpose(1, 2).float().transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kt.transpose(1, 2).float())
    dk = torch.matmul(ds.transpose(-1, -2), q.transpose(1, 2).float())
    dv = torch.matmul(p.transpose(-1, -2), do32)
    if rep > 1:      # per-q-head partials -> sum over each kv group
        dk = dk.reshape(b, h_kv, rep, sk, d).sum(2)
        dv = dv.reshape(b, h_kv, rep, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


_typed: set = set()


def _lib(name):
    """The loaded library of ``csrc/<name>.cu`` with its argtypes set."""
    lib = _build.library(name)
    if name not in _typed:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "flash_fwd":
            fns = [(lib.flash_fwd, [i, i, v, v, v, v, v, v, v, i, i, i, i, i,
                                    f, i, i, v])]
        else:
            fns = [(lib.flash_bwd_dq, [i, i, v, v, v, v, v, v, v, v, v, i, i,
                                       i, i, i, f, i, i, v]),
                   (lib.flash_bwd_dkv, [i, i, v, v, v, v, v, v, v, v, v, v, i,
                                        i, i, i, i, f, i, i, v])]
        for fn, argtypes in fns:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _typed.add(name)
    return lib


def kernel_route(dtype, head_dim):
    """The kernel K2, K5a and K5b (:data:`ROUTED`) launch for inputs of
    ``dtype`` at ``head_dim``: "wgmma" (bf16 or f16: products on the Hopper
    tensor cores, operands of q's type, fp32 accumulators; K5a rounds dS to
    q's type before dS K, as the reference does) or "fma" (float32: fp32
    FMAs on the CUDA cores). The ALiBi mode runs on the same route.
    Raises NotImplementedError for a head dim outside :data:`HEAD_DIMS`
    (64, 80, 128, 256) and TypeError for another dtype."""
    if head_dim not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash kernel head_dim {head_dim}: built for {HEAD_DIMS}")
    if dtype not in ROUTES:
        raise TypeError(f"flash kernel dtype {dtype}: built for "
                        f"{tuple(ROUTES)}")
    return ROUTES[dtype]


def _check_cuda(q, k, v, what):
    """What the CUDA kernels take: a route for q's dtype and head dim,
    matching K/V of q's batch and width, one dtype."""
    b, d = q.shape[0], q.shape[3]
    kernel_route(q.dtype, d)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{what}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{what}: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    return _build.dtype_code(q, what)


def _dense(t):
    """``t`` contiguous and 16-byte aligned, as the tensor-core kernels'
    16-byte copies read it (a contiguous view may start mid-allocation)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lens(kv_lens, q):
    if kv_lens is None:
        return None
    lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32)
    if lens.shape != (q.shape[0],):
        raise ValueError(f"kv_lens shape {tuple(lens.shape)} != "
                         f"({q.shape[0]},)")
    return lens.contiguous()


def _slopes(alibi_slopes, q):
    """The ALiBi slopes as the kernels read them: contiguous fp32 [B * H]
    (row b's head h at b * H + h), from [H] or [B, H]; detached, since
    slopes are fixed head geometry (zero cotangent, as the reference's)."""
    if alibi_slopes is None:
        return None
    b, h = q.shape[0], q.shape[2]
    m = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                        device=q.device).detach()
    if m.shape not in ((h,), (b, h)):
        raise ValueError(f"alibi_slopes shape {tuple(m.shape)}: expected "
                         f"({h},) or ({b}, {h})")
    return m.reshape(-1, h).expand(b, h).contiguous().reshape(-1)


def flash_fwd_cuda(q, k, v, causal, scale, window, lens, slopes=None):
    """One launch of K2 on CUDA tensors: (o, lse [B, H, S] fp32). ``scale``
    is a float, ``lens`` None or int32 [B] and ``slopes`` None or fp32
    [B * H] (the ALiBi mode), as :func:`flash_attention` prepares them."""
    b, s, h, d = q.shape
    sk, h_kv = k.shape[1], k.shape[2]
    code = _check_cuda(q, k, v, "flash_attention")
    q, k, v = _dense(q), _dense(k), _dense(v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _lib("flash_fwd")
    rc = lib.flash_fwd(code, d, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                       _build.ptr(lens), _build.ptr(slopes), _build.ptr(o),
                       _build.ptr(lse), b, s, sk, h, h_kv, scale,
                       int(bool(causal)), int(window or 0), _build.stream(q))
    _build.check(lib, rc, "flash_attention")
    _build.count(flash_attention if slopes is None else flash_fwd_alibi, q)
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, window, lens,
                   slopes=None):
    """(dq, dk, dv) on CUDA tensors from the forward's saved O and LSE:
    delta = sum(dO O) in fp32 (as ``_flash_bwd`` computes it outside its
    kernels), then one launch each of K5a and K5b. Arguments as for
    :func:`flash_fwd_cuda`."""
    code = _check_cuda(q, k, v, "flash_attention backward")
    if do.dtype != q.dtype:
        raise TypeError(f"flash_attention backward: dO {do.dtype} != "
                        f"q {q.dtype}")
    q, k, v, do = (_dense(t) for t in (q, k, v, do))
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    args = (code, q, k, v, do, lse.contiguous(), delta, causal, scale,
            window, lens, slopes)
    dq = flash_bwd_dq(*args)
    dk, dv = flash_bwd_dkv(*args)
    return dq, dk, dv


def flash_bwd_dq(code, q, k, v, do, lse, delta, causal, scale, window, lens,
                 slopes=None):
    """One launch of K5a (contiguous CUDA tensors, checked by
    :func:`flash_bwd_cuda`; ``code`` the dtype code): dq."""
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    lib = _lib("flash_bwd")
    rc = lib.flash_bwd_dq(
        code, d, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(lens),
        _build.ptr(slopes), _build.ptr(dq), b, s, k.shape[1], h, k.shape[2],
        scale, int(bool(causal)), int(window or 0), _build.stream(q))
    _build.check(lib, rc, "flash_bwd_dq")
    _build.count(flash_bwd_dq if slopes is None else flash_bwd_dq_alibi, q)
    return dq


def flash_bwd_dkv(code, q, k, v, do, lse, delta, causal, scale, window,
                  lens, slopes=None):
    """One launch of K5b, arguments as for :func:`flash_bwd_dq`: (dk, dv),
    the GQA group sum taken inside the kernel."""
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib("flash_bwd")
    rc = lib.flash_bwd_dkv(
        code, d, _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(lens),
        _build.ptr(slopes), _build.ptr(dk), _build.ptr(dv), b, s, k.shape[1],
        h, k.shape[2], scale, int(bool(causal)), int(window or 0),
        _build.stream(q))
    _build.check(lib, rc, "flash_bwd_dkv")
    _build.count(flash_bwd_dkv if slopes is None else flash_bwd_dkv_alibi,
                 q)
    return dk, dv


def _check_args(q, k, causal, window, kv_lens):
    s, h = q.shape[1], q.shape[2]
    sk, h_kv = k.shape[1], k.shape[2]
    if h % h_kv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if window is not None and kv_lens is not None and s != sk:
        raise NotImplementedError(
            "window + kv_lens with sq != sk (windowed decode against a "
            "padded cache) is not supported; use the paged decode kernel")


def _fwd(q, k, v, causal, scale, window, lens, slopes):
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal, scale, window, lens, slopes)
    return flash_attention_fwd_plain(q, k, v, causal, scale, window, lens,
                                     slopes)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lens, slopes, causal, scale, window):
        o, lse = _fwd(q, k, v, causal, scale, window, lens, slopes)
        ctx.save_for_backward(q, k, v, o, lse, lens, slopes)
        ctx.args = (causal, scale, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, lens, slopes = ctx.saved_tensors
        bwd = flash_bwd_cuda if q.is_cuda else flash_attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, *ctx.args, lens, slopes)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, window=None,
                    kv_lens=None, alibi_slopes=None):
    """q [B, S, H, D], k/v [B, Sk, Hkv, D] (H % Hkv == 0: GQA by index).
    ``window``: causal sliding window. ``kv_lens``: [B] valid key lengths.
    ``alibi_slopes``: [H] or [B, H] ALiBi slopes (module docstring).
    Differentiable in q, k and v; when no graph is recorded (grad mode off,
    as on the serving path, or no input requiring grad) the forward runs
    without the autograd ``Function``."""
    _check_args(q, k, causal, window, kv_lens)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    lens = _lens(kv_lens, q)
    slopes = _slopes(alibi_slopes, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, lens, slopes, causal, scale, window)
    return _fwd(q, k, v, causal, scale, window, lens, slopes)[0]


flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
for _fn in (flash_attention, flash_bwd_dq, flash_bwd_dkv):
    _fn.f16 = _build.f16_counter()
