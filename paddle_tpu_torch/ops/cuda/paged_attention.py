"""K3 and K4: paged attention — counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``.

* :func:`paged_decode_attention` (K4, ``csrc/paged_decode.cu``): one
  query per sequence over its block-table row.
* :func:`paged_chunk_attention` (K3, ``csrc/paged_chunk.cu``): ragged
  multi-query causal attention for chunked prefill.

On CUDA tensors each launches its kernel or raises; on CPU tensors each
runs its plain version (``*_plain``: the reference's gather-based XLA
path, ported). Unused table slots hold the sentinel ``N =
k_pool.shape[0]``: both paths clamp it (``jnp.take`` clamps, torch
indexing does not) and mask it by length.

``k_scale``/``v_scale`` [N, bs, Hkv] fp32 mark an int8 pool (per-(position,
KV head) absmax scales): both kernels read the codes and dequantize them
on load, the plain versions gather the scale rows with the blocks. The
launches of the two modes are counted apart: ``.launches`` on each
wrapper for a pool of q's type, :data:`paged_decode_i8` /
:data:`paged_chunk_i8` for an int8 pool. ``partials`` (the
context-parallel merge) is not ported yet: ROADMAP.md queue 2.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from paddle_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)
GROUPS = (1, 2, 4, 8)

# launches of the int8-pool mode of K4 / K3 (``ops.cuda.kernels()``)
paged_decode_i8 = SimpleNamespace(launches=0)
paged_chunk_i8 = SimpleNamespace(launches=0)


def _refuse(partials, what):
    if partials:
        raise NotImplementedError(
            f"{what}: partials (context-parallel merge) are not ported yet "
            "(ROADMAP.md queue 2, with cp serving in queue 1)")


def _check_pool(q, k_pool, v_pool, k_scale, v_scale, what):
    d = q.shape[-1]
    n, bs, h_kv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} for head_dim {d}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"{what}: head_dim {d}: built for {HEAD_DIMS}")
    h = q.shape[-2]
    if h % h_kv or h // h_kv not in GROUPS:
        raise NotImplementedError(
            f"{what}: {h} query heads over {h_kv} kv heads: group sizes "
            f"{GROUPS} are built")
    pools = (k_pool, v_pool)
    if k_scale is None:
        if not (q.dtype == k_pool.dtype == v_pool.dtype):
            raise TypeError(f"{what}: q {q.dtype} vs pools {k_pool.dtype}")
    else:
        if v_scale is None or not (k_pool.dtype == v_pool.dtype
                                   == torch.int8):
            raise TypeError(f"{what}: scales need int8 pools and both "
                            f"k_scale and v_scale (pools {k_pool.dtype})")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (n, bs, h_kv):
                raise ValueError(f"{what}: scale {sc.dtype} "
                                 f"{tuple(sc.shape)} for pool "
                                 f"{tuple(k_pool.shape)}: fp32 [N, bs, Hkv]")
        # K4 loads a lane's D/32 codes as one word
        if any(t.data_ptr() % 4 for t in pools):
            raise ValueError(f"{what}: int8 pools must be 4-byte aligned")
        pools += (k_scale, v_scale)
    for t in pools:
        if not t.is_contiguous():
            raise ValueError(f"{what}: pools must be contiguous")
    return n, bs, h_kv


def _gather(pool, scale, tables, rows, b, h_kv, d):
    """Each row's whole table view of ``pool`` [N, bs, Hkv, D] as
    [b, rows, Hkv, D]; an int8 pool dequantized in fp32 with its gathered
    scale rows (``k.float() * scale``, as the reference's XLA path)."""
    g = pool[tables].reshape(b, rows, h_kv, d)
    if scale is None:
        return g
    return g.float() * scale[tables].reshape(b, rows, h_kv, 1)


def _check_rows(rows, block_tables, per_row, what):
    """One table row and one entry of each per-row array per batch row."""
    if block_tables.dim() != 2 or block_tables.shape[0] != rows or any(
            tuple(torch.as_tensor(x).shape) != (rows,) for x in per_row):
        raise ValueError(f"{what}: block_tables {tuple(block_tables.shape)} "
                         f"or per-row lengths do not match {rows} rows")


def _i32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


# ----------------------------------------------------------- decode (K4)

def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lens, *,
                                 scale=None, window=None, k_scale=None,
                                 v_scale=None):
    """Gather-based plain version: q [B, H, D], pools [N, bs, Hkv, D]
    (int8 with ``k_scale``/``v_scale`` [N, bs, Hkv]), block_tables [B, MB],
    lens [B] (including the new token)."""
    b, h, d = q.shape
    n, bs, h_kv, _ = k_pool.shape
    scale = scale if scale is not None else d ** -0.5
    rows = block_tables.shape[1] * bs
    tables = torch.clamp(block_tables.long(), max=n - 1)
    k = _gather(k_pool, k_scale, tables, rows, b, h_kv, d)
    v = _gather(v_pool, v_scale, tables, rows, b, h_kv, d)
    if h_kv != h:
        rep = h // h_kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    pos = torch.arange(rows, device=q.device)[None, None, :]
    lens = lens.to(q.device)[:, None, None]
    keep = pos < lens
    if window is not None:
        keep = keep & (pos >= lens - window)
    s = torch.where(keep, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


_dec_sig = False


def _dec_lib():
    global _dec_sig
    lib = _build.library("paged_decode")
    if not _dec_sig:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_fwd.argtypes = [i, i, v, v, v, v, v, v, v, v, i, i,
                                         i, i, i, i, ctypes.c_float, i, v]
        lib.paged_decode_fwd.restype = ctypes.c_int
        _dec_sig = True
    return lib


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens, *,
                           scale=None, window=None, k_scale=None,
                           v_scale=None, partials=False):
    """One decode step over block tables; returns [B, H, D]. Rows with
    ``lens == 0`` give 0 on the card (the plain version averages V there;
    callers discard such rows). ``k_scale``/``v_scale``: an int8 pool."""
    _refuse(partials, "paged_decode_attention")
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lens, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale)
    n, bs, h_kv = _check_pool(q, k_pool, v_pool, k_scale, v_scale,
                              "paged_decode_attention")
    b, h, d = q.shape
    _check_rows(b, block_tables, (lens,), "paged_decode_attention")
    code = _build.dtype_code(q, "paged_decode_attention")
    q = q.contiguous()
    tables = _i32(block_tables, q.device)
    lens_t = _i32(lens, q.device)
    o = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _dec_lib()
    rc = lib.paged_decode_fwd(code, d, _build.ptr(q), _build.ptr(k_pool),
                              _build.ptr(v_pool), _build.ptr(k_scale),
                              _build.ptr(v_scale), _build.ptr(tables),
                              _build.ptr(lens_t), _build.ptr(o), b, h, h_kv,
                              n, bs, tables.shape[1], scale,
                              int(window or 0), _build.stream(q))
    _build.check(lib, rc, "paged_decode_attention")
    (paged_decode_attention if k_scale is None
     else paged_decode_i8).launches += 1
    return o


paged_decode_attention.launches = 0


# ------------------------------------------------------------ chunk (K3)

def paged_chunk_attention_plain(q, k_pool, v_pool, block_tables, offsets,
                                chunk_lens, *, scale=None, window=None,
                                k_scale=None, v_scale=None):
    """Gather-based plain version: materialise each row's whole
    ``max_blocks*bs`` pool view (an int8 pool dequantized in fp32) and run
    dense masked attention (the reference's ``paged_chunk_attention_xla``);
    the result in q's type. Rows with ``chunk_lens == 0`` and padding
    query rows are unspecified here (0 on the card)."""
    from paddle_tpu_torch.ops.attention import eager_attention
    a, c, h, d = q.shape
    n, bs, h_kv, _ = k_pool.shape
    rows = block_tables.shape[1] * bs
    dev = q.device
    offsets = torch.as_tensor(offsets, device=dev).long()
    chunk_lens = torch.as_tensor(chunk_lens, device=dev).long()
    tbl = torch.clamp(block_tables.long(), max=n - 1)
    kg = _gather(k_pool, k_scale, tbl, rows, a, h_kv, d)
    vg = _gather(v_pool, v_scale, tbl, rows, a, h_kv, d)
    pool_pos = torch.arange(rows, device=dev)[None, None, :]
    q_pos = (offsets[:, None] + torch.arange(c, device=dev))[:, :, None]
    row_lens = offsets + chunk_lens
    keep = (pool_pos <= q_pos) & (pool_pos < row_lens[:, None, None])
    if window is not None:
        keep = keep & ((q_pos - pool_pos) < window)
    return eager_attention(q, kg, vg, attn_mask=keep[:, None],
                           scale=scale).to(q.dtype)


_chunk_sig = False


def _chunk_lib():
    global _chunk_sig
    lib = _build.library("paged_chunk")
    if not _chunk_sig:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_chunk_fwd.argtypes = [i, i, v, v, v, v, v, v, v, v, v, i,
                                        i, i, i, i, i, i, ctypes.c_float, i,
                                        v]
        lib.paged_chunk_fwd.restype = ctypes.c_int
        _chunk_sig = True
    return lib


def paged_chunk_attention(q, k_pool, v_pool, block_tables, offsets,
                          chunk_lens, *, scale=None, window=None,
                          k_scale=None, v_scale=None, partials=False):
    """Ragged chunk attention over block tables. q: [A, C, H, D] (rotated
    chunk queries); pools [N, bs, Hkv, D] with the chunk's K/V already
    written; block_tables [A, MB]; offsets/chunk_lens [A]: row a's queries
    sit at offsets[a] .. offsets[a]+chunk_lens[a]-1 and attend pool
    positions [0, offsets[a]+chunk_lens[a]) causally. Returns [A, C, H, D].
    ``k_scale``/``v_scale``: an int8 pool."""
    _refuse(partials, "paged_chunk_attention")
    if not q.is_cuda:
        return paged_chunk_attention_plain(
            q, k_pool, v_pool, block_tables, offsets, chunk_lens,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale)
    n, bs, h_kv = _check_pool(q, k_pool, v_pool, k_scale, v_scale,
                              "paged_chunk_attention")
    a, c, h, d = q.shape
    _check_rows(a, block_tables, (offsets, chunk_lens),
                "paged_chunk_attention")
    code = _build.dtype_code(q, "paged_chunk_attention")
    q = q.contiguous()
    tables = _i32(block_tables, q.device)
    offs = _i32(offsets, q.device)
    cls = _i32(chunk_lens, q.device)
    o = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _chunk_lib()
    rc = lib.paged_chunk_fwd(code, d, _build.ptr(q), _build.ptr(k_pool),
                             _build.ptr(v_pool), _build.ptr(k_scale),
                             _build.ptr(v_scale), _build.ptr(tables),
                             _build.ptr(offs), _build.ptr(cls), _build.ptr(o),
                             a, c, h, h_kv, n, bs, tables.shape[1], scale,
                             int(window or 0), _build.stream(q))
    _build.check(lib, rc, "paged_chunk_attention")
    (paged_chunk_attention if k_scale is None
     else paged_chunk_i8).launches += 1
    return o


paged_chunk_attention.launches = 0
