"""K3 and K4: paged attention — counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``.

* :func:`paged_decode_attention` (K4, ``csrc/paged_decode.cu``): one
  query per sequence over its block-table row, the live key range split
  over blocks (:func:`decode_schedule`) and merged.
* :func:`paged_chunk_attention` (K3, ``csrc/paged_chunk.cu``): ragged
  multi-query causal attention for chunked prefill; bf16 / f16 q on the tensor
  cores, float32 on FMAs (:func:`chunk_route`).

On CUDA tensors each launches its kernel or raises; on CPU tensors each
runs its plain version (``*_plain``: the reference's gather-based XLA
path, ported). Unused table slots hold the sentinel ``N =
k_pool.shape[0]``: both paths clamp it (``jnp.take`` clamps, torch
indexing does not) and mask it by length. Any GQA group H / Hkv from 1 to
:data:`MAX_GROUP` runs on the card.

``k_scale``/``v_scale`` [N, bs, Hkv] fp32 mark an int8 pool (per-(position,
KV head) absmax scales): both kernels read the codes and dequantize them
on load, the plain versions gather the scale rows with the blocks. The
launches of the two modes are counted apart: ``.launches`` on each
wrapper for a pool of q's type, :data:`paged_decode_i8` /
:data:`paged_chunk_i8` for an int8 pool, :data:`paged_decode_partials` /
:data:`paged_chunk_partials` for the partials mode over a pool of q's
type.

``partials=True`` (context parallelism) returns the un-normalised
online-softmax triple (acc, m, l) over the table entries < N only —
entries >= N belong to another shard and are skipped, not clamped — with
m in natural-log units of the scaled scores and (m, l, acc) = (-1e30, 0,
0) for a row with no owned visible key; :func:`merge_partials` folds such
triples over a leading shard axis.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from paddle_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
HEAD_DIMS = (64, 128)
# K4 is built for every group H / Hkv up to this (csrc/paged_decode.cu)
MAX_GROUP = 8
# K4's schedule: keys a block stages at once (csrc/paged_decode.cu
# kTileKeys), the blocks the longest live range should give (about two
# for each of the H100's 132 SMs: more, shorter splits were slower on the
# card, chip_smoke.py k4_splits) and the shortest split
DEC_TILE = 32
DEC_TARGET_BLOCKS = 256
DEC_MIN_CHUNK = 128
# the kernel K3 launches for each q dtype (pools of q's type or int8)
CHUNK_ROUTES = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
                torch.float32: "fma"}

# launches of the int8-pool mode of K4 / K3 (``ops.cuda.kernels()``)
paged_decode_i8 = SimpleNamespace(launches=0, f16=_build.f16_counter())
paged_chunk_i8 = SimpleNamespace(launches=0, f16=_build.f16_counter())
# launches of the partials mode of K4 / K3 over a pool of q's type (the
# context-parallel path; an int8 pool's count as paged_*_i8)
paged_decode_partials = SimpleNamespace(launches=0,
                                        f16=_build.f16_counter())
paged_chunk_partials = SimpleNamespace(launches=0, f16=_build.f16_counter())


def _check_pool(q, k_pool, v_pool, k_scale, v_scale, what):
    d = q.shape[-1]
    n, bs, h_kv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} for head_dim {d}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"{what}: head_dim {d}: built for {HEAD_DIMS}")
    h = q.shape[-2]
    if h % h_kv:
        raise ValueError(f"{what}: {h} query heads over {h_kv} kv heads")
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
        pools += (k_scale, v_scale)
    for t in pools:
        if not t.is_contiguous():
            raise ValueError(f"{what}: pools must be contiguous")
    # both kernels stream pool rows in 16-byte copies
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)):
        raise ValueError(f"{what}: the pools must be 16-byte aligned")
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


def _owned(block_tables, n, bs):
    """[rows, MB * bs] bool: the positions whose table entry is < N (this
    shard's; partials mode skips the others)."""
    return (block_tables < n).repeat_interleave(bs, dim=1)


def _partials(s, keep, v, eq):
    """The un-normalised triple of masked scores ``s`` (keep: the visible,
    owned keys; broadcast to s): acc = einsum(eq, p, v), m the row max
    (-1e30 with no key), l the sum of p. The keep multiply zeroes the
    all-masked row, where exp(s - m) would be 1 everywhere."""
    s = torch.where(keep, s, _NEG_INF)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[..., None]) * keep
    return torch.einsum(eq, p, v.float()), m, p.sum(dim=-1)


def merge_partials(acc, m, l):
    """Fold partial triples over their leading axis (one entry a shard or
    split): acc [S, ..., D], m and l [S, ...] -> (acc, m, l) without it,
    the math of K4's merge kernel: with M the max of m, each entry
    weighted by exp(m - M). Rows no entry saw keep (0, -1e30, 0); the
    result normalises as ``acc / l`` where l > 0."""
    mx = m.max(dim=0).values
    w = torch.exp(m - mx)
    return (acc * w[..., None]).sum(dim=0), mx, (l * w).sum(dim=0)


# ----------------------------------------------------------- decode (K4)

def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lens, *,
                                 scale=None, window=None, k_scale=None,
                                 v_scale=None, partials=False):
    """Gather-based plain version: q [B, H, D], pools [N, bs, Hkv, D]
    (int8 with ``k_scale``/``v_scale`` [N, bs, Hkv]), block_tables [B, MB],
    lens [B] (including the new token). ``partials``: the (acc, m, l)
    triple over the owned entries (the reference's XLA partials
    branch)."""
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
    if partials:
        keep = keep & _owned(block_tables, n, bs)[:, None, :]
        return _partials(s, keep, v, "bhk,bkhd->bhd")
    s = torch.where(keep, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)




def decode_schedule(b, h_kv, rows, window=None):
    """(nsplit, chunk): how K4 cuts the live key range of b rows of h_kv
    KV heads over tables of ``rows`` (= MB * bs) positions — the longest
    live range (``rows``, or the window) in nsplit splits of ``chunk``
    keys, a multiple of DEC_TILE and at least DEC_MIN_CHUNK, so that the
    (kv head, row, split) blocks come to about DEC_TARGET_BLOCKS. From the
    shapes alone: reading ``lens`` here would synchronise the host with
    the card every call."""
    live = max(1, min(rows, window) if window else rows)
    want = max(1, -(-DEC_TARGET_BLOCKS // max(1, b * h_kv)))
    chunk = max(DEC_MIN_CHUNK, -(-live // want))
    chunk = -(-chunk // DEC_TILE) * DEC_TILE
    return -(-live // chunk), chunk


_dec_sig = False


def _dec_lib():
    global _dec_sig
    lib = _build.library("paged_decode")
    if not _dec_sig:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_fwd.argtypes = ([i, i] + [v] * 12 + [i] * 6
                                         + [ctypes.c_float] + [i] * 4 + [v])
        lib.paged_decode_fwd.restype = ctypes.c_int
        _dec_sig = True
    return lib


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens, *,
                           scale=None, window=None, k_scale=None,
                           v_scale=None, partials=False):
    """One decode step over block tables; returns [B, H, D], or with
    ``partials`` the fp32 triple (acc [B, H, D], m [B, H], l [B, H]) over
    the owned table entries. Rows with ``lens == 0`` give 0 on the card
    (the plain version averages V there; callers discard such rows).
    ``k_scale``/``v_scale``: an int8 pool. The card's split count of the
    last launch stands in ``paged_decode_attention.nsplit``."""
    if not q.is_cuda:
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lens, scale=scale,
            window=window, k_scale=k_scale, v_scale=v_scale,
            partials=partials)
    n, bs, h_kv = _check_pool(q, k_pool, v_pool, k_scale, v_scale,
                              "paged_decode_attention")
    b, h, d = q.shape
    if h // h_kv > MAX_GROUP:
        raise NotImplementedError(
            f"paged_decode_attention: GQA group {h // h_kv} ({h} query "
            f"heads over {h_kv} kv heads): groups 1-{MAX_GROUP} are built")
    _check_rows(b, block_tables, (lens,), "paged_decode_attention")
    code = _build.dtype_code(q, "paged_decode_attention")
    q = q.contiguous()
    tables = _i32(block_tables, q.device)
    lens_t = _i32(lens, q.device)
    mb = tables.shape[1]
    nsplit, chunk = decode_schedule(b, h_kv, mb * bs, window)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = acc = m = l = ws = None
    if partials:
        acc, m, l = (torch.empty(b, h, d, **f32), torch.empty(b, h, **f32),
                     torch.empty(b, h, **f32))
    else:
        o = torch.empty_like(q)
    if nsplit > 1:        # each split's triple, merged in split order
        ws = torch.empty(nsplit * b * h * (d + 2), **f32)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _dec_lib()
    P = _build.ptr
    rc = lib.paged_decode_fwd(
        code, d, P(q), P(k_pool), P(v_pool), P(k_scale), P(v_scale),
        P(tables), P(lens_t), P(o), P(acc), P(m), P(l), P(ws), b, h, h_kv,
        n, bs, mb, scale, int(window or 0), nsplit, chunk, int(partials),
        _build.stream(q))
    _build.check(lib, rc, "paged_decode_attention")
    _build.count(paged_decode_i8 if k_scale is not None else
                 paged_decode_partials if partials
                 else paged_decode_attention, q)
    paged_decode_attention.nsplit = nsplit
    return (acc, m, l) if partials else o


paged_decode_attention.launches = 0
paged_decode_attention.f16 = _build.f16_counter()
paged_decode_attention.nsplit = None


# ------------------------------------------------------------ chunk (K3)

def paged_chunk_attention_plain(q, k_pool, v_pool, block_tables, offsets,
                                chunk_lens, *, scale=None, window=None,
                                k_scale=None, v_scale=None, partials=False):
    """Gather-based plain version: materialise each row's whole
    ``max_blocks*bs`` pool view (an int8 pool dequantized in fp32) and run
    dense masked attention (the reference's ``paged_chunk_attention_xla``);
    the result in q's type. Rows with ``chunk_lens == 0`` and padding
    query rows are unspecified here (0 on the card). ``partials``: the
    (acc [A, C, H, D], m, l [A, C, H]) triple over the owned entries (the
    XLA partials branch), where dead and padding query rows see no key,
    as in the Pallas kernel."""
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
    if not partials:
        return eager_attention(q, kg, vg, attn_mask=keep[:, None],
                               scale=scale).to(q.dtype)
    live = torch.arange(c, device=dev)[None, :] < chunk_lens[:, None]
    keep = (keep & _owned(block_tables, n, bs).to(dev)[:, None, :]
            & live[:, :, None])
    if h_kv != h:
        kg = kg.repeat_interleave(h // h_kv, dim=2)
        vg = vg.repeat_interleave(h // h_kv, dim=2)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("achd,akhd->ahck", q.float(), kg.float()) * scale
    acc, m, l = _partials(s, keep[:, None], vg, "ahck,akhd->achd")
    return acc, m.transpose(1, 2), l.transpose(1, 2)


def chunk_route(dtype):
    """The kernel K3 runs for q of ``dtype``: "wgmma" (bf16 or f16, the
    tensor cores) or "fma" (float32, exact to 1e-4)."""
    try:
        return CHUNK_ROUTES[dtype]
    except KeyError:
        raise TypeError(f"paged_chunk_attention: the CUDA kernel takes "
                        f"float32, bfloat16 or float16 q, got {dtype}"
                        ) from None


_chunk_sig = False


def _chunk_lib():
    global _chunk_sig
    lib = _build.library("paged_chunk")
    if not _chunk_sig:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_chunk_fwd.argtypes = ([i, i] + [v] * 12 + [i] * 7
                                        + [ctypes.c_float, i, i, v])
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
    positions [0, offsets[a]+chunk_lens[a]) causally. Returns [A, C, H, D],
    or with ``partials`` the fp32 triple (acc [A, C, H, D], m, l [A, C,
    H]) over the owned table entries. ``k_scale``/``v_scale``: an int8
    pool. The kernel that runs: :func:`chunk_route`."""
    if not q.is_cuda:
        return paged_chunk_attention_plain(
            q, k_pool, v_pool, block_tables, offsets, chunk_lens,
            scale=scale, window=window, k_scale=k_scale, v_scale=v_scale,
            partials=partials)
    n, bs, h_kv = _check_pool(q, k_pool, v_pool, k_scale, v_scale,
                              "paged_chunk_attention")
    a, c, h, d = q.shape
    _check_rows(a, block_tables, (offsets, chunk_lens),
                "paged_chunk_attention")
    code = _build.dtype_code(q, "paged_chunk_attention")
    q = q.contiguous()
    if q.data_ptr() % 16:   # the tensor-core route copies 16-byte pieces
        raise ValueError("paged_chunk_attention: q must be 16-byte aligned")
    tables = _i32(block_tables, q.device)
    offs = _i32(offsets, q.device)
    cls = _i32(chunk_lens, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    o = acc = m = l = None
    if partials:
        acc, m, l = (torch.empty(a, c, h, d, **f32),
                     torch.empty(a, c, h, **f32), torch.empty(a, c, h, **f32))
    else:
        o = torch.empty_like(q)
    scale = float(scale) if scale is not None else d ** -0.5
    lib = _chunk_lib()
    P = _build.ptr
    rc = lib.paged_chunk_fwd(
        code, d, P(q), P(k_pool), P(v_pool), P(k_scale), P(v_scale),
        P(tables), P(offs), P(cls), P(o), P(acc), P(m), P(l), a, c, h, h_kv,
        n, bs, tables.shape[1], scale, int(window or 0), int(partials),
        _build.stream(q))
    _build.check(lib, rc, "paged_chunk_attention")
    _build.count(paged_chunk_i8 if k_scale is not None else
                 paged_chunk_partials if partials else paged_chunk_attention,
                 q)
    return (acc, m, l) if partials else o


paged_chunk_attention.launches = 0
paged_chunk_attention.f16 = _build.f16_counter()
