"""The ``partials`` mode of K3 and K4 (context parallelism), GQA groups
outside 1/2/4/8, K4's split schedule and ``merge_partials``, in the port
against the JAX package.

The port's plain versions (what the wrappers run on CPU tensors) against
the reference's XLA partials branches and the Pallas kernels in
interpret mode, fp32, inputs made with numpy from a seed. Table rows hold
non-owned entries (the sentinel N, which partials mode skips) inside the
live range, and one row owns nothing. The CUDA kernels are held to these
plain versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu_torch.ops.cuda import paged_attention as TPA
from tests.test_torch_common import F32_TOL, to_np

# the module (the package re-exports a function of the same name)
JR = importlib.import_module("paddle_tpu.distributed.ring_attention")

N, BS, MB = 14, 4, 6


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _quantize(f):
    """int8 codes and fp32 absmax / 127 scales of a pool [N, bs, Hkv, D]."""
    scale = np.maximum(np.abs(f).max(-1), 1e-8) / 127.0
    codes = np.clip(np.round(f / scale[..., None]), -127, 127)
    return codes.astype(np.int8), scale.astype(np.float32)


def _inputs(rs, hkv, d, int8):
    """Pools (int8 codes with scales, or fp32) and three table rows: row 0
    with non-owned entries (the sentinel) between owned ones, row 1 owning
    nothing, row 2 all owned; unused slots hold the sentinel too."""
    kp = rs.randn(N, BS, hkv, d).astype(np.float32)
    vp = rs.randn(N, BS, hkv, d).astype(np.float32)
    sc = {}
    if int8:
        kp, ks = _quantize(kp)
        vp, vs = _quantize(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    perm = rs.permutation(N)
    tables = np.full((3, MB), N, np.int32)
    tables[0] = [perm[0], N, perm[1], perm[2], N, perm[3]]
    tables[2, :5] = perm[4:9]
    return kp, vp, tables, sc


def _both(args, kw):
    """(JAX arrays, port tensors) of the same numpy inputs."""
    return ([jnp.asarray(a) for a in args],
            [_t(a) for a in args],
            {k: jnp.asarray(v) for k, v in kw.items()},
            {k: _t(v) for k, v in kw.items()})


def _close(got, want, rows=None):
    for g, w in zip(got, want):
        g, w = to_np(g), np.asarray(w)
        if rows is not None:
            g, w = g[rows], w[rows]
        np.testing.assert_allclose(g, w, **F32_TOL)


# (h, hkv, window, int8): GQA groups 1, 2, 4 and 7, a window, int8 pools
CASES = {"mha": (4, 4, None, False), "gqa": (4, 2, None, False),
         "gqa4_window": (8, 2, 5, False), "g7": (7, 1, None, False),
         "g7_hkv2_window": (14, 2, 9, False), "int8": (4, 2, None, True),
         "int8_window": (8, 2, 6, True)}


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("case", list(CASES))
def test_decode_partials_match_xla_and_pallas(case):
    """K4's plain partials triple (acc, m, l) equals the reference's XLA
    partials branch and the interpreted Pallas kernel's: non-owned entries
    skipped, the unowned row at (0, -1e30, 0)."""
    h, hkv, window, int8 = CASES[case]
    rs = np.random.RandomState(7)
    kp, vp, tables, sc = _inputs(rs, hkv, 16, int8)
    q = rs.randn(3, h, 16).astype(np.float32)
    lens = np.array([22, 9, 19], np.int32)
    jargs, targs, jkw, tkw = _both((q, kp, vp, tables, lens), sc)
    got = TPA.paged_decode_attention(*targs, window=window, partials=True,
                                     **tkw)
    assert [tuple(x.shape) for x in got] == [(3, h, 16), (3, h), (3, h)]
    for ref in (JPA.paged_decode_attention_xla(*jargs, window=window,
                                               partials=True, **jkw),
                JPA.paged_decode_attention_pallas(
                    *jargs, window=window, partials=True, interpret=True,
                    **jkw)):
        _close(got, ref)
    acc, m, l = (to_np(x) for x in got)
    assert (m[1] == -1e30).all() and (l[1] == 0).all() and (acc[1] == 0).all()


@pytest.mark.parametrize("h,hkv", [(7, 1), (14, 2)], ids=["7_1", "14_2"])
@pytest.mark.parametrize("window", [None, 6])
def test_decode_group7_matches_pallas(h, hkv, window):
    """A GQA group of 7 (Qwen2's), which the card's K4 now builds: the
    plain version equals the interpreted Pallas kernel."""
    rs = np.random.RandomState(8)
    kp, vp, tables, _ = _inputs(rs, hkv, 64, False)
    tables[tables == N] = rs.randint(0, N, int((tables == N).sum()))
    q = rs.randn(3, h, 64).astype(np.float32)
    lens = np.array([22, 1, 17], np.int32)
    want = JPA.paged_decode_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)), window=window,
        interpret=True)
    got = TPA.paged_decode_attention(*(_t(a) for a in (q, kp, vp, tables,
                                                       lens)), window=window)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("case", list(CASES))
def test_chunk_partials_match_xla_and_pallas(case):
    """K3's plain partials triple equals the interpreted Pallas kernel's on
    every row (dead and padding query rows at (0, -1e30, 0), as the kernel
    gives them) and the XLA partials branch's on the live query rows (that
    branch lets padding rows attend the row's prefix)."""
    h, hkv, window, int8 = CASES[case]
    rs = np.random.RandomState(9)
    kp, vp, tables, sc = _inputs(rs, hkv, 16, int8)
    q = rs.randn(3, 8, h, 16).astype(np.float32)
    offsets = np.array([14, 0, 11], np.int32)
    chunk_lens = np.array([8, 5, 0], np.int32)      # row 2 is dead
    jargs, targs, jkw, tkw = _both((q, kp, vp, tables, offsets, chunk_lens),
                                   sc)
    got = TPA.paged_chunk_attention(*targs, window=window, partials=True,
                                    **tkw)
    assert [tuple(x.shape) for x in got] == [(3, 8, h, 16), (3, 8, h),
                                             (3, 8, h)]
    _close(got, JPA.paged_chunk_attention_pallas(
        *jargs, window=window, partials=True, interpret=True, **jkw))
    xla = JPA.paged_chunk_attention_xla(*jargs, window=window, partials=True,
                                        **jkw)
    for a, n in enumerate(chunk_lens):
        _close(got, xla, rows=(a, slice(0, n)))
    acc, m, l = (to_np(x) for x in got)
    # row 1 owns no entry; row 2 is dead; row 1's queries 5.. are padding
    for dead in (m[1], m[2]):
        assert (dead == -1e30).all()
    assert (l[1] == 0).all() and (acc[2] == 0).all()


@pytest.mark.parametrize("h,hkv", [(7, 1), (14, 2)], ids=["7_1", "14_2"])
def test_chunk_group7_matches_pallas(h, hkv):
    """A GQA group of 7 folds into K3's query tile (64 folded rows hold 9
    queries and a part): the plain version equals the Pallas kernel."""
    rs = np.random.RandomState(10)
    kp, vp, tables, _ = _inputs(rs, hkv, 64, False)
    tables[tables == N] = rs.randint(0, N, int((tables == N).sum()))
    q = rs.randn(3, 10, h, 64).astype(np.float32)
    offsets = np.array([0, 7, 12], np.int32)
    chunk_lens = np.array([10, 3, 0], np.int32)
    args = (q, kp, vp, tables, offsets, chunk_lens)
    want = JPA.paged_chunk_attention_pallas(
        *(jnp.asarray(a) for a in args), window=8, interpret=True)
    got = TPA.paged_chunk_attention(*(_t(a) for a in args), window=8)
    for a, n in enumerate(chunk_lens):
        np.testing.assert_allclose(to_np(got)[a, :n], np.asarray(want)[a, :n],
                                   **F32_TOL)


# ------------------------------------------------------- merge_partials
def _halves(tables):
    """The table split into two shards' views: even slots owned by the
    first, odd by the second, the other's entries the sentinel N."""
    odd = np.arange(tables.shape[1]) % 2 == 1
    return (np.where(odd, N, tables).astype(np.int32),
            np.where(odd, tables, N).astype(np.int32))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("window", [None, 7])
def test_merge_partials_of_two_halves_equals_unsplit_decode(window, int8):
    """The two shards' decode triples, merged by ``merge_partials`` and
    normalised, give the unsplit decode output; the merge equals the
    reference's pairwise ``merge_partials``."""
    rs = np.random.RandomState(11)
    kp, vp, tables, sc = _inputs(rs, 2, 16, int8)
    tables[tables == N] = rs.randint(0, N, int((tables == N).sum()))
    q = rs.randn(3, 8, 16).astype(np.float32)
    lens = np.array([22, 9, 24], np.int32)
    tkw = {k: _t(v) for k, v in sc.items()}
    parts = [TPA.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(t),
                                        _t(lens), window=window,
                                        partials=True, **tkw)
             for t in _halves(tables)]
    acc, m, l = TPA.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    want = TPA.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                      _t(lens), window=window, **tkw)
    np.testing.assert_allclose(to_np(acc / l[..., None]), to_np(want),
                               **F32_TOL)
    (ja, jm, jl), (jb, jmb, jlb) = [[jnp.asarray(to_np(x)) for x in p]
                                    for p in parts]
    _close((acc, m, l), JR.merge_partials(ja, jm, jl, jb, jmb, jlb))


@pytest.mark.parametrize("h,hkv", [(4, 2), (7, 1)], ids=["gqa", "g7"])
def test_merge_partials_of_two_halves_equals_unsplit_chunk(h, hkv):
    """The same for K3: the two shards' chunk triples merged and
    normalised give the unsplit output on the live query rows."""
    rs = np.random.RandomState(12)
    kp, vp, tables, _ = _inputs(rs, hkv, 16, False)
    tables[tables == N] = rs.randint(0, N, int((tables == N).sum()))
    q = rs.randn(3, 8, h, 16).astype(np.float32)
    offsets = np.array([14, 0, 3], np.int32)
    chunk_lens = np.array([8, 5, 0], np.int32)
    rest = (_t(offsets), _t(chunk_lens))
    parts = [TPA.paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(t), *rest,
                                       partials=True)
             for t in _halves(tables)]
    acc, m, l = TPA.merge_partials(*(torch.stack(x) for x in zip(*parts)))
    want = TPA.paged_chunk_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     *rest)
    got = acc / torch.clamp(l, min=1e-30)[..., None]
    for a, n in enumerate(chunk_lens):
        np.testing.assert_allclose(to_np(got)[a, :n], to_np(want)[a, :n],
                                   **F32_TOL)
    assert (to_np(m)[2] == -1e30).all() and (to_np(got)[2] == 0).all()


# ----------------------------------------------------- K4's schedule
# (b, hkv, rows, window): Mistral's window decode, Llama-2-7B's and
# Qwen2-7B's serve decode, a small card-test shape, a window past the table
SCHEDULES = {"window_serve": (4, 8, 4704, 4096), "serve": (8, 32, 512, None),
             "qwen2_7b": (8, 4, 512, None), "small": (3, 2, 256, None),
             "wide_window": (2, 1, 80, 4096)}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_decode_schedule_covers_the_longest_live_range(case):
    """K4's (nsplit, chunk) from the shapes alone: whole tiles a split and
    no split under DEC_MIN_CHUNK keys, the splits cover the longest live
    range (the table, or the window) with no split wholly past it, and the
    blocks reach half the target unless the splits are already as short
    as allowed."""
    b, hkv, rows, window = SCHEDULES[case]
    nsplit, chunk = TPA.decode_schedule(b, hkv, rows, window)
    live = min(rows, window or rows)
    assert chunk % TPA.DEC_TILE == 0 and chunk >= TPA.DEC_MIN_CHUNK
    assert nsplit * chunk >= live > (nsplit - 1) * chunk
    assert (b * hkv * nsplit >= TPA.DEC_TARGET_BLOCKS / 2
            or chunk == TPA.DEC_MIN_CHUNK)
    if case == "window_serve":
        assert nsplit > 1
