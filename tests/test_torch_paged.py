"""Paged serving forwards of the port against ``paddle_tpu.models.paged``.

Slot-aware prefill (with a sentinel padding row), a chunked-prefill
batch (a resumed slot, a fresh slot, a sentinel row), a decode step with
an inactive row and two fused decode ticks with incremental table
updates: logits, sampled tokens, block tables, lengths and the WHOLE
pools (so the written positions hold the same K/V and nothing else was
written) must agree. fp32, tiny, with and without GQA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import paged as JP
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.models import paged as TP
from tests.test_torch_common import F32_TOL, tiny_pair, to_np

N, BS, SLOTS, MB = 16, 4, 3, 8


def _caches(jm, tm):
    cfg = tm.cfg
    d = cfg.hidden_size // cfg.num_attention_heads
    jc = JP.PagedKVCache.init(cfg.num_hidden_layers, N, BS,
                              cfg.num_key_value_heads, d, SLOTS, MB,
                              jnp.float32)
    tc = TP.PagedKVCache.init(cfg.num_hidden_layers, N, BS,
                              cfg.num_key_value_heads, d, SLOTS, MB,
                              torch.float32, device="cpu")
    return jc, tc


def _same_cache(jc, tc):
    for a, b in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
        np.testing.assert_allclose(to_np(b), to_np(a), **F32_TOL)
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))
    np.testing.assert_array_equal(tc.lens.numpy(), np.asarray(jc.lens))


def _table(*blocks):
    row = np.full(MB, N, np.int32)
    row[:len(blocks)] = blocks
    return row


def _prefill_and_chunk(jm, tm):
    """Admit two prompts (slots 0 and 2, plus a sentinel padding row),
    then one chunk batch: slot 2 resumes at offset 7, slot 1 starts at 0,
    row 2 is a sentinel."""
    jc, tc = _caches(jm, tm)
    rs = np.random.RandomState(3)
    ids = np.zeros((3, 12), np.int32)
    ids[0] = rs.randint(0, 256, 12)
    ids[1, :7] = rs.randint(0, 256, 7)
    lens = np.array([12, 7, 0], np.int32)
    slots = np.array([0, 2, SLOTS], np.int32)
    rows = np.stack([_table(0, 1, 2), _table(5, 6), _table()])
    jl, jc = JP.llama_prefill_paged(jm, jnp.asarray(ids), jnp.asarray(lens),
                                    jc, jnp.asarray(slots), jnp.asarray(rows))
    tl, tc = TP.llama_prefill_paged(tm, torch.as_tensor(ids), lens, tc,
                                    slots, rows)
    np.testing.assert_allclose(to_np(tl)[:2], to_np(jl)[:2], **F32_TOL)
    _same_cache(jc, tc)

    cids = np.zeros((3, 6), np.int32)
    cids[0, :5] = rs.randint(0, 256, 5)
    cids[1] = rs.randint(0, 256, 6)
    clens = np.array([5, 6, 0], np.int32)
    offs = np.array([7, 0, 0], np.int32)
    cslots = np.array([2, 1, SLOTS], np.int32)
    crows = np.stack([_table(5, 6, 7), _table(9, 10), _table()])
    jl, jc = JP.llama_prefill_chunk_paged(
        jm, jnp.asarray(cids), jnp.asarray(clens), jnp.asarray(offs), jc,
        jnp.asarray(cslots), jnp.asarray(crows))
    tl, tc = TP.llama_prefill_chunk_paged(tm, torch.as_tensor(cids), clens,
                                          offs, tc, cslots, crows)
    np.testing.assert_allclose(to_np(tl)[:2], to_np(jl)[:2], **F32_TOL)
    _same_cache(jc, tc)
    return jc, tc


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_prefill_chunk_and_decode_step_match(nkv):
    jm, tm = tiny_pair(num_key_value_heads=nkv)
    jc, tc = _prefill_and_chunk(jm, tm)
    # decode step: slot 1 inactive (neither writes nor advances)
    tok = np.array([5, 9, 200], np.int32)
    active = np.array([True, False, True])
    jl, jc = JP.llama_decode_step_paged(jm, jnp.asarray(tok), jc,
                                        jnp.asarray(active))
    tl, tc = TP.llama_decode_step_paged(tm, torch.as_tensor(tok), tc,
                                        torch.as_tensor(active))
    # inactive rows' attention output is discarded by the engine
    np.testing.assert_allclose(to_np(tl)[active], to_np(jl)[active],
                               **F32_TOL)
    _same_cache(jc, tc)


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_decode_ticks_match(nkv):
    jm, tm = tiny_pair(num_key_value_heads=nkv)
    jc, tc = _prefill_and_chunk(jm, tm)
    tok = np.array([5, 9, 200], np.int32)
    active = np.array([True, True, True])
    temps = np.zeros(SLOTS, np.float32)
    top_ps = np.ones(SLOTS, np.float32)
    gen = generator(0, device="cpu")
    # tick 1: slot 0 (12 tokens) crosses into table column 3; slot 1
    # (6 tokens) and slot 2 (12 tokens -> column 3 too) grow; one
    # sentinel update row
    upd = [(np.array([0, 2, SLOTS], np.int32), np.array([3, 3, 0], np.int32),
            np.array([3, 8, 0], np.int32)),
           (np.full(SLOTS, SLOTS, np.int32), np.zeros(SLOTS, np.int32),
            np.zeros(SLOTS, np.int32))]
    for rows, cols, vals in upd:
        jn, _, jc = JP.llama_decode_tick(
            jm, jnp.asarray(tok), jc, jnp.asarray(active), jnp.asarray(rows),
            jnp.asarray(cols), jnp.asarray(vals), jax.random.PRNGKey(0),
            jnp.asarray(temps), jnp.asarray(top_ps))
        tn, _, tc = TP.llama_decode_tick(tm, tok, tc, active, rows, cols,
                                         vals, gen, temps, top_ps)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _same_cache(jc, tc)
        tok = tn.numpy().astype(np.int32)
