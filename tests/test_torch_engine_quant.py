"""The port's ``LLMEngine(kv_dtype="int8")`` against the reference's.

Same weights, same request mix, greedy, fp32 ``LlamaConfig.tiny()``: the
int8 engines give identical token streams — over a mix with chunked
prefill and radix prefix hits that copy a partial block (codes and scale
rows), under preemption, and with weight-only int8 weights on both
sides. Then the reference's own engine tests of quantized serving
(``tests/test_serving_quant.py``) on the port: the ``PT_QUANT_KV`` kill
switch, preemption replay, prefix adoption and eviction over the int8
pool, the ``serving.kv_quant`` fault site, and the bytes the engine bills
at the stored types.
"""
import copy

import numpy as np
import pytest
import torch

from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving import quant as JQ
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving import quant as TQ
from paddle_tpu_torch.serving.kv import cache_block_bytes
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import tiny_pair
from tests.test_torch_engine import _mix, _serve
from tests._torch_threads import one_torch_thread  # noqa: F401

KW = dict(num_slots=3, block_size=4, max_prompt_len=8, max_seq_len=40)


@pytest.mark.parametrize("nkv", [4, 2], ids=["mha", "gqa"])
def test_int8_engine_streams_match_reference(nkv):
    jm, tm = tiny_pair(num_key_value_heads=nkv)
    prompts = _mix(0)
    want, jeng = _serve(JEngine, JRequest, jm, prompts, kv_dtype="int8",
                        **KW)
    got, teng = _serve(LLMEngine, Request, tm, prompts, kv_dtype="int8",
                       **KW)
    assert teng.cache.k_pools[0].dtype == torch.int8
    assert len(teng.cache.k_scales) == tm.cfg.num_hidden_layers
    assert got == want
    assert all(len(t) == 6 for t in got)
    # chunked prefill ran, and the radix trie copied a partial block
    assert teng.mgr.cache_stats["partial_hits"] > 0
    assert teng.mgr.cache_stats == jeng.mgr.cache_stats


def test_int8_engine_preemption_matches_reference():
    jm, tm = tiny_pair()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, n) for n in (12, 17, 9, 20)]
    kw = dict(KW, max_seq_len=32, num_blocks=12, preemption=True,
              kv_dtype="int8")
    want, jeng = _serve(JEngine, JRequest, jm, prompts, **kw)
    got, teng = _serve(LLMEngine, Request, tm, prompts, **kw)
    assert jeng.stats["preemptions"] >= 1
    assert teng.stats["preemptions"] == jeng.stats["preemptions"]
    assert got == want


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4"])
def test_quantized_weights_int8_engine_matches_reference(algo):
    """Weight-only quantized models (the same codes on both sides) over
    int8 KV pools: token-identical streams."""
    jm, tm = tiny_pair(num_key_value_heads=2)
    JQ.quantize_for_serving(jm, algo)
    TQ.quantize_for_serving(tm, algo)
    prompts = _mix(1)
    want, _ = _serve(JEngine, JRequest, jm, prompts, kv_dtype="int8", **KW)
    got, _ = _serve(LLMEngine, Request, tm, prompts, kv_dtype="int8", **KW)
    assert got == want


# ---------------- the reference's engine tests of quantized serving -------

@pytest.fixture(scope="module")
def model():
    return tiny_pair(0, num_hidden_layers=2, hidden_size=32,
                     num_attention_heads=4, num_key_value_heads=2,
                     vocab_size=64)[1]


def _mk(model, **kw):
    args = dict(num_slots=4, block_size=4, max_prompt_len=16,
                max_seq_len=48)
    args.update(kw)
    return LLMEngine(model, **args)


def _prompts(n, rs, lo=3, hi=14, vocab=64):
    return [rs.randint(1, vocab, (int(l),))
            for l in rs.randint(lo, hi, size=n)]


def _run(model, prompts, max_new=8, **ekw):
    eng = _mk(model, **ekw)
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=max_new))
    out = {rid: list(map(int, t)) for rid, t in eng.run().items()}
    eng.assert_quiescent()
    return out, eng


def _match_rate(a, b):
    pairs = [(x, y) for rid in a for x, y in zip(a[rid], b[rid])]
    return float(np.mean([x == y for x, y in pairs]))


def test_int8_kv_engine_matches_bf16_greedy(model):
    rs = np.random.RandomState(0)
    prompts = _prompts(6, rs)
    ref, _ = _run(model, prompts)
    out, eng = _run(model, prompts, kv_dtype="int8")
    assert eng.cache.k_scales and eng.cache.k_pools[0].dtype == torch.int8
    assert _match_rate(ref, out) >= 0.85


def test_kv_kill_switch_bitexact(model, monkeypatch):
    """PT_QUANT_KV=0 at construction: kv_dtype='int8' falls back to a pool
    of the model's type, and the output is identical to that engine's."""
    rs = np.random.RandomState(1)
    prompts = _prompts(4, rs)
    ref, _ = _run(model, prompts)
    monkeypatch.setenv("PT_QUANT_KV", "0")
    out, eng = _run(model, prompts, kv_dtype="int8")
    assert not eng.cache.k_scales and eng.kv_dtype is None
    assert eng.cache.k_pools[0].dtype == model.cfg.dtype
    assert out == ref


def test_preempt_replay_under_int8(model):
    """Preemption + resume replay re-prefills through the quantized
    scatter; the engine finishes cleanly and stays quiescent."""
    rs = np.random.RandomState(3)
    prompts = _prompts(6, rs, lo=6, hi=12)
    out, eng = _run(model, prompts, kv_dtype="int8", num_slots=4,
                    num_blocks=14, preemption=True, max_seq_len=24)
    assert eng.stats["preemptions"] >= 1
    assert all(len(t) == 8 for t in out.values())


def test_prefix_cache_partial_boundary_cow_int8(model):
    """A shared prefix diverging mid-block: the radix trie copies the
    partial block's codes AND scale rows, so cached and uncached int8
    engines emit identical tokens."""
    rs = np.random.RandomState(4)
    base = rs.randint(1, 64, (10,))           # 2.5 blocks at block_size 4
    prompts = [base,
               np.concatenate([base[:6], rs.randint(1, 64, (5,))]),
               np.concatenate([base[:9], rs.randint(1, 64, (3,))])]
    plain, _ = _run(model, prompts, kv_dtype="int8", prefix_caching=False)
    cached, eng = _run(model, prompts, kv_dtype="int8",
                       prefix_caching=True)
    assert cached == plain
    assert eng.mgr.cache_stats["partial_hits"] > 0
    assert eng.kv.reconcile()["ok"]


def test_prefix_adopt_evict_refcounts_int8(model):
    """Sequential same-prefix requests adopt parked blocks of the int8
    pool, evictions reclaim them, and the ledger reconciles."""
    rs = np.random.RandomState(5)
    base = rs.randint(1, 64, (8,))
    eng = _mk(model, kv_dtype="int8", num_blocks=24)
    for i in range(3):                        # sequential: adopt each time
        eng.add_request(Request(base, max_new_tokens=6, req_id=i))
        eng.run()
    stats = eng.mgr.cache_stats
    assert stats.get("hit_blocks", 0) + stats.get("token_hits", 0) > 0
    eng.assert_quiescent()
    assert eng.kv.reconcile()["ok"]


def test_chaos_kv_quant_exception_atomic(model):
    """An injected kv_quant fault aborts the tick BEFORE the
    quantize-on-write: the engine survives, no blocks leak, no stale
    scale rows land, and the finished tokens match a clean run."""
    FAULTS.clear()
    rs = np.random.RandomState(13)
    prompts = _prompts(3, rs)
    ref, _ = _run(model, prompts, kv_dtype="int8")
    eng = _mk(model, kv_dtype="int8")
    for p in prompts:
        eng.add_request(Request(p, max_new_tokens=8))
    fired = 0
    with FAULTS.scope("serving.kv_quant", on={1}, exc=InjectedFault):
        while eng.has_work():
            try:
                eng.step()
            except InjectedFault:
                fired += 1
    assert fired == 1
    out = {r: list(map(int, req.tokens))
           for r, req in eng.pop_finished().items()}
    assert out == ref
    eng.assert_quiescent()
    assert eng.kv.reconcile()["ok"]
    FAULTS.clear()


def test_kv_quant_site_only_fires_for_int8_pools(model):
    FAULTS.clear()
    rs = np.random.RandomState(14)
    eng = _mk(model)                      # pool of the model's type
    eng.add_request(Request(rs.randint(1, 64, (5,)), max_new_tokens=4))
    with FAULTS.scope("serving.kv_quant", exc=InjectedFault):
        eng.run()
    eng.assert_quiescent()
    assert FAULTS.hits["serving.kv_quant"] == 0
    FAULTS.clear()


def test_engine_geom_and_gauge_read_actual_dtypes(model):
    """The pool's bytes and the ``serving_kv_bytes_per_token`` gauge bill
    the stored types: an int8 pool holds 1-byte codes plus a 4-byte scale
    per (position, KV head), a pool of the model's type its itemsize."""
    cfg = model.cfg
    qm = TQ.quantize_for_serving(copy.deepcopy(model), "weight_only_int8")
    eng, full = _mk(qm, kv_dtype="int8"), _mk(model)
    d = cfg.hidden_size // cfg.num_attention_heads
    per_pos = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads
    assert cache_block_bytes(eng.cache) == 4 * per_pos * (d + 4)
    assert cache_block_bytes(full.cache) == (4 * per_pos * d
                                             * cfg.dtype.itemsize)
    prompt = np.random.RandomState(15).randint(1, 64, (9,))
    for e in (eng, full):
        e.add_request(Request(prompt, max_new_tokens=4))
        e.step()
    # the same blocks hold the same tokens: the gauge scales with the pool
    bpt = eng.kv.ledger.bytes_per_token
    bpt_full = full.kv.ledger.bytes_per_token
    assert bpt > 0
    assert bpt / bpt_full == pytest.approx(
        cache_block_bytes(eng.cache) / cache_block_bytes(full.cache))
