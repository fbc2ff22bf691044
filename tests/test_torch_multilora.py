"""Multi-LoRA serving in the port against the reference.

Ports ``tests/test_serving_multilora.py`` (all but its two tenant tests,
which wait for fair admission, ROADMAP.md queue 1 item 5(i)) to
``paddle_tpu_torch``: the ``AdapterStore`` (strict registration, the
LRU device cache with pins, the ``serving.adapter_swap`` fault site,
in-place uploads), null-adapter identity and the ``PT_MULTILORA`` kill
switch, mixed batches equal to dedicated engines, radix isolation across
adapters. Against the JAX package: ``_lora_delta`` (grouped and gather)
on the same inputs, the paged forwards with a LoRA batch, the ``peft``
helpers under the reference's key names, and the engine's greedy streams
of a mixed-adapter batch token for token (same weights, same adapter
state dicts, made with numpy from a seed, fp32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import peft as jpeft
from paddle_tpu.models import paged as jpaged
from paddle_tpu.serving import LLMEngine as JEngine
from paddle_tpu.serving import Request as JRequest
from paddle_tpu.serving.adapters import AdapterStore as JStore
from paddle_tpu_torch import peft
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.models import paged as tpaged
from paddle_tpu_torch.models.paged import PagedKVCache, RadixPrefixBlockManager
from paddle_tpu_torch.observability import METRICS
from paddle_tpu_torch.serving import LLMEngine, Request
from paddle_tpu_torch.serving.adapters import AdapterStore
from paddle_tpu_torch.serving.telemetry import (_ADAPTER_DEFERRALS,
                                                _ADAPTER_EVICTIONS)
from paddle_tpu_torch.utils.faults import FAULTS, InjectedFault
from tests.test_torch_common import F32_TOL, tiny_pair, to_np

TINY = dict(num_hidden_layers=2, hidden_size=32, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=64)
ENG = dict(num_slots=3, block_size=4, max_prompt_len=16, max_seq_len=24)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(**TINY)


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(autouse=True)
def _hygiene():
    FAULTS.clear()
    METRICS.reset()
    yield
    FAULTS.clear()


def make_adapter(model, seed, r=4, alpha=8):
    """A visible (non-zero-B) adapter state dict on the qkv and o
    projections, under the reference's keys, made with numpy: the same
    dict feeds either package's store."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name in peft.lora_targets(model, ("qkv_proj", "o_proj")):
        w = dict(model.named_parameters())[name]
        k, n = w.shape
        sd[name + ".lora_A"] = (rs.randn(k, r) / np.sqrt(k)).astype(
            np.float32)
        sd[name + ".lora_B"] = (rs.randn(r, n) * 0.05).astype(np.float32)
    sd["_scale"] = np.asarray(alpha / r, np.float32)
    return sd


@pytest.fixture(scope="module")
def store(model):
    s = AdapterStore(model, capacity=2, max_rank=4)
    s.register("t1", make_adapter(model, 1))
    s.register("t2", make_adapter(model, 2, r=2))   # heterogeneous rank
    return s


def _run_one(model, store, prompt, n, adapter_id=None):
    eng = LLMEngine(model, adapter_store=store, device="cpu", **ENG)
    rid = eng.add_request(Request(prompt, max_new_tokens=n,
                                  adapter_id=adapter_id))
    out = eng.run()[rid]
    eng.assert_quiescent()
    return out


# ------------------------------------------------------------ store unit
def test_store_register_strict_and_known(model, store):
    assert store.known("t1") and store.known("t2")
    assert not store.known("nope")
    with pytest.raises(ValueError):
        store.register(None, make_adapter(model, 3))
    sd = make_adapter(model, 3)
    sd.pop(next(k for k in sd if k.endswith(".lora_A")))
    with pytest.raises(ValueError, match="missing"):
        AdapterStore(model, capacity=2, max_rank=4).register("bad", sd)
    sd2 = make_adapter(model, 3)
    sd2["totally.bogus.lora_A"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        AdapterStore(model, capacity=2, max_rank=4).register("bad", sd2)


def test_store_rank_over_max_refused(model):
    s = AdapterStore(model, capacity=2, max_rank=2)
    with pytest.raises(ValueError):
        s.register("fat", make_adapter(model, 1, r=4))


def test_store_lru_eviction_and_hot_swap(model):
    s = AdapterStore(model, capacity=2, max_rank=4)
    for i in (1, 2, 3):
        s.register(f"a{i}", make_adapter(model, i))
    i1, i2 = s.ensure("a1"), s.ensure("a2")
    assert {i1, i2} == {0, 1}
    before = _ADAPTER_EVICTIONS.value()
    s.ensure("a1")                       # touch: a2 becomes LRU
    i3 = s.ensure("a3")                  # evicts a2, reuses its slot
    assert i3 == i2
    assert _ADAPTER_EVICTIONS.value() == before + 1
    assert s.index_of("a1") == i1        # survivor untouched
    with pytest.raises(KeyError):
        s.index_of("a2")                 # evicted: not resident
    assert s.ensure("a2") == i1          # re-upload evicts the new LRU (a1)


def test_store_pins_block_eviction_and_reregister(model):
    s = AdapterStore(model, capacity=1, max_rank=4)
    s.register("a1", make_adapter(model, 1))
    s.register("a2", make_adapter(model, 2))
    s.acquire("a1")
    with pytest.raises(RuntimeError, match="exhausted"):
        s.acquire("a2")                  # sole slot pinned
    with pytest.raises(ValueError, match="pinned"):
        s.register("a1", make_adapter(model, 5))   # pinned: no re-register
    s.release("a1")
    assert s.acquire("a2") == 0          # hot-swap into the freed slot
    s.release("a2")
    s.assert_quiescent()


def test_store_uploads_in_place_and_match_reference(pair):
    """``stacks()`` hands out the same tensors for the store's whole life
    (a captured tick reads them), an upload writes its entry into them,
    and the stacked values (rank-padded, scale folded into B) equal the
    reference store's for the same state dicts."""
    jm, tm = pair
    s = AdapterStore(tm, capacity=2, max_rank=4)
    js = JStore(jm, capacity=2, max_rank=4)
    for i, r in ((1, 4), (2, 2), (3, 3)):
        sd = make_adapter(tm, i, r=r)
        s.register(f"a{i}", sd)
        js.register(f"a{i}", sd)
    ptrs = {k: v.data_ptr() for k, v in s.stacks().items()}
    for aid in ("a1", "a2", "a3"):          # a3 evicts a1
        assert s.ensure(aid) == js.ensure(aid)
        st, jst = s.stacks(), js.stacks()
        assert {k: v.data_ptr() for k, v in st.items()} == ptrs
        for k in st:
            np.testing.assert_array_equal(to_np(st[k]), np.asarray(jst[k]))


# ----------------------------------------------------- engine: identity
def test_null_adapter_and_kill_switch_identity(model, store, monkeypatch):
    p = np.arange(1, 6, dtype=np.int32)
    base_eng = LLMEngine(model, device="cpu", **ENG)
    rb = base_eng.add_request(Request(p, max_new_tokens=4))
    base = base_eng.run()[rb]
    # store attached, request base: bit-exact (lora arg never built)
    assert _run_one(model, store, p, 4) == base
    # kill switch: even an adapter request takes the base path
    monkeypatch.setenv("PT_MULTILORA", "0")
    assert _run_one(model, store, p, 4, adapter_id="t1") == base
    monkeypatch.delenv("PT_MULTILORA")
    # and with it off again, the adapter visibly changes the stream
    assert _run_one(model, store, p, 4, adapter_id="t1") != base


def test_mixed_batch_matches_dedicated_engines(model, store):
    """Base + two heterogeneous adapters in ONE continuous batch emit
    exactly what three dedicated engines emit (radix cache active). The
    reference's version also tags two tenants: tenants wait for item
    5(i), and the adapters alone decide the streams."""
    p = np.arange(1, 6, dtype=np.int32)
    eng = LLMEngine(model, adapter_store=store, device="cpu", **ENG)
    r0 = eng.add_request(Request(p, max_new_tokens=4))
    r1 = eng.add_request(Request(p, max_new_tokens=4, adapter_id="t1"))
    r2 = eng.add_request(Request(p, max_new_tokens=4, adapter_id="t2"))
    out = eng.run()
    eng.assert_quiescent()
    store.assert_quiescent()
    assert out[r0] == _run_one(model, None, p, 4)
    assert out[r1] == _run_one(model, store, p, 4, adapter_id="t1")
    assert out[r2] == _run_one(model, store, p, 4, adapter_id="t2")
    assert out[r1] != out[r0] and out[r2] != out[r0]
    assert out[r1] != out[r2]


# ------------------------------------------------- cross-tenant isolation
def test_radix_never_matches_across_adapters():
    mgr = RadixPrefixBlockManager(num_blocks=8, block_size=4)
    toks = np.arange(10, dtype=np.int32)
    mgr.allocate(1, 10)
    mgr.commit_prefix(1, toks, adapter="t1")
    assert mgr.match_prefix(toks, adapter="t1").token_count > 0
    assert mgr.match_prefix(toks, adapter="t2").token_count == 0
    assert mgr.match_prefix(toks).token_count == 0          # base trie
    mgr.free(1)


def test_same_prompt_sequential_tenants_no_contamination(model, store):
    """Byte-identical prompts under different adapters, served one after
    another through the SAME engine (t1's blocks are parked in the radix
    cache when t2 arrives) — each stream still equals its dedicated
    engine, and the base request is untouched by either."""
    p = np.arange(2, 9, dtype=np.int32)
    eng = LLMEngine(model, adapter_store=store, device="cpu", **ENG)
    outs = {}
    for aid in ("t1", "t2", None, "t1"):
        rid = eng.add_request(Request(p, max_new_tokens=4, adapter_id=aid))
        outs[(aid, rid)] = eng.run()[rid]
    eng.assert_quiescent()
    for (aid, _), got in outs.items():
        assert got == _run_one(model, store, p, 4, adapter_id=aid), aid


# ------------------------------------------------------------------ chaos
def test_adapter_swap_fault_is_exception_atomic(model):
    s = AdapterStore(model, capacity=2, max_rank=4)
    s.register("a1", make_adapter(model, 1))
    before = {k: v.clone() for k, v in s.stacks().items()}
    with FAULTS.scope("serving.adapter_swap", exc=InjectedFault):
        with pytest.raises(InjectedFault):
            s.ensure("a1")
        assert "a1" not in s._resident   # host copy stays, no residency
        assert len(s._free) == 2         # no slot leaked
        for k, v in s.stacks().items():  # no byte of the stacks written
            assert torch.equal(v, before[k])
    idx = s.ensure("a1")                 # clean retry succeeds
    assert idx in (0, 1)
    s.assert_quiescent()


def test_adapter_swap_fault_defers_admission_then_retries(model):
    """A one-shot upload fault makes the scheduler defer the admission;
    the next tick retries and the request completes with the exact
    no-fault stream (nothing dropped, nothing leaked)."""
    p = np.arange(3, 10, dtype=np.int32)
    s = AdapterStore(model, capacity=2, max_rank=4)
    s.register("t1", make_adapter(model, 1))
    want = _run_one(model, s, p, 4, adapter_id="t1")

    s2 = AdapterStore(model, capacity=2, max_rank=4)
    s2.register("t1", make_adapter(model, 1))
    eng = LLMEngine(model, adapter_store=s2, device="cpu", **ENG)
    before = _ADAPTER_DEFERRALS.value()
    with FAULTS.scope("serving.adapter_swap", exc=InjectedFault, on={0}):
        rid = eng.add_request(Request(p, max_new_tokens=4,
                                      adapter_id="t1"))
        out = eng.run()
    assert out[rid] == want
    assert _ADAPTER_DEFERRALS.value() == before + 1
    eng.assert_quiescent()
    s2.assert_quiescent()


def test_pinned_cache_defers_until_a_pin_is_released(model):
    """Capacity 1, two adapters in flight: the second waits in the queue
    (deferred, not dropped) until the first request finishes and its pin
    goes; both streams equal their dedicated engines'."""
    p = np.arange(4, 10, dtype=np.int32)
    s = AdapterStore(model, capacity=1, max_rank=4)
    s.register("t1", make_adapter(model, 1))
    s.register("t2", make_adapter(model, 2))
    eng = LLMEngine(model, adapter_store=s, device="cpu", **ENG)
    before = _ADAPTER_DEFERRALS.value()
    r1 = eng.add_request(Request(p, max_new_tokens=4, adapter_id="t1"))
    r2 = eng.add_request(Request(p, max_new_tokens=4, adapter_id="t2"))
    out = eng.run()
    eng.assert_quiescent()
    s.assert_quiescent()
    assert _ADAPTER_DEFERRALS.value() > before
    assert out[r1] == _run_one(model, s, p, 4, adapter_id="t1")
    assert out[r2] == _run_one(model, s, p, 4, adapter_id="t2")


# -------------------------------------------------------------- intake
def test_add_request_validates_adapter(model, store):
    p = np.arange(1, 5, dtype=np.int32)
    eng = LLMEngine(model, adapter_store=store, device="cpu", **ENG)
    with pytest.raises(ValueError):
        eng.add_request(Request(p, adapter_id="unregistered"))
    no_store = LLMEngine(model, device="cpu", **ENG)
    with pytest.raises(ValueError):
        no_store.add_request(Request(p, adapter_id="t1"))
    # a tenant's request under an adapter is served like any other
    rid = eng.add_request(Request(p, max_new_tokens=2, adapter_id="t1",
                                  tenant_id="a"))
    assert len(eng.run()[rid]) == 2
    eng.assert_quiescent()


# ------------------------------------------------- against the reference
def _lora_batch(rs, cap, aidx, width, kind_dims, L=2, r=4):
    """Stacks and indices of one LoRA batch, as the engine builds them:
    numpy, the same for both packages."""
    aidx = np.asarray(aidx, np.int64)
    order = np.argsort(np.where(aidx < 0, cap, aidx), kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    gs = np.bincount(aidx[aidx >= 0], minlength=cap) * width
    lora = {}
    for kind, (k, n) in kind_dims.items():
        lora[kind + "_a"] = rs.randn(L, cap, k, r).astype(np.float32)
        lora[kind + "_b"] = (rs.randn(L, cap, r, n) * 0.1).astype(np.float32)
    lora.update(perm=order.astype(np.int32), inv=inv.astype(np.int32),
                gs=gs.astype(np.int32), aidx=aidx.astype(np.int32))
    return lora


@pytest.mark.parametrize("impl", ["grouped", "gather"])
@pytest.mark.parametrize("aidx,width", [
    ([1, -1, 0, 1], 1),            # decode: two adapters, a null row
    ([-1, 2, 2, -1, 0], 3),        # chunk rows, an empty group (1)
    ([0, 0, 0, 0], 5),             # one adapter, every row
    ([-1, -1, 3], 2)])             # only the last group, null rows first
def test_lora_delta_matches_reference(impl, aidx, width, monkeypatch):
    """``_lora_delta`` against the reference's on the same x, stacks and
    indices, for the qkv and o kinds at layer 1 (fp32: only the
    summation order of the two products differs)."""
    monkeypatch.setenv("PT_MULTILORA_IMPL", impl)
    rs = np.random.RandomState(len(aidx) * 7 + width)
    cap, dims = 4, {"qkv": (32, 64), "o": (32, 32)}
    lora = _lora_batch(rs, cap, aidx, width, dims)
    x = rs.randn(len(aidx), width, 32).astype(np.float32)
    tl = {k: torch.as_tensor(v) for k, v in lora.items()}
    jl = {k: jnp.asarray(v) for k, v in lora.items()}
    for kind in ("qkv", "o"):
        got = tpaged._lora_delta(torch.as_tensor(x), tl, kind, 1)
        want = jpaged._lora_delta(jnp.asarray(x), jl, kind, 1)
        np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)
        null = np.asarray(aidx) < 0
        assert not to_np(got)[null].any()       # null rows exactly 0


def test_paged_forwards_with_lora_match_reference(pair, monkeypatch):
    """Prefill, a chunk and one decode tick of a LoRA batch (rows on two
    adapters and the base) through both packages' paged forwards: logits
    within the fp32 tolerance."""
    jm, tm = pair
    rs = np.random.RandomState(11)
    cap, L, nb, bs, slots, mb = 3, 2, 16, 4, 3, 6
    dims = {"qkv": (32, 64), "o": (32, 32)}
    lora = _lora_batch(rs, cap, [0, -1, 2], 8, dims, L=L)
    tl = {k: torch.as_tensor(v) for k, v in lora.items()}
    jl = {k: jnp.asarray(v) for k, v in lora.items()}
    ids = rs.randint(0, 64, (3, 8)).astype(np.int32)
    lens = np.array([8, 5, 7], np.int32)
    tables = np.arange(slots * 2, dtype=np.int32).reshape(slots, 2)
    rows = np.full((slots, mb), nb, np.int32)
    rows[:, :2] = tables
    tc = PagedKVCache.init(L, nb, bs, 2, 8, slots, mb, torch.float32,
                           device="cpu")
    jc = jpaged.PagedKVCache.init(L, nb, bs, 2, 8, slots, mb, jnp.float32)
    sl = np.arange(slots, dtype=np.int32)
    tlast, tc = tpaged.llama_prefill_paged(tm, ids, lens, tc, sl, rows,
                                           lora=tl)
    jlast, jc = jpaged.llama_prefill_paged(jm, jnp.asarray(ids),
                                           jnp.asarray(lens), jc,
                                           jnp.asarray(sl),
                                           jnp.asarray(rows), lora=jl)
    np.testing.assert_allclose(to_np(tlast), np.asarray(jlast), **F32_TOL)
    # one chunk of 3 tokens a row at each row's length
    lora_c = _lora_batch(np.random.RandomState(12), cap, [2, 0, -1], 3,
                         dims, L=L)
    tlc = {k: torch.as_tensor(v) for k, v in lora_c.items()}
    jlc = {k: jnp.asarray(v) for k, v in lora_c.items()}
    rows[:, 2] = np.arange(slots * 2, slots * 3)
    cids = rs.randint(0, 64, (3, 3)).astype(np.int32)
    cl = np.array([3, 2, 3], np.int32)
    tfull, tc = tpaged.llama_verify_chunk_paged(tm, cids, cl, lens, tc, sl,
                                                rows, lora=tlc)
    jfull, jc = jpaged.llama_verify_chunk_paged(
        jm, jnp.asarray(cids), jnp.asarray(cl), jnp.asarray(lens), jc,
        jnp.asarray(sl), jnp.asarray(rows), lora=jlc)
    live = np.arange(3)[None, :] < cl[:, None]
    np.testing.assert_allclose(to_np(tfull)[live], np.asarray(jfull)[live],
                               **F32_TOL)
    # one decode tick (greedy) with a LoRA batch of width 1
    lora_d = _lora_batch(np.random.RandomState(13), cap, [1, 1, -1], 1,
                         dims, L=L)
    tld = {k: torch.as_tensor(v) for k, v in lora_d.items()}
    jld = {k: jnp.asarray(v) for k, v in lora_d.items()}
    tok = np.array([5, 9, 33], np.int32)
    act = np.array([True, True, True])
    z = np.zeros(slots, np.int32)
    sent = np.full(slots, slots, np.int32)
    temps, tps = np.zeros(slots, np.float32), np.ones(slots, np.float32)
    tn, tlogp, tc = tpaged.llama_decode_tick(
        tm, tok, tc, act, sent, z, z, generator(0, device="cpu"), temps,
        tps, want_logp=True, lora=tld)
    import jax
    jn, jlogp, jc = jpaged.llama_decode_tick(
        jm, jnp.asarray(tok), jc, jnp.asarray(act), jnp.asarray(sent),
        jnp.asarray(z), jnp.asarray(z), jax.random.PRNGKey(0),
        jnp.asarray(temps), jnp.asarray(tps), want_logp=True, lora=jld)
    np.testing.assert_allclose(to_np(tlogp), np.asarray(jlogp), **F32_TOL)
    assert to_np(tn).astype(int).tolist() == np.asarray(jn).tolist()


def test_peft_round_trip_with_reference_keys(pair):
    """``lora_targets`` names the reference's paths; a state dict moves
    between the packages under the reference's keys (strictly);
    ``lora_merge`` of the same adapters gives the same logits."""
    import jax
    jm, tm = pair
    targets = ("qkv_proj", "o_proj")
    assert peft.lora_targets(tm, targets) == jpeft.lora_targets(jm, targets)
    assert (peft.lora_targets(tm) == jpeft.lora_targets(jm))
    jtree = jpeft.lora_init(jm, jax.random.PRNGKey(0), r=4, alpha=8,
                            target_modules=targets)
    sd = make_adapter(tm, 5)
    jtree = jpeft.lora_load_state_dict(jtree, sd)
    ttree = peft.lora_init(tm, generator(0, device="cpu"), r=4, alpha=8,
                           target_modules=targets)
    assert not any(to_np(ab["b"]).any() for k, ab in ttree.items()
                   if k != "_scale")              # B starts at zero
    assert set(peft.lora_state_dict(ttree)) == set(
        jpeft.lora_state_dict(jtree))
    ttree = peft.lora_load_state_dict(ttree, sd)
    back = peft.lora_state_dict(ttree)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])
    assert peft.lora_num_parameters(ttree) == jpeft.lora_num_parameters(
        jtree)
    with pytest.raises(ValueError, match="unexpected"):
        peft.lora_load_state_dict(ttree, {**sd, "x.lora_A": sd["_scale"]})
    ids = np.random.RandomState(3).randint(0, 64, (2, 7))
    merged = peft.lora_merge(tm, ttree)
    want = jpeft.lora_merge(jm, jtree)(jnp.asarray(ids))
    with torch.no_grad():
        got = merged(torch.as_tensor(ids))
        base = tm(torch.as_tensor(ids))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **F32_TOL)
    assert not np.allclose(to_np(got), to_np(base))
    # every weight LoRA does not touch is the base's own tensor
    mp = dict(merged.named_parameters())
    for name, p in tm.named_parameters():
        assert (mp[name] is p) == (name not in ttree), name


def _streams(engine_cls, req_cls, model, store, prompts, aids, **kw):
    eng = engine_cls(model, adapter_store=store, **kw)
    ids = [eng.add_request(req_cls(p, max_new_tokens=6, adapter_id=a))
           for p, a in zip(prompts, aids)]
    eng.run()
    eng.assert_quiescent()
    return [list(map(int, eng.requests[i].tokens)) for i in ids], eng


@pytest.mark.parametrize("async_depth", [0, 2])
def test_mixed_adapter_streams_match_reference_engine(pair, async_depth):
    """A mixed batch (three adapters of ranks 4, 2 and 3, base rows,
    more requests than slots, a prompt longer than ``max_prompt_len``,
    radix hits under one adapter, a capacity-2 cache forcing evictions)
    through the port's engine and the reference's: greedy streams token
    for token. With ``async_depth=2`` a tick with an adapter row never
    cruises (reason ``adapter``) and the streams stay the same."""
    jm, tm = pair
    rs = np.random.RandomState(21)
    sds = {"a": make_adapter(tm, 31, r=4), "b": make_adapter(tm, 32, r=2),
           "c": make_adapter(tm, 33, r=3)}
    ts = AdapterStore(tm, capacity=2, max_rank=4)
    js = JStore(jm, capacity=2, max_rank=4)
    for aid, sd in sds.items():
        ts.register(aid, sd)
        js.register(aid, sd)
    shared = rs.randint(0, 64, 9)
    prompts = [rs.randint(0, 64, n) for n in (5, 8, 3, 21, 6)] + [
        np.concatenate([shared, rs.randint(0, 64, 3)]),
        np.concatenate([shared, rs.randint(0, 64, 4)])]
    aids = ["a", None, "b", "c", "a", "b", "b"]
    kw = dict(num_slots=3, block_size=4, max_prompt_len=16, max_seq_len=40)
    want, _ = _streams(JEngine, JRequest, jm, js, prompts, aids, **kw)
    got, teng = _streams(LLMEngine, Request, tm, ts, prompts, aids,
                         device="cpu", async_depth=async_depth, **kw)
    assert got == want
    ts.assert_quiescent()
    assert teng.mgr.cache_stats["token_hits"] > 0
    if async_depth:
        eng = LLMEngine(tm, adapter_store=ts, device="cpu",
                        async_depth=async_depth, **kw)
        eng.add_request(Request(prompts[0], max_new_tokens=6,
                                adapter_id="a"))
        eng.step()
        assert eng._async_block_reason() == "adapter"
        eng.run()
        eng.assert_quiescent()
