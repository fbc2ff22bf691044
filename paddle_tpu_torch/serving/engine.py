"""Continuous-batching LLM serving engine — counterpart of
``paddle_tpu/serving/engine.py``, the single-device path.

  * MODELS — the Llama family and, through the structure adapters of
    ``models/paged.py``, the MoE families (Mixtral, Qwen2-MoE,
    ``MoEForCausalLM``); an MoE model arms the ``serving.moe_dispatch``
    fault site before each decode tick.
  * DEVICE — :class:`~paddle_tpu_torch.serving.executor.ModelExecutor`:
    slot-aware prefill (flash kernel), chunked prefill (paged chunk
    kernel) and the fused decode tick (paged decode kernel + on-device
    sampling), all updating the paged pool in place.
  * HOST — :class:`~paddle_tpu_torch.serving.scheduler.Scheduler` (FCFS
    queue, deadlines, preemption policy, backpressure) and
    :class:`~paddle_tpu_torch.serving.kv.KVManager` (block tables, radix
    prefix cache, reservation ledger). Per-tick bookkeeping is numpy; the
    only per-tick device-to-host traffic is the [num_slots] token fetch.

One tick (:meth:`step`) admits queued requests and runs the padded
whole-prompt prefill for prompts of at most ``max_prompt_len`` tokens,
streams longer prompts and prefix-cache hits through chunked prefill,
then runs one decode tick for every active slot. Host decisions —
admission, reservations, preemption victims, table growth — are the
reference's, so a greedy request mix yields the same token streams.

Capacity discipline: without ``preemption`` a request is admitted only
when the pool covers its whole worst case (prompt + max_new_tokens) net
of other reservations; with ``preemption=True`` admission is optimistic
and out-of-blocks evicts the youngest request, which later resumes from
prompt + tokens so far (prefix-cache hits make the recompute cheap).

Sliding-window models (Mistral) recycle the blocks that fall wholly
below ``cur - window``: the paged decode kernel never reads below
``lens - window``, so a sequence holds O(window) live blocks however
long it grows. Dynamic-NTK rope bases follow each row's length (the
prefill's whole prompt, the decode tick's position + 1). Both turn
prefix caching off and refuse chunked prefill, as the reference does.

On the card the decode tick replays a CUDA graph (the port's counterpart
of the reference's jitted tick; ``serving/executor.py``), and the
constructor refuses a model whose head dim or GQA group no card kernel
takes (:func:`card_shape_error`), before any slot or block is claimed.

Async pipelined decode: ``async_depth=K`` keeps up to K decode ticks
dispatched but not yet fetched. While the engine only decodes (no
admission, no chunked prefill, no table growth within the window), each
step replays the next tick with the previous tick's tokens still on the
device and fetches the oldest tick's tokens, so the host's emission work
overlaps the card's. Every other step drains the window first and runs
the synchronous path, so streams are the synchronous engine's, token for
token. ``PT_ASYNC_DECODE=0`` at construction is the kill switch.

Quantized serving: ``kv_dtype="int8"`` keeps the KV pool in int8 with
per-(position, KV head) fp32 scales (quantize on write, dequantize on
read in the paged kernels' int8 mode); ``PT_QUANT_KV=0`` at construction
falls back to a pool of the model's type. Weight-only int8/int4 models
come from ``serving.quant.quantize_for_serving``. An int8 pool arms the
``serving.kv_quant`` fault site before each decode tick.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP.md queue): beams, speculative decoding, multi-LoRA, grammar,
degradation/SLO, tenants, context parallelism and
prefill-only replicas (router).
"""
from __future__ import annotations

import os
import time

import numpy as np

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.models.paged import (is_moe_model, kv_quant_enabled,
                                           model_config)
from paddle_tpu_torch.observability import span as _span
from paddle_tpu_torch.ops.cuda import flash_attention as _flash
from paddle_tpu_torch.ops.cuda import paged_attention as _paged
from paddle_tpu_torch.serving.executor import ModelExecutor
from paddle_tpu_torch.serving.kv import KVManager, cache_block_bytes
from paddle_tpu_torch.serving.scheduler import Scheduler
from paddle_tpu_torch.serving.telemetry import (_ACTIVE_SLOTS, _ASYNC_DEPTH,
                                                _ASYNC_DRAINS, _CANCELLED,
                                                _DRAIN, _FINISHED,
                                                _KV_IN_USE, _KV_UTIL,
                                                _QUEUE_DEPTH, _REJECTED,
                                                _TICK, _TIMEOUTS, _TOK_LAT,
                                                _TOKENS, _TTFT)
from paddle_tpu_torch.serving.types import Request
from paddle_tpu_torch.utils.faults import fault_point

_Q1 = "ROADMAP.md queue 1, item 5 (serving features)"


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet ({_Q1})")


def card_shape_error(cfg):
    """Why the card's kernels cannot serve a model of config ``cfg``, or
    None when they can: the flash and paged kernels (K2-K5) take head dims
    64 and 128 only, and the paged decode kernel (K4) GQA groups up to
    ``MAX_GROUP``. The CPU's plain paths serve every shape."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    if d not in _flash.HEAD_DIMS or d not in _paged.HEAD_DIMS:
        return (f"head dim {d} (hidden {cfg.hidden_size} over {nh} heads): "
                f"the attention kernels take head dims {_flash.HEAD_DIMS}")
    if nh // nkv > _paged.MAX_GROUP:
        return (f"GQA group {nh // nkv} ({nh} query heads over {nkv} KV "
                f"heads): the paged decode kernel takes groups "
                f"1-{_paged.MAX_GROUP}")
    return None


class LLMEngine:
    """Continuous-batching engine over a shared paged KV pool.

    ``num_slots`` concurrent sequences; queued requests are admitted
    MID-FLIGHT into slots freed by finished ones (prefill interleaves with
    decode ticks). ``step()`` is one engine tick; ``run()`` drains
    everything and returns {req_id: generated token list}. ``device``
    defaults to the model's device."""

    def __init__(self, model, *, num_slots=8, block_size=16,
                 max_prompt_len=128, max_seq_len=None, num_blocks=None,
                 eos_token_id=None, temperature=0.0, top_k=None, top_p=None,
                 seed=0, prefix_caching=True, preemption=False,
                 max_queue_len=None, clock=None, draft_model=None,
                 spec_k=4, spec_adaptive=True, prefill_only=False,
                 adapter_store=None, degrade=None, slo=None, kv_dtype=None,
                 cp=1, async_depth=0, device=None):
        for name, val, what in (
                ("draft_model", draft_model, "speculative decoding"),
                ("adapter_store", adapter_store, "multi-LoRA serving"),
                ("degrade", degrade, "the degradation ladder"),
                ("slo", slo, "the SLO tracker"),
                ("prefill_only", prefill_only or None,
                 "disaggregated prefill (router)")):
            if val is not None:
                raise _not_ported(f"{name}= ({what})")
        if int(cp) != 1:
            raise _not_ported("cp > 1 (context-parallel serving)")
        # async pipelined decode: PT_ASYNC_DECODE=0 is the kill switch,
        # read HERE, so depth collapses to 0 and the engine runs exactly
        # the synchronous tick
        async_depth = int(async_depth)
        if async_depth and os.environ.get(
                "PT_ASYNC_DECODE", "1").strip().lower() in (
                    "0", "off", "false"):
            async_depth = 0
        if async_depth < 0:
            raise ValueError(
                f"async_depth must be >= 0, got {async_depth}")
        self.async_depth = async_depth
        cfg = model_config(model)
        self.model = model
        # int8 KV: PT_QUANT_KV=0 is the kill switch, read here — the pool
        # then keeps the model's type
        if kv_dtype is not None and not kv_quant_enabled():
            kv_dtype = None
        self.kv_dtype = kv_dtype
        # MoE models route tokens to experts inside the tick — give chaos a
        # hook at that boundary (a dead expert shard)
        self._is_moe = is_moe_model(model)
        self.device = (model.device if device is None
                       else resolve_device(device))
        if self.device.type == "cuda":
            # refuse HERE, before any slot or block is claimed: a kernel's
            # refusal inside step() would wedge the request mid-tick
            err = card_shape_error(cfg)
            if err is not None:
                raise NotImplementedError(
                    f"LLMEngine on the card: {err} (ROADMAP.md queue 2, "
                    f"Shapes the kernels refuse)")
        self.num_slots = num_slots
        self.block_size = block_size
        self.max_prompt_len = max_prompt_len
        self.max_seq_len = max_seq_len or (max_prompt_len + 256)
        self.max_blocks_per_seq = -(-self.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = num_slots * self.max_blocks_per_seq
        self.eos_token_id = eos_token_id
        # engine defaults; each request may override temperature/top_p
        # (top_k stays engine-global)
        self.default_temp = float(temperature)
        self.default_top_p = 1.0 if top_p is None else float(top_p)
        self.top_k = top_k
        self.temps = np.zeros(num_slots, np.float32)
        self.top_ps = np.ones(num_slots, np.float32)
        # sliding-window models: blocks entirely below cur - window are
        # never attended again (the paged decode kernel reads only
        # positions >= lens - window) — recycle them, bounding live blocks
        # per sequence by O(window), not O(length)
        self.window = cfg.sliding_window
        self._dyn_rope = (cfg.rope_scaling or {}).get("type") == "dynamic"
        # prefix caching is sound only when a block's KV is a function of
        # its token prefix alone: windowed recycling punches holes in the
        # table, and dynamic-NTK makes KV depend on the FULL prompt length
        self.prefix_caching = (bool(prefix_caching) and self.window is None
                               and not self._dyn_rope)
        self.preemption = bool(preemption)

        self.kv = KVManager(num_blocks, block_size)
        self.sched = Scheduler(max_queue_len=max_queue_len, clock=clock)
        self.exe = ModelExecutor(
            model, num_slots=num_slots, num_blocks=num_blocks,
            block_size=block_size, max_blocks_per_seq=self.max_blocks_per_seq,
            top_k=top_k, seed=seed, kv_dtype=kv_dtype,
            async_depth=async_depth, device=self.device)

        # host mirrors (vectorised bookkeeping)
        self.slot_req = np.full(num_slots, -1, np.int64)   # req_id or -1
        self.active = np.zeros(num_slots, bool)
        self.cur = np.zeros(num_slots, np.int64)     # tokens stored in cache
        self.gen = np.zeros(num_slots, np.int64)     # tokens generated
        self.max_gen = np.zeros(num_slots, np.int64)
        self.table_len = np.zeros(num_slots, np.int64)
        self.last_tok = np.zeros(num_slots, np.int32)
        # chunked prefill (prompts > max_prompt_len, prefix-cache hits):
        # rid -> (slot, tokens consumed); slots stay inactive until the
        # last chunk
        self.prefilling: dict[int, tuple] = {}
        self.stats = {"ticks": 0, "preemptions": 0, "timeouts": 0,
                      "cancelled": 0, "rejected": 0}
        self._adm_counter = 0                # admission recency, per slot
        self.adm_order = np.zeros(num_slots, np.int64)
        # the async window: oldest-first dispatched-but-unfetched ticks,
        # each {"tick": the executor's handle, "rng_before": the sampling
        # generator's state before that tick}. _async_live: the executor
        # holds this window's device loop state (seeded from the host
        # mirrors at the window's start). _async_rewound guards the
        # one-shot generator rewind when draining a fully masked tick.
        # stats["async_overrun"]: rows that ran on the card for a slot the
        # host tore down meanwhile (a stream-callback cancel mid-window)
        self._async_win: list[dict] = []
        self._async_live = False
        self._async_rewound = False
        self._async_draining = False
        self.stats["async_overrun"] = 0

    # -------------------------------------------------- attribute surface
    @property
    def mgr(self):
        return self.kv.mgr

    @property
    def queue(self):
        return self.sched.queue

    @property
    def requests(self):
        return self.sched.requests

    @property
    def cache(self):
        return self.exe.cache

    @property
    def _clock(self):
        return self.sched.clock

    # ------------------------------------------------------------- intake
    def add_request(self, req: Request) -> int:
        self.sched.check_backpressure(self.stats)
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "itself produces the first token)")
        if req.num_beams != 1:
            if req.num_beams < 1:
                raise ValueError("num_beams must be >= 1")
            raise _not_ported("num_beams > 1 (beam search)")
        if req.grammar is not None:
            raise _not_ported("grammar-constrained decoding")
        if req.adapter_id is not None:
            raise _not_ported("adapter_id (multi-LoRA serving)")
        if req.tenant_id is not None:
            raise _not_ported("tenant_id (fair-share admission, with the "
                              "degradation ladder and SLO tracker)")
        if len(req.prompt) < 1:
            raise ValueError("prompt must contain at least one token "
                             "(an empty row has no logit to sample from)")
        if len(req.prompt) > self.max_prompt_len and self.window is not None:
            raise NotImplementedError(
                "chunked prefill + sliding-window recycling not combined")
        if len(req.prompt) > self.max_prompt_len and self._dyn_rope:
            # refuse HERE: a raise inside step() would leave the slot
            # claimed and the request wedged in self.prefilling
            raise NotImplementedError(
                "chunked prefill with dynamic-NTK rope is not supported")
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if self._worst_case_blocks(req) > self.mgr.num_blocks:
            # the request could NEVER be admitted: finish it gracefully
            # (finish_reason="too_long") so the FCFS head never jams on it
            rid = self.sched.enqueue(req)
            self.queue.pop()
            req.done = True
            req.finish_reason = "too_long"
            self.stats["rejected"] += 1
            _REJECTED.inc(reason="too_long")
            _FINISHED.inc(reason="too_long")
            return rid
        rid = self.sched.enqueue(req)
        _QUEUE_DEPTH.set(len(self.queue))
        return rid

    def pop_finished(self) -> dict:
        """Remove and return completed requests ({req_id: Request})."""
        return self.sched.pop_finished()

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.active.any())
                or bool(self.prefilling) or bool(self._async_win))

    # --------------------------------------------- cancellation/deadlines
    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Terminate a request wherever it currently lives — queued,
        chunk-prefilling or decoding — freeing its blocks, reservation and
        slot. Returns False for unknown/finished requests."""
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        # in-flight async ticks may already hold this request's next
        # tokens: drain so the emitted stream is exact before its slot is
        # torn down. The drain can finish the request — re-check after
        self._drain_async("cancel")
        if req.done:
            return False
        if not self._detach(req_id):
            return False
        self.kv.release(req_id)
        req.done = True
        req.finish_reason = reason
        self.stats["timeouts" if reason == "timeout" else "cancelled"] += 1
        (_TIMEOUTS if reason == "timeout" else _CANCELLED).inc()
        _FINISHED.inc(reason=reason)
        return True

    def _detach(self, req_id: int) -> bool:
        """Free a live request's slot/blocks wherever it currently is,
        without touching the ledger or finishing it."""
        for i, q in enumerate(self.queue):          # still waiting
            if q.req_id == req_id:
                del self.queue[i]
                return True
        if req_id in self.prefilling:
            slot, _ = self.prefilling.pop(req_id)
            self.mgr.free(req_id)
            self.slot_req[slot] = -1
            return True
        slots = np.nonzero(self.slot_req == req_id)[0]
        if not len(slots):
            return False
        slot = int(slots[0])
        self.mgr.free(req_id)
        self.active[slot] = False
        self.slot_req[slot] = -1
        return True

    def drain(self, cancel_queued: bool = False) -> dict:
        """Graceful shutdown: stop admitting (``add_request`` raises
        EngineDrainingError) but finish everything in flight; returns
        {req_id: tokens} like ``run``."""
        t0 = time.monotonic()
        with _span("serving.drain", cancel_queued=cancel_queued):
            self.sched.draining = True
            if cancel_queued:
                for r in list(self.queue):
                    self.cancel(r.req_id)
            while self.has_work():
                self.step()
            self._refresh_gauges()
        _DRAIN.observe(time.monotonic() - t0)
        return {rid: r.tokens for rid, r in self.requests.items()}

    def assert_quiescent(self):
        """Invariant check once idle: every block is back in the pool
        (prefix-cache parked blocks count — they are reclaimable), no
        standing reservations, no per-sequence tables, and the memory
        ledger reconciles with the block manager."""
        assert not self.has_work(), "engine still has work"
        self.kv.assert_quiescent()
        rec = self.kv.reconcile()
        assert rec["ok"], f"memory ledger out of step: {rec['diffs']}"

    def _pr(self, req) -> np.ndarray:
        """Effective prompt: the resume form (prompt + tokens generated
        before a preemption), the original prompt otherwise."""
        return req.prompt if req._resume is None else req._resume

    def _remaining(self, req) -> int:
        return req.max_new_tokens - len(req.tokens)

    def _worst_case_blocks(self, req) -> int:
        """Blocks a request can ever hold at once. Windowed models recycle
        below-window blocks, so the live span is bounded by the window
        (plus the write-frontier block) — but prefill scatters the WHOLE
        prompt before any recycling, so that is a floor."""
        p = len(self._pr(req))
        total = p + self._remaining(req)
        if self.window is None:
            return self.mgr.blocks_needed(total)
        live = self.mgr.blocks_needed(
            min(total, self.window + 2 * self.block_size))
        return max(self.mgr.blocks_needed(p), live)

    def _recycle_window(self, slots):
        """Free blocks entirely below cur - window for the given slots —
        live blocks per sequence stay O(window). Host-only: the paged
        decode kernel reads no position below lens - window, so the stale
        device-table entries that point at recycled (even reused) blocks
        are never read, and no scatter writes below the frontier."""
        for slot in slots:
            rid = int(self.slot_req[slot])
            dead = int(max(0, self.cur[slot] - self.window)
                       ) // self.block_size
            if dead > 0 and self.mgr.free_prefix(rid, dead):
                self.kv.update(rid)

    # ---------------------------------------------------------- admission
    def _activate(self, slot, req, temp, top_p):
        """Slot bookkeeping for a request whose prompt is now in cache."""
        p = self._pr(req)
        self.slot_req[slot] = req.req_id
        self.active[slot] = True
        self.cur[slot] = len(p)
        self.gen[slot] = 0
        self.max_gen[slot] = self._remaining(req)
        self._adm_counter += 1
        self.adm_order[slot] = self._adm_counter
        self.table_len[slot] = len(self.mgr.tables[req.req_id])
        self.temps[slot] = temp
        self.top_ps[slot] = top_p

    def _req_sampling(self, req):
        return (self.default_temp if req.temperature is None
                else req.temperature,
                self.default_top_p if req.top_p is None else req.top_p)

    def _prefill(self, admits):
        """ONE padded prefill forward for every prompt admitted this tick;
        samples each request's first token."""
        if not admits:
            return []
        a_cap = self.num_slots           # one admission shape
        ids = np.zeros((a_cap, self.max_prompt_len), np.int64)
        lens = np.zeros(a_cap, np.int32)
        slots = np.full(a_cap, self.num_slots, np.int32)   # sentinel = drop
        rows = np.full((a_cap, self.max_blocks_per_seq),
                       self.mgr.num_blocks, np.int32)
        row_t = np.zeros(a_cap, np.float32)
        row_p = np.ones(a_cap, np.float32)
        for i, (slot, req) in enumerate(admits):
            p = self._pr(req)
            ids[i, :len(p)] = p
            lens[i] = len(p)
            slots[i] = slot
            t = self.mgr.tables[req.req_id]
            rows[i, :len(t)] = t
            row_t[i], row_p[i] = self._req_sampling(req)
            self._activate(slot, req, row_t[i], row_p[i])
        logits = self.exe.prefill(ids, lens, slots, rows)
        first = self.exe.sample(logits, row_t, row_p)
        if self.window is not None:
            # a long prompt's below-window blocks die the moment prefill
            # has scattered them — and from here on the sequence can never
            # hold more than the window live bound, so relax its
            # reservation too (the prompt-size floor only mattered DURING
            # prefill)
            self._recycle_window([slot for slot, _ in admits])
            live_bound = self.mgr.blocks_needed(
                self.window + 2 * self.block_size)
            for slot, req in admits:
                rid = req.req_id
                self.kv.need[rid] = min(self.kv.need[rid], live_bound)
                self.kv.update(rid)
        emitted = []
        for i, (slot, req) in enumerate(admits):
            emitted += self._emit(slot, int(first[i]))
        return emitted

    def _prefill_chunks(self):
        """One chunk (<= max_prompt_len tokens) for every in-flight chunked
        prefill: long prompts stream in across ticks while other slots
        keep decoding. The final chunk samples the request's first token
        and activates its slot."""
        pairs = self.mgr.take_copy_plan() if hasattr(
            self.mgr, "take_copy_plan") else []
        if pairs:
            self.exe.apply_block_copies(pairs)
        if not self.prefilling:
            return []
        a_cap, cap = self.num_slots, self.max_prompt_len
        nb, max_b = self.mgr.num_blocks, self.max_blocks_per_seq
        ids = np.zeros((a_cap, cap), np.int64)
        lens = np.zeros(a_cap, np.int32)
        offs = np.zeros(a_cap, np.int32)
        slots = np.full(a_cap, self.num_slots, np.int32)
        rows = np.full((a_cap, max_b), nb, np.int32)
        batch = list(self.prefilling.items())[:a_cap]
        progressed = False
        staged = set()       # rows already in the batch: never evicted
        for i, (rid, (slot, consumed)) in enumerate(batch):
            if rid not in self.prefilling:   # evicted by a later row
                continue
            req = self.requests[rid]
            chunk = self._pr(req)[consumed: consumed + cap]
            t = self._allocate_or_preempt(rid, consumed + len(chunk),
                                          protect=staged)
            if t is None:
                continue         # no blocks this tick: row stays queued
            progressed = True
            staged.add(rid)
            self.kv.update(rid)
            ids[i, :len(chunk)] = chunk
            lens[i] = len(chunk)
            offs[i] = consumed
            slots[i] = slot
            rows[i, :len(t)] = t
        if not progressed and not self.active.any():
            raise MemoryError(
                "paged pool cannot fit one prefill chunk of the remaining "
                "request(s) even after preemption — increase num_blocks or "
                "reduce max_prompt_len (chunk size)")
        if not progressed:
            return []
        logits = self.exe.prefill_chunk(ids, lens, offs, slots, rows)
        emitted = []
        done_rows = []
        for i, (rid, (slot, consumed)) in enumerate(batch):
            if rid not in self.prefilling:
                continue     # evicted mid-batch: must not re-add its row
            req = self.requests[rid]
            consumed += int(lens[i])
            if consumed < len(self._pr(req)):
                self.prefilling[rid] = (slot, consumed)
                continue
            done_rows.append((i, rid, slot))
        if done_rows:
            row_t = np.zeros(a_cap, np.float32)
            row_p = np.ones(a_cap, np.float32)
            for i, rid, _ in done_rows:
                row_t[i], row_p[i] = self._req_sampling(self.requests[rid])
            first = self.exe.sample(logits, row_t, row_p)
            for i, rid, slot in done_rows:
                req = self.requests[rid]
                del self.prefilling[rid]
                if self.prefix_caching:
                    self.mgr.commit_prefix(rid, self._pr(req))
                self._activate(slot, req, row_t[i], row_p[i])
                emitted += self._emit(slot, int(first[i]))
        return emitted

    # --------------------------------------------------------- preemption
    def _preempt(self, protect_rid=None) -> bool:
        # preemption rewrites a victim's resume prompt from req.tokens —
        # tokens still in flight in the async window must land first or
        # the replayed stream would silently drop them
        self._drain_async("boundary")
        return self.sched.preempt(self, protect_rid)

    def _preempt_from(self, cand) -> bool:
        self._drain_async("boundary")
        return self.sched.preempt_from(self, cand)

    def _allocate_or_preempt(self, rid: int, n_tokens: int, protect=None):
        """mgr.allocate with out-of-blocks recovery: preempt (never
        ``rid`` itself, nor anything in ``protect`` — rows already staged
        into this tick's batch) until the allocation fits. Returns the
        table, or None when preemption is off / nothing could be freed.
        Respects OTHER requests' standing reservations."""
        protect = Scheduler._protect(protect) | {rid}
        while True:
            others = self.kv.reserved - self.kv.resv.get(rid, 0)
            need = (self.mgr.blocks_needed(n_tokens)
                    - len(self.mgr.tables.get(rid, [])))
            try:
                # chaos hook: an injected MemoryError exercises the same
                # preempt-and-retry recovery a genuinely dry pool would
                fault_point("serving.alloc", rid=rid, engine=self)
                if need > self.mgr.free_blocks - max(0, others):
                    raise MemoryError("allocation would dip into blocks "
                                      "reserved by other requests")
                return self.mgr.allocate(rid, n_tokens)
            except MemoryError:
                if not self.preemption or not self._preempt(
                        protect_rid=protect):
                    if self.preemption:
                        return None
                    raise

    # ------------------------------------------------------------- decode
    def _grow_tables(self, mask):
        """At most one new block per slot per tick; returns the
        incremental (rows, cols, vals) update triple (sentinel-padded)."""
        rows = np.full(self.num_slots, self.num_slots, np.int32)
        cols = np.zeros(self.num_slots, np.int32)
        vals = np.zeros(self.num_slots, np.int32)
        crossing = mask & (self.cur // self.block_size >= self.table_len)
        for slot in np.nonzero(crossing)[0]:     # <= once per bs ticks/slot
            if not self.active[slot]:
                continue                 # preempted earlier in this loop
            rid = int(self.slot_req[slot])
            t = self._allocate_or_preempt(rid, int(self.cur[slot]) + 1)
            if t is None:
                # nothing else to evict: preempt THIS slot (it re-queues
                # with its progress and resumes when blocks free up)
                if not self._preempt_from([int(slot)]):
                    raise MemoryError(
                        "paged cache out of blocks and the growing slot "
                        "is not preemptible (windowed/dynamic-rope resume "
                        "exceeds max_prompt_len)")
                continue
            self.kv.update(rid)
            idx = min(int(self.table_len[slot]), len(t) - 1)
            rows[slot] = slot
            cols[slot] = idx
            vals[slot] = t[idx]
            self.table_len[slot] = idx + 1
        if self.window is not None:
            self._recycle_window(np.nonzero(self.active)[0])
        return rows, cols, vals

    def _emit(self, slot: int, token: int):
        """Record one sampled token for the request in ``slot``; finish on
        EOS or length. Returns [(req_id, token)]."""
        rid = int(self.slot_req[slot])
        if rid < 0:
            return []        # slot emptied mid-tick (stream-side cancel)
        req = self.requests[rid]
        req.tokens.append(token)
        _TOKENS.inc()
        now = self._clock()
        if req._first_tok_t is None:
            req._first_tok_t = now
            if req._submit_t is not None:
                _TTFT.observe(max(0.0, now - req._submit_t))
        elif req._last_tok_t is not None:
            _TOK_LAT.observe(max(0.0, now - req._last_tok_t))
        req._last_tok_t = now
        if req.stream is not None:
            req.stream(req, token)
        self.last_tok[slot] = token
        self.gen[slot] += 1
        eos = self.eos_token_id is not None and token == self.eos_token_id
        if eos or self.gen[slot] >= self.max_gen[slot]:
            req.done = True
            req.finish_reason = "eos" if eos else "length"
            _FINISHED.inc(reason=req.finish_reason)
            if self.prefix_caching:
                # commit the GENERATED span too (up to the cache frontier
                # ``cur``: the token just sampled has no KV yet)
                seq = np.concatenate([req.prompt,
                                      np.asarray(req.tokens, np.int32)])
                self.mgr.commit_prefix(
                    rid, seq[:min(len(seq), int(self.cur[slot]))])
            self.mgr.free(rid)
            self.kv.release(rid)
            self.active[slot] = False
            self.slot_req[slot] = -1
        return [(rid, token)]

    # --------------------------------------------------------------- tick
    def _refresh_gauges(self):
        if self.async_depth:
            _ASYNC_DEPTH.set(self.async_depth)
        _QUEUE_DEPTH.set(len(self.queue))
        _ACTIVE_SLOTS.set(int(self.active.sum()))
        used = self.mgr.num_blocks - self.mgr.free_blocks
        _KV_IN_USE.set(used)
        _KV_UTIL.set(used / self.mgr.num_blocks if self.mgr.num_blocks
                     else 0.0)
        self.kv.push_prefix_metrics()
        led = self.kv.ledger
        if led.enabled:
            led.publish(bytes_per_block=cache_block_bytes(self.cache),
                        resident_tokens=int(self.cur[self.active].sum())
                        + sum(c for _, c in self.prefilling.values()))

    def step(self):
        """One engine tick: expire deadlines, admit waiting requests into
        free slots (their prefill runs now), advance chunked prefills,
        then one decode tick for every active slot. Returns [(req_id,
        new_token), ...]."""
        t0 = time.monotonic()
        try:
            with _span("serving.step"):
                return self._step_impl()
        finally:
            _TICK.observe(time.monotonic() - t0)
            self._refresh_gauges()

    def _step_impl(self):
        """Exception-atomicity shim around :meth:`_step_inner` for the
        async pipeline: a fault raised mid-step while dispatched ticks are
        in flight must not strand their tokens — drain the window (its
        emissions are exactly the tokens the synchronous engine produced
        in the preceding steps), then re-raise. With an empty window this
        adds nothing to the synchronous path."""
        try:
            return self._step_inner()
        except BaseException:
            if self._async_win:
                self._drain_async("exception")
            raise

    # -------------------------------------------- async pipelined decode
    def _async_block_reason(self):
        """Why the NEXT tick cannot cruise in the async pipeline — None
        means pure decode (dispatch without fetching). Any other reason
        drains the window first, then the step runs the synchronous path,
        so table mutations, host sampling and the ledger stay tick-exact:

        admit    requests waiting for admission (the scheduler runs)
        prefill  chunked prefill in flight
        finish   no active slot (the drain emits the tail; run() ends)
        window   sliding-window recycling mutates tables every tick
        growth   a slot would cross a block boundary within the window

        The reference's other reasons — ``mode`` (prefill-only replica,
        cp > 1), ``beam``, ``grammar``, ``adapter`` and ``spec`` — cannot
        arise while the port refuses those features."""
        if self.queue:
            return "admit"
        if self.prefilling:
            return "prefill"
        act = self.active
        if not act.any():
            return "finish"
        if self.window is not None:
            return "window"
        # the host ``cur`` mirror lags by the window length: the tick
        # about to be dispatched writes position cur + len(win), which
        # must already have a table entry (cruise never mutates tables)
        d = len(self._async_win)
        if (((self.cur[act] + d) // self.block_size)
                >= self.table_len[act]).any():
            return "growth"
        return None

    def _async_step(self):
        """One cruise tick of the depth-K pipeline: dispatch the next
        decode tick with the PREVIOUS tick's tokens still on the device,
        then — once the window exceeds ``async_depth`` — fetch and emit
        the OLDEST tick's tokens while the newer ones run. The EOS /
        max-gen stop is evaluated on the device, so a slot that finished
        at tick N is masked out of tick N+1 before the host sees its
        token."""
        act = self.active.copy()
        # chaos parity with the synchronous tick: these sites fire BEFORE
        # the dispatch, so an injected exception aborts with the cache,
        # tables and ledger untouched (the shim drains the window)
        if self._is_moe:
            fault_point("serving.moe_dispatch", engine=self,
                        slots=np.nonzero(act)[0])
        if self.cache.k_scale_store:
            fault_point("serving.kv_quant", engine=self,
                        slots=np.nonzero(act)[0])
        if not self._async_live:
            # window start: seed the device loop state from the host
            # mirrors (exact — the window was just drained)
            self.exe.async_begin(
                self.last_tok, self.gen, self.max_gen,
                -1 if self.eos_token_id is None else int(self.eos_token_id))
        rng_before = self.exe.gen.get_state()
        tick = self.exe.decode_tick_async(act, self.temps, self.top_ps)
        self._async_live = True
        self._async_rewound = False
        self._async_win.append({"tick": tick, "rng_before": rng_before})
        self.stats["ticks"] += 1
        emitted = []
        if len(self._async_win) > self.async_depth:
            # steady state: drain exactly the oldest tick. The guard keeps
            # a stream-callback cancel() from draining the window out from
            # under us (it detaches at once; the dead slot's rows still in
            # flight count as async_overrun)
            self._async_draining = True
            try:
                emitted += self._drain_one()
            finally:
                self._async_draining = False
        return emitted

    def _drain_one(self):
        """Fetch and emit the oldest dispatched tick. The host mirrors
        (``cur``/``gen``/``last_tok``) advance HERE, so at every drain
        boundary they hold exactly the synchronous engine's values. A
        fully masked tick (every slot stopped on the card before the host
        noticed) emits nothing and rewinds the generator to its state
        before that tick: the synchronous engine never ran it, so never
        drew its noise."""
        e = self._async_win.pop(0)
        nxt, ran = e["tick"].fetch()
        if not ran.any():
            if not self._async_rewound:
                self.exe.gen.set_state(e["rng_before"])
                self._async_rewound = True
            return []
        live = ran & (self.slot_req >= 0)
        self.stats["async_overrun"] += int(ran.sum() - live.sum())
        self.cur += live
        emitted = []
        for slot in np.nonzero(live)[0]:
            emitted += self._emit(int(slot), int(nxt[slot]))
        return emitted

    def _drain_async(self, why: str):
        """Drain the whole window (fetch and emit every dispatched tick),
        leaving the host mirrors tick-exact and the device loop state
        discarded (the next cruise re-seeds it). A no-op when the window
        is empty or a drain is already on the stack (a stream callback's
        re-entry)."""
        if not self._async_win or self._async_draining:
            return []
        self._async_draining = True
        try:
            emitted = []
            while self._async_win:
                emitted += self._drain_one()
            self._async_live = False
            _ASYNC_DRAINS.inc(why=why)
            return emitted
        finally:
            self._async_draining = False

    def _step_inner(self):
        # chaos hooks: serving.tick may raise or stall; serving.preempt
        # rules receive the engine and typically call engine._preempt() to
        # induce a preemption the pool never asked for. Both fire before
        # any mutation of the step
        fault_point("serving.tick", engine=self)
        fault_point("serving.preempt", engine=self)
        self.sched.expire(self.cancel)
        emitted = []
        if self.async_depth:
            why = self._async_block_reason()
            if why is None:
                return self._async_step()
            if self._async_win:
                # boundary: land every in-flight tick before the host
                # mutates tables or slots — the drained emissions belong
                # to this step's return
                emitted += self._drain_async(why)
        admits = self.sched.select_admissions(self)
        emitted += self._prefill(admits)
        emitted += self._prefill_chunks()
        if not self.active.any():
            return emitted
        if self._is_moe:
            # chaos: fires BEFORE table growth and the tick's in-place
            # cache writes, so an injected exception aborts the tick with
            # the cache, tables and table_len untouched — cancel/free
            # reclaims every block and assert_quiescent stays clean
            fault_point("serving.moe_dispatch", engine=self,
                        slots=np.nonzero(self.active)[0])
        if self.cache.k_scale_store:
            # chaos: the tick's quantize-on-write is about to run (int8
            # pools only). Fires before table growth and the in-place
            # writes, so an injected exception leaves pools, scale pools,
            # tables and the ledger untouched (exception-atomic)
            fault_point("serving.kv_quant", engine=self,
                        slots=np.nonzero(self.active)[0])
        rows, cols, vals = self._grow_tables(self.active.copy())
        # growth may have preempted slots — recompute the mask after it
        run_mask = self.active.copy()
        nxt = self.exe.decode_tick(self.last_tok, run_mask, rows, cols,
                                   vals, self.temps, self.top_ps)
        self.cur += run_mask
        for slot in np.nonzero(run_mask)[0]:
            emitted += self._emit(int(slot), int(nxt[slot]))
        self.stats["ticks"] += 1
        return emitted

    def run(self) -> dict:
        """Drain queue + slots; returns {req_id: generated token list}."""
        while self.has_work():
            self.step()
        return {rid: r.tokens for rid, r in self.requests.items()}
