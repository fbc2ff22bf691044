"""Scheduler: admission, deadlines, preemption policy, backpressure —
counterpart of ``paddle_tpu/serving/scheduler.py`` (single device).

It owns the FCFS queue, the request registry, intake backpressure
(bounded queue + drain flag), wall-clock deadlines and the preemption
victim policy, and mutates slot/ledger state only through the
orchestrating :class:`~paddle_tpu_torch.serving.engine.LLMEngine`
(``eng``). Admission order, the capacity gates and the victim choices
are the reference's, decision for decision, so both engines serve the
same request mix through the same ticks. A request carrying a LoRA
``adapter_id`` is admitted only once the engine's ``AdapterStore`` has
made its adapter device-resident and pinned it; the radix prefix cache
keeps one trie per adapter. A beam request (``num_beams`` K > 1) needs K
free slots and holds its group's whole worst case up front; preemption
never picks a beam slot. Admissions, replays and preemptions land in the
request tracker, the flight recorder and the goodput ledger at the
reference's sites. Tenant fair-share, rate limits and the degradation
ladder's shedding are queued (ROADMAP.md queue 1).
"""
from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np

from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.goodput import GOODPUT
from paddle_tpu_torch.observability.requests import REQUESTS
from paddle_tpu_torch.serving.telemetry import (_ADAPTER_DEFERRALS,
                                                _ADMITTED, _PREEMPTED,
                                                _QUEUE_WAIT, _REJECTED)
from paddle_tpu_torch.serving.types import (EngineDrainingError,
                                            QueueFullError, Request)


class Scheduler:
    """FCFS admission queue + deadline/preemption/backpressure policy."""

    def __init__(self, max_queue_len=None, clock=None):
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self.max_queue_len = max_queue_len
        self.clock = clock if clock is not None else time.monotonic
        self.draining = False
        self.has_deadlines = False

    # ------------------------------------------------------------- intake
    def check_backpressure(self, stats: dict):
        """Reject-on-full/reject-while-draining intake gates."""
        if self.draining:
            stats["rejected"] += 1
            _REJECTED.inc(reason="draining")
            raise EngineDrainingError(
                "engine is draining — finishing in-flight requests, "
                "admitting nothing new")
        if (self.max_queue_len is not None
                and len(self.queue) >= self.max_queue_len):
            stats["rejected"] += 1
            _REJECTED.inc(reason="queue_full")
            raise QueueFullError(
                f"admission queue full ({self.max_queue_len} waiting) — "
                "shed load or retry later")

    def enqueue(self, req: Request) -> int:
        """Assign/validate the request id, stamp the submit time, and
        append to the FCFS queue."""
        if req.req_id is None:
            req.req_id = next(self._ids)
        else:
            if req.req_id in self.requests:
                raise ValueError(f"req_id {req.req_id} already exists")
            self._ids = itertools.count(
                max(req.req_id + 1, next(self._ids)))
        req._submit_t = self.clock()
        if req.deadline_s is not None or req.max_queue_s is not None:
            self.has_deadlines = True
        self.requests[req.req_id] = req
        self.queue.append(req)
        return req.req_id

    def pop_finished(self) -> dict:
        done = {rid: r for rid, r in self.requests.items() if r.done}
        for rid in done:
            del self.requests[rid]
        return done

    # ---------------------------------------------------------- deadlines
    def expire(self, cancel):
        """Finish requests whose wall-clock budget ran out: absolute
        ``deadline_s`` for everyone, ``max_queue_s`` additionally for
        requests still waiting for admission."""
        if not self.has_deadlines or not self.requests:
            return
        now = self.clock()
        queued = {r.req_id for r in self.queue}
        for rid, r in list(self.requests.items()):
            if r.done or r._submit_t is None:
                continue
            age = now - r._submit_t
            if ((r.deadline_s is not None and age >= r.deadline_s)
                    or (rid in queued and r.max_queue_s is not None
                        and age >= r.max_queue_s)):
                cancel(rid, reason="timeout")

    # ---------------------------------------------------------- admission
    def _prefix_lookup(self, eng, req):
        """Memoized prefix-cache probe, keyed on the manager's
        ``cache_epoch`` and the effective prompt length (a resume changes
        it), so a stale match is impossible."""
        kv = eng.kv
        p = eng._pr(req)
        epoch = getattr(kv.mgr, "cache_epoch", None)
        memo = req._match_memo
        if (memo is not None and epoch is not None
                and memo[0] == epoch and memo[1] == len(p)):
            return memo[2]
        m = kv.mgr.match_prefix(p, adapter=req.adapter_id)
        if epoch is not None:
            req._match_memo = (epoch, len(p), m)
        return m

    def select_admissions(self, eng):
        """Move queued requests (FCFS) into free slots while the pool can
        cover their worst case; returns (the (slot, req) pairs of the
        whole-prompt prefill, the (slots, req) pairs of beam requests —
        K slots each). Prefix-cache hits and prompts longer than
        ``max_prompt_len`` claim their slot for the chunked prefill
        instead. A blocked head stops admission for the tick."""
        # admission mutates slot state and block tables the async
        # pipeline's in-flight ticks already captured: the engine lands
        # every dispatched tick before the scheduler touches a slot
        assert not getattr(eng, "_async_win", None), \
            "admission with dispatched-but-undrained async ticks in flight"
        kv = eng.kv
        free_slots = list(np.nonzero(eng.slot_req < 0)[0])
        admits, beam_admits = [], []
        while self.queue and free_slots:
            req = self.queue[0]
            k = req.num_beams
            p = eng._pr(req)
            # prefix-cache lookup BEFORE the capacity gate: shared blocks
            # cost nothing, so a mostly-cached prompt admits under
            # pressure an uncached one would wait out
            cached = (self._prefix_lookup(eng, req)
                      if eng.prefix_caching and k == 1 else None)
            n_shared = len(cached) if cached else 0
            ct = (getattr(cached, "token_count", n_shared * eng.block_size)
                  if cached else 0)
            if eng.preemption and k == 1:
                # optimistic: cover only the first prefill chunk (+1
                # decode-headroom block); out-of-blocks later preempts
                need = (kv.blocks_needed(
                    min(len(p), ct + eng.max_prompt_len)) - n_shared + 1)
            else:
                need = eng._worst_case_blocks(req)
            if k > len(free_slots) or need > kv.free_blocks - kv.reserved:
                kv.record_stall(need, slots_short=(k > len(free_slots)))
                break
            if req.adapter_id is not None and eng._multilora_on():
                # make the adapter device-resident and PIN it before the
                # request can touch a slot. Failure (cache fully pinned,
                # or an injected serving.adapter_swap fault) defers the
                # admission — the request stays queued, retried next
                # tick, and nothing was mutated (the fault site fires
                # before the upload; acquire is exception-atomic)
                try:
                    eng.adapter_store.acquire(req.adapter_id)
                except Exception as e:
                    _ADAPTER_DEFERRALS.inc()
                    FLIGHT.record("serving.adapter_defer",
                                  rid=req.req_id,
                                  adapter=str(req.adapter_id),
                                  err=f"{type(e).__name__}: {e}")
                    break
                eng._adapter_pins[req.req_id] = req.adapter_id
            self.queue.popleft()
            req._match_memo = None
            req._adopted = ct if k == 1 else 0
            _ADMITTED.inc()
            if req._submit_t is not None:
                _QUEUE_WAIT.observe(max(0.0, self.clock() - req._submit_t))
            # every cached token is prefill device work the pool did NOT
            # have to repeat
            GOODPUT.saved(ct, tenant=req.tenant_id)
            if req._resume is not None:
                # replayed after preemption: every resume token past the
                # prefix-cache hit is device work already paid for once
                GOODPUT.waste("replay_prefill", max(0, len(p) - ct),
                              tenant=req.tenant_id)
                REQUESTS.event(req, "replayed", replica=eng.trace_name,
                               resume_tokens=len(p), cached_tokens=ct)
            REQUESTS.event(req, "admitted", replica=eng.trace_name,
                           cached_tokens=ct)
            if eng.preemption and k == 1:
                need = 0                   # no standing reservation
            kv.begin(req.req_id, need)
            if k > 1:
                # the group's whole worst case is held up front and
                # relaxed to (need - live) as its blocks materialise
                slots = [int(free_slots.pop(0)) for _ in range(k)]
                kv.hold(req.req_id, need)
                beam_admits.append((slots, req))
                continue
            slot = int(free_slots.pop(0))
            if cached:
                kv.mgr.adopt_prefix(req.req_id, cached)
            if cached or len(p) > eng.max_prompt_len:
                # chunk-prefill path from offset ct: the slot is claimed
                # INACTIVE; blocks allocate chunk by chunk against the
                # reservation
                kv.hold(req.req_id, need)
                eng.slot_req[slot] = req.req_id
                eng._adm_counter += 1
                eng.adm_order[slot] = eng._adm_counter
                eng.prefilling[req.req_id] = (slot, ct)
                continue
            kv.allocate(req.req_id, len(p))
            if eng.prefix_caching:
                kv.mgr.commit_prefix(req.req_id, p, adapter=req.adapter_id)
            kv.update(req.req_id)
            admits.append((slot, req))
        return admits, beam_admits

    # --------------------------------------------------------- preemption
    @staticmethod
    def _protect(protect_rid):
        """Normalise the protect argument to a set of req_ids."""
        if protect_rid is None:
            return frozenset()
        if isinstance(protect_rid, (set, frozenset, list, tuple)):
            return frozenset(protect_rid)
        return frozenset((protect_rid,))

    def preempt(self, eng, protect_rid=None) -> bool:
        """Evict the YOUNGEST active greedy request (LIFO — the oldest
        in-flight work is closest to completion; beam slots are never
        victims); it re-queues at the head with resume-prompt = prompt +
        generated-so-far. With no active candidate, evict the youngest
        chunk-prefilling request. Returns False when nothing is
        preemptible."""
        protect = self._protect(protect_rid)
        cand = [int(s) for s in np.nonzero(eng.active & ~eng.is_beam)[0]
                if int(eng.slot_req[s]) not in protect]
        if self.preempt_from(eng, cand):
            return True
        return self.preempt_prefilling(eng, protect_rid)

    def preempt_prefilling(self, eng, protect_rid=None) -> bool:
        """Evict the youngest (by admission order) in-flight chunked
        prefill: free its blocks and re-queue it at the head; consumed
        chunks are committed to the prefix cache so the replay re-matches
        them. Rows already staged into this tick's chunk batch ride in
        ``protect_rid``."""
        protect = self._protect(protect_rid)
        cand = [rid for rid in eng.prefilling if rid not in protect]
        if not cand:
            return False
        rid = max(cand, key=lambda r: eng.adm_order[eng.prefilling[r][0]])
        slot, consumed = eng.prefilling.pop(rid)
        req = self.requests[rid]
        if eng.prefix_caching and consumed:
            eng.kv.mgr.commit_prefix(rid, eng._pr(req)[:consumed],
                                     adapter=req.adapter_id)
        eng.kv.free(rid)
        eng.kv.release(rid)
        eng._release_adapter(rid)
        eng.slot_req[slot] = -1
        self.queue.appendleft(req)
        eng.stats["preemptions"] += 1
        _PREEMPTED.inc()
        FLIGHT.record("serving.preempt", rid=rid, slot=int(slot),
                      phase="prefill")
        REQUESTS.event(req, "preempted", replica=eng.trace_name,
                       phase="prefill")
        return True

    def preempt_from(self, eng, cand) -> bool:
        if eng.window is not None or eng._dyn_rope:
            # the resume prefill rides the chunk path, which refuses
            # window-recycling and dynamic-NTK for long prompts — only
            # slots whose resume form fits one plain prefill qualify
            cand = [s for s in cand
                    if len(self.requests[int(eng.slot_req[s])].prompt)
                    + len(self.requests[int(eng.slot_req[s])].tokens)
                    <= eng.max_prompt_len]
        if not cand:
            return False
        slot = max(cand, key=lambda s: eng.adm_order[s])
        rid = int(eng.slot_req[slot])
        req = self.requests[rid]
        req._resume = (np.concatenate(
            [req.prompt, np.asarray(req.tokens, np.int32)])
            if req.tokens else req.prompt)
        if eng.prefix_caching:
            # park everything the victim computed up to the cache
            # frontier ``cur`` (the newest sampled token has no KV yet)
            eng.kv.mgr.commit_prefix(
                rid, req._resume[:min(len(req._resume),
                                      int(eng.cur[slot]))],
                adapter=req.adapter_id)
        eng.kv.free(rid)
        eng.kv.release(rid)
        eng._release_adapter(rid)
        eng.active[slot] = False
        eng.slot_req[slot] = -1
        eng.slot_aidx[slot] = -1
        eng.draft_cur[slot] = 0     # the draft cache is freed with the slot
        eng._grammar.pop(slot, None)   # rebound from req.tokens on resume
        self.queue.appendleft(req)
        eng.stats["preemptions"] += 1
        _PREEMPTED.inc()
        FLIGHT.record("serving.preempt", rid=rid, slot=int(slot),
                      phase="decode")
        REQUESTS.event(req, "preempted", replica=eng.trace_name,
                       phase="decode")
        return True
