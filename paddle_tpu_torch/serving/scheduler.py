"""Scheduler: admission, deadlines, preemption policy, backpressure —
counterpart of ``paddle_tpu/serving/scheduler.py`` (single device).

It owns the admission queue, the request registry, intake backpressure
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
reference's sites.

Tenants: while no queued request carries a ``tenant_id`` admission is
plain FCFS. Otherwise the queued tenant with the smallest charged/weight
deficit wins the pick (FIFO within a tenant); each admission charges its
tenant prompt + remaining budget tokens and debits the tenant's token
bucket (``set_tenant_rate``) by the same amount. A pass skips
best-effort tenants while the degradation ladder holds L3+ and tenants
whose bucket is dry: both defer, never drop.
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
                                                _ADMITTED, _DEGRADE_SHED,
                                                _PREEMPTED, _QUEUE_WAIT,
                                                _REJECTED,
                                                _TENANT_ADMITTED,
                                                _TENANT_QUEUE_WAIT,
                                                _TENANT_THROTTLED,
                                                _TENANT_WASTE, tenant_label)
from paddle_tpu_torch.serving.types import (EngineDrainingError,
                                            QueueFullError, Request)


class Scheduler:
    """Admission queue (FCFS, or weighted fair share across tenants) +
    deadline/preemption/backpressure policy."""

    def __init__(self, max_queue_len=None, clock=None):
        self.queue: deque[Request] = deque()
        self.requests: dict[int, Request] = {}
        self._ids = itertools.count()
        self.max_queue_len = max_queue_len
        self.clock = clock if clock is not None else time.monotonic
        self.draining = False
        self.has_deadlines = False
        # fair multi-tenant admission: deficit accounting — each
        # admission charges its tenant prompt+budget tokens, and the pick
        # favours the queued tenant with the smallest charged/weight
        # ratio. Empty while no request carries a tenant_id, in which
        # case admission is exactly FCFS
        self.tenant_weights: dict = {}       # tenant -> share weight (1.0)
        self.tenant_charged: dict = {}       # tenant -> tokens charged
        # service class: the ladder's L3 rung sheds (defers, never
        # cancels) "best_effort" tenants at admission; everyone defaults
        # to "standard"
        self.tenant_priority: dict = {}      # tenant -> service class
        # per-tenant token-bucket rate limits (max_tokens_per_s): a
        # tenant with an empty bucket is skipped by the fair pick until
        # refill. Admission debits the same prompt+budget cost the
        # deficit charge uses, and the bucket may go negative — so one
        # large request eventually passes instead of starving forever,
        # and the long-run rate still holds
        self.tenant_rate: dict = {}          # tenant -> (rate/s, burst)
        self.tenant_bucket: dict = {}        # tenant -> [tokens, last_t]

    def set_tenant_weight(self, tenant, weight: float):
        """Relative admission share for a tenant (default 1.0). A tenant
        with weight 2 is charged half as fast, so it wins the fair pick
        twice as often under contention."""
        if weight <= 0:
            raise ValueError("tenant weight must be positive")
        self.tenant_weights[tenant] = float(weight)

    def set_tenant_priority(self, tenant, priority: str):
        """Service class: "standard" (default) or "best_effort" — the
        degradation ladder sheds best-effort admissions at L3+."""
        if priority not in ("standard", "best_effort"):
            raise ValueError(f"priority must be 'standard' or "
                             f"'best_effort', got {priority!r}")
        self.tenant_priority[tenant] = priority

    def set_tenant_rate(self, tenant, max_tokens_per_s, burst=None):
        """Token-bucket rate limit for one tenant (None removes it).
        ``burst`` is the bucket capacity — the tokens a cold tenant may
        consume instantly — and defaults to one second's worth."""
        if max_tokens_per_s is None:
            self.tenant_rate.pop(tenant, None)
            self.tenant_bucket.pop(tenant, None)
            return
        if max_tokens_per_s <= 0:
            raise ValueError("max_tokens_per_s must be positive")
        burst = float(max_tokens_per_s if burst is None else burst)
        if burst <= 0:
            raise ValueError("burst must be positive")
        self.tenant_rate[tenant] = (float(max_tokens_per_s), burst)
        self.tenant_bucket[tenant] = [burst, self.clock()]

    def _bucket_level(self, tenant, now) -> float:
        """Refill the tenant's bucket up to ``now`` and return its level
        (scheduler clock, so rate tests drive a fake clock)."""
        rate, burst = self.tenant_rate[tenant]
        b = self.tenant_bucket.setdefault(tenant, [burst, now])
        b[0] = min(burst, b[0] + max(0.0, now - b[1]) * rate)
        b[1] = now
        return b[0]

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

    def adopt(self, req: Request) -> int:
        """Register an already-prefilled request WITHOUT queueing it — the
        disaggregated install path (the router's KV handoff)."""
        if req.req_id is None or req.req_id in self.requests:
            raise ValueError(f"install needs a fresh explicit req_id, "
                             f"got {req.req_id!r}")
        if req.deadline_s is not None or req.max_queue_s is not None:
            self.has_deadlines = True
        self.requests[req.req_id] = req
        return req.req_id

    def pop_finished(self) -> dict:
        done = {rid: r for rid, r in self.requests.items() if r.done}
        for rid in done:
            del self.requests[rid]
        return done

    def release(self, rid: int) -> Request:
        """Forget a request without finishing it (the router's
        pull-back)."""
        return self.requests.pop(rid, None)

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

    def _pick_index(self, skip=frozenset()):
        """Queue index of the next admission candidate, or None when
        every queued tenant is in ``skip`` (shed or throttled). The head
        (FCFS) while no queued request carries a tenant_id and nothing is
        skipped. Otherwise the token-budget-weighted fair pick: the
        queued tenant with the smallest charged/weight deficit wins, FIFO
        within the tenant. Starvation-free: every admission charges the
        winner, so a saturating tenant's deficit climbs past any light
        tenant's after finitely many admissions. A tenant first seen
        mid-flight starts at the current MINIMUM charge (no retroactive
        credit for time away)."""
        if not skip and all(r.tenant_id is None for r in self.queue):
            return 0
        floor = min(self.tenant_charged.values(), default=0.0)
        best_qi, best_key = None, None
        seen = set()
        for qi, r in enumerate(self.queue):
            t = r.tenant_id
            if t in seen:
                continue                   # FIFO within a tenant
            seen.add(t)
            if t is not None and t in skip:
                continue                   # shed/throttled this pass
            w = self.tenant_weights.get(t, 1.0)
            key = self.tenant_charged.setdefault(t, floor) / w
            if best_key is None or key < best_key:
                best_qi, best_key = qi, key
        return best_qi

    def _charge_tenant(self, req, p):
        """Deficit charge at admission: prompt + remaining budget — the
        worst-case token footprint this admission can consume. Replays
        charge again: a preempted request's re-admission consumes real
        capacity a second time."""
        t = req.tenant_id
        if t is None:
            return
        floor = min(self.tenant_charged.values(), default=0.0)
        gen = max(0, req.max_new_tokens - len(req.tokens))
        cost = len(p) + gen
        self.tenant_charged[t] = self.tenant_charged.get(t, floor) + cost
        if t in self.tenant_rate:
            # debit the rate bucket with the same worst-case cost; it may
            # go negative, which is what lets one oversized request
            # through and then makes the tenant wait out the overdraft
            b = self.tenant_bucket.setdefault(
                t, [self.tenant_rate[t][1], self.clock()])
            b[0] -= cost

    def _admission_skips(self, eng, counted: set) -> frozenset:
        """Tenants excluded from the current admission pass: best-effort
        tenants while the degradation ladder holds L3+, and tenants
        whose token bucket ran dry. Skipped requests stay queued — both
        mechanisms defer, never drop. ``counted`` dedupes the skip
        metrics to once per tenant per ``select_admissions`` call."""
        deg = eng.degrade
        shed = deg is not None and deg.shed_best_effort()
        if not shed and not self.tenant_rate:
            return frozenset()
        now = self.clock()
        skip = set()
        for t in {r.tenant_id for r in self.queue if r.tenant_id is not None}:
            if shed and self.tenant_priority.get(t) == "best_effort":
                skip.add(t)
                if ("shed", t) not in counted:
                    counted.add(("shed", t))
                    _DEGRADE_SHED.inc(tenant=tenant_label(t))
            elif t in self.tenant_rate and self._bucket_level(t, now) <= 0.0:
                skip.add(t)
                if ("throttle", t) not in counted:
                    counted.add(("throttle", t))
                    _TENANT_THROTTLED.inc(tenant=tenant_label(t))
        return frozenset(skip)

    def select_admissions(self, eng):
        """Move queued requests into free slots while the pool can cover
        their worst case; returns (the (slot, req) pairs of the
        whole-prompt prefill, the (slots, req) pairs of beam requests —
        K slots each). Candidate order is :meth:`_pick_index` — FCFS
        without tenants, weighted fair share with them. Prefix-cache hits
        and prompts longer than ``max_prompt_len`` claim their slot for
        the chunked prefill instead. A blocked candidate stops admission
        for the tick (capacity pressure must not starve the fair
        winner)."""
        # admission mutates slot state and block tables the async
        # pipeline's in-flight ticks already captured: the engine lands
        # every dispatched tick before the scheduler touches a slot
        assert not getattr(eng, "_async_win", None), \
            "admission with dispatched-but-undrained async ticks in flight"
        kv = eng.kv
        free_slots = list(np.nonzero(eng.slot_req < 0)[0])
        admits, beam_admits = [], []
        skip_counted: set = set()
        while self.queue and free_slots:
            # recomputed every iteration: an admission can drain its
            # tenant's rate bucket mid-pass
            qi = self._pick_index(self._admission_skips(eng, skip_counted))
            if qi is None:
                break                      # everyone queued is deferred
            req = self.queue[qi]
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
                break                      # do not starve the fair winner
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
            del self.queue[qi]
            req._match_memo = None
            req._adopted = ct if k == 1 else 0
            _ADMITTED.inc()
            self._charge_tenant(req, p)
            wait = (max(0.0, self.clock() - req._submit_t)
                    if req._submit_t is not None else None)
            if wait is not None:
                _QUEUE_WAIT.observe(wait)
            if req.tenant_id is not None:
                _TENANT_ADMITTED.inc(tenant=tenant_label(req.tenant_id))
                if wait is not None:
                    _TENANT_QUEUE_WAIT.observe(
                        wait, tenant=tenant_label(req.tenant_id))
            # every cached token is prefill device work the pool did NOT
            # have to repeat
            GOODPUT.saved(ct, tenant=req.tenant_id)
            if req._resume is not None:
                # replayed after preemption: every resume token past the
                # prefix-cache hit is device work already paid for once
                GOODPUT.waste("replay_prefill", max(0, len(p) - ct),
                              tenant=req.tenant_id)
                if req.tenant_id is not None:
                    _TENANT_WASTE.inc(max(0, len(p) - ct),
                                      tenant=tenant_label(req.tenant_id),
                                      why="replay_prefill")
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
