"""Multi-replica serving router — counterpart of
``paddle_tpu/serving/router.py``.

In-process front end over N :class:`LLMEngine` replicas. Three jobs:

  * **Dispatch** — least-outstanding-requests across healthy replicas,
    with session affinity (requests sharing a ``session_id`` stick to
    one replica so a session's prefix-cache blocks stay local) and
    per-replica health gating: a replica whose
    :class:`~paddle_tpu_torch.observability.health.HealthEvaluator`
    verdict is CRIT (or that the router declared dead) receives nothing.
  * **Rebalancing** — ``drain_replica`` requeues the draining replica's
    waiting requests BEFORE draining it (otherwise affinity-pinned work
    the router holds for it would wait forever — the drain deadlock);
    a replica death pulls every live request back and re-dispatches it
    to a healthy replica exactly once.
  * **Disaggregated prefill/decode** — ``role="prefill"`` replicas run
    admission + (chunked) prefill only, then each finished sequence is
    extracted and installed into a ``role="decode"`` replica through the
    :class:`~paddle_tpu_torch.serving.transfer.KVTransfer` seam. Greedy
    output is identical to a single-engine run. ``PT_ROUTER_DISAGG=0``
    is the kill switch: roles collapse to "both" and every replica
    serves end-to-end.

Graceful degradation adds the reaction layer: an optional shared
:class:`~paddle_tpu_torch.serving.degrade.DegradationController` (polled
once per step; L4 rejects new sessions here with ``OverloadError``),
periodic host-side session snapshots (``snapshot_every``) that restore a
request onto a surviving replica after a *second* replica death instead
of failing it, and a hardened handoff transport
(:class:`~paddle_tpu_torch.serving.transfer.TransportPolicy`) —
per-attempt geometry+checksum validation with bounded retries, plus
straggler hedging to another decode replica when a delivery blows its
p95-derived deadline (first install wins; the loser copy is dropped
without ever touching a pool).

The router is deliberately single-threaded per ``step()`` — replicas
advance in one round-robin sweep, which keeps the chaos sites
(``router.dispatch``, ``router.kv_transfer``, ``router.kv_stall``,
``router.kv_partial``, ``router.replica_death``) deterministic.
``run(parallel=True)`` is the throughput mode: one thread per replica
free-runs its engine (pure scale-out), falling back to
sequential rounds when disaggregation or router-level work needs the
orchestration loop. On one card the replicas are engines of one process
that share it (and may share one model's weights).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

import numpy as np

from paddle_tpu_torch.observability import span as _span
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.health import (HEALTH,
                                                   HealthEvaluator,
                                                   gauge_imbalance)
from paddle_tpu_torch.observability.requests import REQUESTS
from paddle_tpu_torch.serving.engine import LLMEngine
from paddle_tpu_torch.serving.telemetry import (
    _R_DEATHS, _R_DISPATCH, _R_HEALTH, _R_HEDGE_RATE, _R_HEDGES,
    _R_OUTSTANDING, _R_REQUEUES, _R_RESTORES, _R_TRANSFER_BLOCKS,
    _R_TRANSFER_RETRIES, _R_TRANSFER_SECONDS, _R_TRANSFERS, _REJECTED,
    _TENANT_FINISHED, _TENANT_REJECTED, tenant_label)
from paddle_tpu_torch.serving.transfer import (DeviceKVTransfer,
                                               KVTransferError,
                                               TransportPolicy,
                                               validate_payload)
from paddle_tpu_torch.serving.types import (EngineDrainingError,
                                            OverloadError, QueueFullError,
                                            Request)
from paddle_tpu_torch.utils.faults import fault_point

_VERDICT_NUM = {"OK": 0, "WARN": 1, "CRIT": 2}


class Replica:
    """One engine behind the router: a name, a role, and a health
    evaluator whose verdict gates dispatch. ``role`` is "both" (serve
    end-to-end), "prefill", or "decode" (disaggregated)."""

    def __init__(self, engine: LLMEngine, name: str = None,
                 role: str = "both", health: HealthEvaluator = None):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self.engine = engine
        self.name = name
        self.role = role
        # default evaluator has no rules -> always OK; tests/deployments
        # attach per-replica rules (e.g. on that replica's gauges)
        self.health = health if health is not None else HealthEvaluator()
        self.alive = True
        self.draining = False

    def verdict(self) -> str:
        if not self.alive:
            return "CRIT"
        try:
            return self.health.evaluate()["status"]
        except Exception:
            return "CRIT"        # an unevaluable replica is not dispatchable


class Router:
    """Least-outstanding-requests front end over N engine replicas."""

    def __init__(self, replicas, *, affinity=True, max_queue_len=None,
                 kv_transfer=None, install_imbalance_rule=True,
                 degrade=None, slo=None, snapshot_every=None,
                 max_session_restores=4, transport=None, clock=None):
        self.replicas: list[Replica] = []
        for i, r in enumerate(replicas):
            if not isinstance(r, Replica):
                r = Replica(r)
            if r.name is None:
                r.name = f"r{i}"
            self.replicas.append(r)
        if not self.replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in self.replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        for r in self.replicas:
            # request-tracker events carry the replica name; the tracker
            # stitches cross-replica timelines on it
            r.engine.trace_name = r.name
        # kill switch: PT_ROUTER_DISAGG=0 collapses roles to "both" — one
        # env flip turns a misbehaving disaggregated deployment into
        # plain replicated serving without touching the topology
        self.disagg = (any(r.role != "both" for r in self.replicas)
                       and os.environ.get("PT_ROUTER_DISAGG", "1") != "0")
        if not self.disagg:
            for r in self.replicas:
                r.role = "both"
                r.engine.prefill_only = False
        else:
            if not any(r.role in ("both", "decode") for r in self.replicas):
                raise ValueError("disaggregated topology has no decode-"
                                 "capable replica (role both/decode)")
            bs = {r.engine.block_size for r in self.replicas}
            if len(bs) != 1:
                raise ValueError(f"replicas disagree on block_size: {bs}")
            for r in self.replicas:
                r.engine.prefill_only = (r.role == "prefill")
        self.affinity = bool(affinity)
        self.kv_transfer = (kv_transfer if kv_transfer is not None
                            else DeviceKVTransfer())
        # hardened handoff transport: deadline + bounded retries +
        # straggler hedging around ship/validate/install
        self.transport = (transport if transport is not None
                          else TransportPolicy())
        self._clock = clock if clock is not None else time.monotonic
        # graceful degradation: one shared controller for the fleet —
        # the router claims it (owner) and polls it once per step from
        # the gauge sweep; replica engines consult its effect queries
        # but never advance its hysteresis clocks
        self.degrade = degrade
        if degrade is not None:
            degrade.owner = self
            for r in self.replicas:
                if r.engine.degrade is None:
                    r.engine.degrade = degrade
        # per-tenant SLO tracker + cost ledger: same owner
        # protocol as the ladder — the router claims the tracker and
        # polls it once per step so N replicas don't multiply the
        # alerting cadence; engines still charge their own ticks
        self.slo = slo
        if slo is not None:
            slo.owner = self
            for r in self.replicas:
                if r.engine.slo is None:
                    r.engine.slo = slo
        # session durability: periodic host-side snapshots every N
        # steps. None/0 = OFF — the legacy contract (a request's second
        # replica death fails it) stays the default
        self.snapshot_every = snapshot_every
        self.max_session_restores = max_session_restores
        self._snapshots: dict[int, object] = {}   # rid -> SessionSnapshot
        self._restores: dict[int, int] = {}       # rid -> restore count
        self._step_i = 0
        self.max_queue_len = max_queue_len
        self._queue: deque[Request] = deque()     # awaiting dispatch
        self.requests: dict[int, Request] = {}    # every request ever seen
        self._where: dict[int, int] = {}          # rid -> replica index
        self._sessions: dict[tuple, int] = {}     # (stage, sid) -> index
        self._pending: list = []                  # KVPayloads to install
        self._requeued: set[int] = set()          # death-requeue, ONCE each
        self._ids = itertools.count()
        self.stats = {"dispatched": 0, "requeues": 0, "transfers": 0,
                      "deaths": 0, "rejected": 0, "hedges": 0}
        if install_imbalance_rule:
            # stock rule on the process-global evaluator: flags one
            # replica hoarding outstanding requests (LOR should keep the
            # spread near 0; a big spread means gating/affinity gone bad)
            HEALTH.rule(
                "router_replica_imbalance",
                gauge_imbalance("router_replica_outstanding"),
                warn=2.0, crit=8.0,
                description="(max-min)/mean outstanding requests across "
                            "replicas — sustained spread means dispatch "
                            "is not balancing")

    # ------------------------------------------------------------- intake
    def add_request(self, req: Request) -> int:
        """Accept a request and dispatch it immediately when a healthy
        replica can take it (the common path); otherwise it waits in the
        router queue for the next ``step``."""
        if not any(r.alive and not r.draining for r in self.replicas):
            self.stats["rejected"] += 1
            raise EngineDrainingError(
                "no live replica is accepting work (all dead or draining)")
        if (self.max_queue_len is not None
                and len(self._queue) >= self.max_queue_len):
            self.stats["rejected"] += 1
            raise QueueFullError(
                f"router queue full ({self.max_queue_len} waiting) — "
                "shed load or retry later")
        # ladder L4: explicit backpressure on NEW sessions — in-flight
        # work keeps running and finishes; only intake is refused
        if (self.degrade is not None
                and not self.degrade.accepting_sessions()):
            self.stats["rejected"] += 1
            _REJECTED.inc(reason="degraded")
            if req.tenant_id is not None:
                _TENANT_REJECTED.inc(tenant=tenant_label(req.tenant_id))
            raise OverloadError(
                "degradation ladder at L4 — new sessions rejected, "
                "retry after the cluster recovers")
        if req.req_id is None:
            req.req_id = next(self._ids)
        else:
            if req.req_id in self.requests:
                raise ValueError(f"req_id {req.req_id} already exists")
            self._ids = itertools.count(
                max(req.req_id + 1, next(self._ids)))
        self.requests[req.req_id] = req
        # the router's intake gate is THE session gate for the fleet —
        # replica engines skip theirs for router-owned work, so L4
        # never re-rejects an accepted request mid-dispatch or requeue
        req._preadmitted = True
        REQUESTS.submit(req, source="router")
        self._queue.append(req)
        self._flush_queue()
        return req.req_id

    def generate(self, prompt, **kw) -> int:
        return self.add_request(Request(prompt, **kw))

    def _forget(self, rid: int):
        """Drop all per-request router state once a request is done."""
        self._where.pop(rid, None)
        self._snapshots.pop(rid, None)
        self._restores.pop(rid, None)

    def pop_finished(self) -> dict:
        done = {rid: r for rid, r in self.requests.items() if r.done}
        for rid in done:
            del self.requests[rid]
            self._requeued.discard(rid)
            self._forget(rid)
        return done

    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._pending)
                or any(r.alive and r.engine.has_work()
                       for r in self.replicas))

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Cancel wherever the request lives: router queue, in-flight
        KV handoff, or a replica engine."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return False
        for i, q in enumerate(self._queue):
            if q.req_id == rid:
                del self._queue[i]
                req.done = True
                req.finish_reason = reason
                self._forget(rid)
                REQUESTS.finish(req, reason)
                return True
        for j, p in enumerate(self._pending):
            if p.req.req_id == rid:
                del self._pending[j]
                req.done = True
                req.finish_reason = reason
                self._forget(rid)
                REQUESTS.finish(req, reason)
                return True
        i = self._where.get(rid)
        if i is not None:
            out = self.replicas[i].engine.cancel(rid, reason)
            if out:
                self._forget(rid)
            return out
        return False

    # ----------------------------------------------------------- dispatch
    def _candidates(self, req: Request) -> list:
        """Replica indices eligible for this request's ADMISSION: alive,
        not draining, verdict below CRIT, role-compatible. Disaggregated:
        admission goes to prefill-role replicas — except beam requests,
        which cannot be extracted mid-flight and therefore run end-to-end
        on a decode-capable replica."""
        if self.disagg:
            roles = (("both", "decode") if req.num_beams > 1
                     else ("prefill", "both"))
        else:
            roles = ("both",)
        return [i for i, r in enumerate(self.replicas)
                if r.role in roles and r.alive and not r.draining
                and r.verdict() != "CRIT"]

    def _pick(self, req: Request, cands: list) -> int:
        if self.affinity and req.session_id is not None:
            pinned = self._sessions.get(("admit", req.session_id))
            if pinned in cands:
                return pinned
        # least outstanding requests; index breaks ties deterministically
        return min(cands, key=lambda i:
                   (self.replicas[i].engine.outstanding(), i))

    def _dispatch(self, req: Request) -> bool:
        """Hand one request to a replica. Returns False when it must stay
        with the router (no candidate, per-engine backpressure from every
        candidate, or an injected dispatch fault)."""
        cands = self._candidates(req)
        while cands:
            i = self._pick(req, cands)
            rep = self.replicas[i]
            try:
                # chaos fires BEFORE the engine sees the request, so an
                # injected exception leaves both sides untouched — the
                # request simply stays queued with the router
                fault_point("router.dispatch", router=self,
                            rid=req.req_id, replica=rep.name)
                with _span("router.dispatch", replica=rep.name,
                           rid=req.req_id):
                    rep.engine.add_request(req)
            except (QueueFullError, EngineDrainingError):
                cands.remove(i)          # replica-local backpressure:
                continue                 # try the next-least-loaded one
            except Exception as e:
                self.stats["requeues"] += 1
                _R_REQUEUES.inc(replica=rep.name, why="dispatch_fault")
                FLIGHT.record("router.requeue", rid=req.req_id,
                              replica=rep.name, why="dispatch_fault",
                              error=f"{type(e).__name__}: {e}")
                REQUESTS.event(req, "requeued", replica=rep.name,
                               why="dispatch_fault")
                return False
            self._where[req.req_id] = i
            if self.affinity and req.session_id is not None:
                self._sessions[("admit", req.session_id)] = i
            self.stats["dispatched"] += 1
            _R_DISPATCH.inc(replica=rep.name)
            REQUESTS.event(req, "dispatched", replica=rep.name)
            return True
        return False

    def _flush_queue(self):
        """FCFS: dispatch from the head until a request can't go
        anywhere (it stays at the head — no starvation, no reordering
        of a session's requests)."""
        while self._queue:
            req = self._queue[0]
            if req.done:                 # cancelled while waiting
                self._queue.popleft()
                continue
            self._queue.popleft()
            if not self._dispatch(req):
                self._queue.appendleft(req)
                break

    # ----------------------------------------------- disaggregated handoff
    def _collect_prefilled(self):
        """Extract every sequence a prefill-role replica has finished
        prefilling (its slot is ACTIVE, first token emitted, but the
        engine will never decode it). The ``router.kv_transfer`` chaos
        site fires before extraction: an injected failure pulls the
        request back to the router queue — re-prefilled elsewhere from
        its resume form, so greedy output is unchanged and no blocks
        leak on either replica."""
        for rep in self.replicas:
            if rep.role != "prefill" or not rep.alive:
                continue
            eng = rep.engine
            for slot in np.nonzero(eng.active & ~eng.is_beam)[0]:
                rid = int(eng.slot_req[slot])
                req = eng.requests.get(rid)
                if req is None or req.done:
                    continue
                try:
                    fault_point("router.kv_transfer", router=self,
                                rid=rid, replica=rep.name)
                    with _span("router.kv_transfer", rid=rid,
                               src=rep.name):
                        payload = eng.extract_sequence(rid)
                except (ValueError, NotImplementedError):
                    raise                # real extraction bug: surface it
                except Exception as e:
                    pulled = eng.release_request(rid)
                    if pulled is not None:
                        if pulled.tokens:
                            pulled._resume = np.concatenate(
                                [pulled.prompt,
                                 np.asarray(pulled.tokens, np.int32)])
                        self._queue.appendleft(pulled)
                        self._where.pop(rid, None)
                        self.stats["requeues"] += 1
                        _R_REQUEUES.inc(replica=rep.name, why="kv_transfer")
                        FLIGHT.record("router.requeue", rid=rid,
                                      replica=rep.name, why="kv_transfer",
                                      error=f"{type(e).__name__}: {e}")
                        REQUESTS.event(pulled, "requeued", replica=rep.name,
                                       why="kv_transfer")
                    continue
                self._pending.append(payload)
                self._where.pop(rid, None)

    def _deliver(self, payload, rep):
        """One validated delivery of ``payload`` to ``rep``: the
        ``router.kv_stall`` chaos window (straggler delay), ship, the
        ``router.kv_partial`` corruption window (a rule action returns
        a corrupted REPLACEMENT — the source payload stays pristine),
        then geometry+checksum validation. Failed attempts retry with
        bounded exponential backoff up to ``transport.max_attempts``.
        Returns the validated shipped payload, or None when every
        attempt failed (the payload stays pending; nothing was
        installed)."""
        rid = payload.req.req_id
        for attempt in range(self.transport.max_attempts):
            if attempt:
                self.transport.sleep(self.transport.backoff_s(attempt - 1))
            try:
                fault_point("router.kv_stall", router=self, rid=rid,
                            replica=rep.name, attempt=attempt)
                shipped = self.kv_transfer.ship(payload, rep.engine)
                alt = fault_point("router.kv_partial", router=self,
                                  rid=rid, replica=rep.name,
                                  attempt=attempt, payload=shipped)
                if alt is not None:
                    shipped = alt
                validate_payload(shipped, rep.engine)
                return shipped
            except EngineDrainingError:
                raise
            except Exception as e:
                why = ("partial" if isinstance(e, KVTransferError)
                       else "error")
                _R_TRANSFER_RETRIES.inc(replica=rep.name, why=why)
                FLIGHT.record("router.kv_retry", rid=rid,
                              replica=rep.name, attempt=attempt, why=why,
                              error=f"{type(e).__name__}: {e}")
        return None

    def _installed(self, payload, i: int):
        """Common bookkeeping once a payload's install succeeded."""
        req = payload.req
        rep = self.replicas[i]
        self._where[req.req_id] = i
        if self.affinity and req.session_id is not None:
            self._sessions[("decode", req.session_id)] = i
        self.stats["transfers"] += 1
        _R_TRANSFERS.inc()
        _R_TRANSFER_BLOCKS.inc(payload.n_blocks)
        REQUESTS.event(req, "kv_ship", replica=rep.name,
                       blocks=payload.n_blocks)

    def _hedge(self, payload, slow_i: int, others: list,
               elapsed: float, deadline: float) -> bool:
        """Straggler hedging: the primary delivery blew its deadline,
        so re-dispatch the handoff to the next-least-loaded decode
        replica. First copy to INSTALL wins; returns True when the
        hedge won — the slow primary copy is then dropped without ever
        being installed (the exactly-once loser cancellation: no slot,
        no blocks, no second registration). Returns False to fall back
        to the late primary copy."""
        req = payload.req
        j = min(others, key=lambda x:
                (self.replicas[x].engine.outstanding(), x))
        hrep = self.replicas[j]
        self.stats["hedges"] += 1
        _R_HEDGES.inc()
        FLIGHT.record("router.kv_hedge", rid=req.req_id,
                      slow=self.replicas[slow_i].name, hedge=hrep.name,
                      elapsed_s=round(elapsed, 6),
                      deadline_s=round(deadline, 6))
        t0 = self._clock()
        try:
            shipped = self._deliver(payload, hrep)
            if shipped is None or not hrep.engine.install_sequence(shipped):
                return False
        except EngineDrainingError:
            return False
        _R_TRANSFER_SECONDS.observe(self._clock() - t0)
        FLIGHT.record("router.kv_hedge_win", rid=req.req_id,
                      replica=hrep.name)
        REQUESTS.event(req, "kv_hedged", replica=hrep.name)
        self._installed(payload, j)
        return True

    def _flush_pending(self):
        """Install extracted sequences into decode-capable replicas (LOR
        with decode-stage affinity) through the hardened transport:
        per-attempt validation + bounded retries (:meth:`_deliver`),
        and straggler hedging when the primary delivery exceeds the
        policy deadline (p95-derived by default). A payload that fits
        nowhere right now simply waits — slots/blocks free up as
        decodes finish."""
        still = []
        for payload in self._pending:
            req = payload.req
            cands = [i for i, r in enumerate(self.replicas)
                     if r.role in ("both", "decode") and r.alive
                     and not r.draining and r.verdict() != "CRIT"]
            if self.affinity and req.session_id is not None:
                pinned = self._sessions.get(("decode", req.session_id))
                if pinned in cands:
                    cands = [pinned]
            if not cands:
                still.append(payload)
                continue
            i = min(cands, key=lambda j:
                    (self.replicas[j].engine.outstanding(), j))
            rep = self.replicas[i]
            deadline = self.transport.deadline(_R_TRANSFER_SECONDS)
            t0 = self._clock()
            try:
                with _span("router.kv_transfer", rid=req.req_id,
                           dst=rep.name):
                    shipped = self._deliver(payload, rep)
            except EngineDrainingError:
                still.append(payload)
                continue
            elapsed = self._clock() - t0
            if shipped is None:
                still.append(payload)    # retries exhausted this step
                continue
            if (self.transport.hedge and deadline is not None
                    and elapsed > deadline):
                others = [j for j in cands if j != i]
                if others and self._hedge(payload, i, others,
                                          elapsed, deadline):
                    continue             # hedge won; slow copy dropped
            try:
                ok = rep.engine.install_sequence(shipped)
            except EngineDrainingError:
                still.append(payload)
                continue
            if not ok:
                still.append(payload)    # no slot/blocks free yet
                continue
            _R_TRANSFER_SECONDS.observe(elapsed)
            self._installed(payload, i)
        self._pending = still

    # ------------------------------------------------------ death/drain
    def _replica_death(self, i: int, exc: Exception):
        """Declare replica ``i`` dead: harvest what it finished, pull
        every live request back, and requeue each to a healthy replica
        EXACTLY ONCE — a request whose second replica also dies finishes
        with ``finish_reason="replica_death"`` instead of bouncing
        forever."""
        rep = self.replicas[i]
        rep.alive = False
        self.stats["deaths"] += 1
        _R_DEATHS.inc()
        FLIGHT.record("router.replica_death", replica=rep.name,
                      error=f"{type(exc).__name__}: {exc}")
        eng = rep.engine
        for rid, r in eng.pop_finished().items():
            self._forget(rid)                # finished work is still good
        for rid in list(eng.requests):
            req = eng.release_request(rid)
            self._where.pop(rid, None)
            if req is None:
                continue
            if rid in self._requeued:
                snap = self._snapshots.get(rid)
                restores = self._restores.get(rid, 0)
                if (snap is not None
                        and restores < self.max_session_restores):
                    # session durability: the exactly-once
                    # requeue is spent, but a snapshot outlives the
                    # replica — restore instead of failing. Tokens roll
                    # back to the capture point; the resume prefill
                    # replays them through the radix cache (waste billed
                    # as replay_prefill), so greedy output still matches
                    # an undisturbed run.
                    self._restores[rid] = restores + 1
                    req.tokens = list(snap.tokens)
                    req._resume = (snap.resume_ids() if snap.tokens
                                   else None)
                    req._match_memo = None
                    self._queue.appendleft(req)
                    self.stats["requeues"] += 1
                    _R_RESTORES.inc()
                    _R_REQUEUES.inc(replica=rep.name,
                                    why="session_restore")
                    FLIGHT.record("router.session_restore", rid=rid,
                                  replica=rep.name,
                                  tokens=len(snap.tokens))
                    REQUESTS.event(req, "restored", replica=rep.name,
                                   tokens=len(snap.tokens))
                    continue
                req.done = True
                req.finish_reason = "replica_death"
                if req.tenant_id is not None:
                    _TENANT_FINISHED.inc(
                        tenant=tenant_label(req.tenant_id),
                        reason="replica_death")
                self._forget(rid)
                FLIGHT.record("router.requeue_exhausted", rid=rid)
                REQUESTS.finish(req, "replica_death", replica=rep.name)
                continue
            self._requeued.add(rid)
            if req.tokens:
                # resume form: the next replica re-prefills prompt +
                # generated-so-far, continuing bit-exactly under greedy
                req._resume = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
            self._queue.appendleft(req)
            self.stats["requeues"] += 1
            _R_REQUEUES.inc(replica=rep.name, why="replica_death")
            FLIGHT.record("router.requeue", rid=rid, replica=rep.name,
                          why="replica_death")
            REQUESTS.event(req, "requeued", replica=rep.name,
                           why="replica_death")
        # affinity pins to a dead replica are meaningless — unpin so the
        # session's future requests pick a live one
        self._sessions = {k: v for k, v in self._sessions.items()
                          if v != i}

    def drain_replica(self, name: str, cancel_queued: bool = False):
        """Gracefully remove one replica from rotation: REQUEUE its
        waiting requests to the rest of the fleet first, THEN drain its
        in-flight work. Ordering is the deadlock fix — draining first
        would run the engine until idle while the router still holds
        affinity-pinned work for it (work that can never run: a draining
        replica is excluded from dispatch)."""
        idx = [i for i, r in enumerate(self.replicas) if r.name == name]
        if not idx:
            raise ValueError(f"no replica named {name!r}")
        i = idx[0]
        rep = self.replicas[i]
        rep.draining = True
        # unpin BEFORE requeue/drain so rebalanced + future session
        # requests choose among the remaining replicas
        self._sessions = {k: v for k, v in self._sessions.items()
                          if v != i}
        eng = rep.engine
        for q in list(eng.queue):            # waiting for admission there
            req = eng.release_request(q.req_id)
            if req is not None:
                self._where.pop(req.req_id, None)
                self._queue.append(req)
                self.stats["requeues"] += 1
                _R_REQUEUES.inc(replica=rep.name, why="drain")
                FLIGHT.record("router.requeue", rid=req.req_id,
                              replica=rep.name, why="drain")
                REQUESTS.event(req, "requeued", replica=rep.name,
                               why="drain")
        if rep.role == "prefill":
            # a prefill-only engine never finishes active slots by
            # itself — drive the extract/install loop until it empties
            # instead of engine.drain()'s spin-forever
            eng._draining = True
            while eng.has_work():
                eng.step()
                self._collect_prefilled()
                self._flush_pending()
        else:
            eng.drain(cancel_queued=cancel_queued)
        for rid in eng.pop_finished():
            self._forget(rid)
        self._flush_queue()

    # ------------------------------------------------------------ stepping
    def step(self):
        """One router round: death checks, dispatch, one engine tick per
        live replica with work, then (disaggregated) the extract/install
        handoff. Returns the concatenated [(req_id, token), ...]."""
        for i, rep in enumerate(self.replicas):
            if not rep.alive:
                continue
            try:
                fault_point("router.replica_death", router=self,
                            replica=rep.name)
            except Exception as e:
                self._replica_death(i, e)
        self._flush_queue()
        emitted = []
        for rep in self.replicas:
            if rep.alive and rep.engine.has_work():
                emitted += rep.engine.step()
        if self.disagg:
            self._collect_prefilled()
            self._flush_pending()
        # session durability: capture AFTER the engine ticks, so each
        # snapshot carries this step's freshly generated tokens
        if self.snapshot_every:
            self._step_i += 1
            if self._step_i % self.snapshot_every == 0:
                self._snapshot_sessions()
        for rep in self.replicas:
            if rep.alive:
                for rid in rep.engine.pop_finished():
                    self._forget(rid)
        self._refresh_gauges()
        return emitted

    def _snapshot_sessions(self):
        """Refresh the per-request durability snapshots for everything
        in flight on a live replica. A failed capture (the
        ``serving.snapshot`` chaos site) keeps the previous, staler
        snapshot — restore then just replays a longer tail."""
        for rid, i in list(self._where.items()):
            rep = self.replicas[i]
            if not rep.alive:
                continue
            try:
                snap = rep.engine.snapshot_session(rid)
            except Exception as e:
                FLIGHT.record("serving.snapshot_skipped", rid=rid,
                              replica=rep.name,
                              error=f"{type(e).__name__}: {e}")
                continue
            if snap is not None:
                self._snapshots[rid] = snap

    def _progress_key(self):
        toks = sum(len(r.tokens) for r in self.requests.values())
        done = sum(1 for r in self.requests.values() if r.done)
        pre = sum(c for rep in self.replicas
                  for (_, c) in rep.engine.prefilling.values())
        beams = sum(g.i for rep in self.replicas
                    for g in rep.engine.groups.values())
        return (toks, done, pre, beams, len(self._queue),
                len(self._pending))

    def run(self, parallel: bool = False) -> dict:
        """Drain everything; returns {req_id: token list}. ``parallel``
        free-runs one thread per replica (pure replicated
        scale-out — the throughput mode); disaggregation needs the
        orchestrated sequential rounds and ignores the flag."""
        if parallel and not self.disagg:
            self._run_parallel()
        stall = 0
        last = self._progress_key()
        while self.has_work():
            self.step()
            key = self._progress_key()
            stall = stall + 1 if key == last else 0
            last = key
            if stall > 200:
                raise RuntimeError(
                    "router stalled: work remains but no replica can "
                    f"make progress (queue={len(self._queue)}, "
                    f"pending={len(self._pending)})")
        return {rid: r.tokens for rid, r in self.requests.items()}

    def _run_parallel(self):
        """Throughput mode: dispatch everything, then let each replica's
        engine free-run on its own thread — one thread's host work
        overlaps the other replicas' device work. On the card every
        replica's tick graphs were captured when its engine was built
        (under ``core.device.CAPTURE_LOCK``), so no capture runs while
        the threads launch; the threads share the device's default
        stream. Threads are joined before returning (nothing outlives
        the call)."""
        self._flush_queue()
        reps = [r for r in self.replicas if r.alive and r.engine.has_work()]
        if len(reps) < 2:
            return
        errs = []

        def drive(rep):
            try:
                while rep.engine.has_work():
                    rep.engine.step()
            except Exception as e:       # pragma: no cover - surfaced below
                errs.append((rep.name, e))

        threads = [threading.Thread(target=drive, args=(r,),
                                    name=f"pt-router-{r.name}", daemon=True)
                   for r in reps]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            name, e = errs[0]
            raise RuntimeError(f"replica {name} failed: {e}") from e

    def drain(self, cancel_queued: bool = False) -> dict:
        """Fleet-wide graceful shutdown: stop admitting, finish (or
        cancel) everything, return {req_id: tokens}."""
        for rep in self.replicas:
            rep.draining = True
            rep.engine._draining = True
        if cancel_queued:
            for req in list(self._queue):
                self.cancel(req.req_id)
            for rep in self.replicas:
                if rep.alive:
                    for q in list(rep.engine.queue):
                        rep.engine.cancel(q.req_id)
        # draining replicas still FINISH in-flight work; the sequential
        # loop also flushes disaggregated handoffs
        stall = 0
        last = self._progress_key()
        while self.has_work():
            emitted = self._drain_step()
            key = self._progress_key()
            stall = stall + 1 if key == last and not emitted else 0
            last = key
            if stall > 200:
                raise RuntimeError("router drain stalled")
        return {rid: r.tokens for rid, r in self.requests.items()}

    def _drain_step(self):
        emitted = []
        for rep in self.replicas:
            if rep.alive and rep.engine.has_work():
                emitted += rep.engine.step()
        if self.disagg:
            self._collect_prefilled()
            self._flush_pending()
        self._refresh_gauges()
        return emitted

    def assert_quiescent(self):
        """Fleet-wide leak check: the router holds nothing, and every
        replica's pool (dead ones included — their blocks were pulled
        back on death) is fully free."""
        assert not self._queue, f"router queue not empty: {len(self._queue)}"
        assert not self._pending, (
            f"undelivered KV payloads: {len(self._pending)}")
        for rep in self.replicas:
            rep.engine.kv.assert_quiescent()

    def _refresh_gauges(self):
        for rep in self.replicas:
            _R_OUTSTANDING.set(
                rep.engine.outstanding() if rep.alive else 0,
                replica=rep.name)
            _R_HEALTH.set(_VERDICT_NUM[rep.verdict()], replica=rep.name)
        tr, hd = self.stats["transfers"], self.stats["hedges"]
        _R_HEDGE_RATE.set(hd / tr if tr else 0.0)
        if self.degrade is not None:
            self.degrade.poll()
        if self.slo is not None:
            self.slo.poll()
