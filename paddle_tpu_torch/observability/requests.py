"""A copy of ``paddle_tpu/observability/requests.py`` (it never imported
JAX). Request-scoped tracing: a bounded ring of
per-request lifecycle timelines across the serving cluster.

The metrics registry is aggregate and the tracer is thread-scoped, so
once the router fans one request over prefill and decode replicas
neither can answer "where did request 1234's latency go?". The
:class:`RequestTracker` records, per traced request, an ordered event
timeline — submitted → queued → dispatched{replica} → admitted →
prefill chunks → KV handoff (extract/ship/install) → decode ticks →
preempted/replayed → finished{reason} — stamped on the tracker's own
monotonic clock, plus cheap per-request counters for the per-token hot
path (sampled / spec-proposed / spec-committed tokens).

A trace id is minted at ``Router.add_request``/``LLMEngine.add_request``
the first time a request is submitted while tracking is enabled, and
rides the :class:`~paddle_tpu_torch.serving.types.Request` object itself —
through the scheduler, KV manager, executor, and the ``KVTransfer``
seam (a :class:`KVPayload` carries its ``req``) — so no serving API
changes shape. Hop events ("dispatched", "kv_install", "finished")
additionally emit Chrome-trace flow events through the global
:data:`~paddle_tpu_torch.observability.tracing.TRACER` keyed by the trace id
and pinned to per-replica named tracks, which is what stitches one
request's spans on different replicas into a single Perfetto arrow.

The global :data:`REQUESTS` starts DISABLED and disabled is a real
no-op path: every recording method returns after one bool read, no
trace ids are minted, and requests therefore carry ``trace_id=None``
so even call sites that don't pre-check ``REQUESTS.enabled`` fall
through immediately. The ring is bounded (oldest timeline evicted),
each timeline's event list is bounded (drops counted), and at finish a
JSON-safe summary (TTFT, queue wait, replicas visited, spec
acceptance, preemptions, TTFT breakdown) is computed once, attached to
``req.trace_summary``, and served verbatim by the ``/requests`` httpd
endpoint and the flight recorder's slowest/failed excerpt.

Import-light on purpose: stdlib + :mod:`tracing` only, so the flight
recorder can lazily embed excerpts without an import cycle.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict

from paddle_tpu_torch.observability.tracing import TRACER

__all__ = ["REQUESTS", "RequestTracker"]

_DEFAULT_CAPACITY = 256          # timelines kept before eviction
_DEFAULT_EVENT_CAP = 128         # events per timeline before drops

# finish reasons that are a normal end of life; anything else ("timeout",
# "cancelled", "replica_death", ...) counts as failed in excerpts
_OK_REASONS = frozenset({"eos", "length", "beam"})


class _Timeline:
    """One request's bounded event list + hot-path counters."""

    __slots__ = ("trace_id", "req_id", "t0", "events", "dropped_events",
                 "counters", "replicas", "flow_open", "await_decode",
                 "done", "summary")

    def __init__(self, trace_id: int, req_id, t0: float):
        self.trace_id = trace_id
        self.req_id = req_id
        self.t0 = t0
        self.events: list = []            # {"t": rel_s, "kind": ..., **fields}
        self.dropped_events = 0
        self.counters = {"tokens_sampled": 0, "spec_proposed": 0,
                         "spec_accepted": 0, "spec_committed": 0,
                         "preemptions": 0, "requeues": 0}
        self.replicas: list = []          # visit order, deduped
        self.flow_open = False            # first hop emits flow "s", rest "t"
        self.await_decode = False         # set at kv_install, cleared at
        self.done = False                 # the first post-handoff token
        self.summary = None

    def first(self, kind: str):
        """t of the first event of ``kind`` (None when absent)."""
        for ev in self.events:
            if ev["kind"] == kind:
                return ev["t"]
        return None


class RequestTracker:
    """Bounded ring of request timelines. Thread-safe; every mutator is
    gated on one enabled-bool read so the disabled tracker costs nothing
    on the per-token path."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 event_cap: int = _DEFAULT_EVENT_CAP):
        if capacity < 1:
            raise ValueError(f"tracker capacity must be >= 1, got {capacity}")
        self._capacity = capacity
        self.event_cap = event_cap
        self._lines: OrderedDict = OrderedDict()   # trace_id -> _Timeline
        self._lock = threading.Lock()
        self._enabled = False
        self._ids = itertools.count(1)
        self.evicted = 0

    # ------------------------------------------------------------ admin
    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def capacity(self) -> int:
        return self._capacity

    def set_capacity(self, capacity: int):
        """Resize the ring, evicting oldest timelines if shrinking."""
        if capacity < 1:
            raise ValueError(f"tracker capacity must be >= 1, got {capacity}")
        with self._lock:
            self._capacity = capacity
            while len(self._lines) > capacity:
                self._lines.popitem(last=False)
                self.evicted += 1

    def clear(self):
        with self._lock:
            self._lines.clear()
            self.evicted = 0

    def __len__(self):
        with self._lock:
            return len(self._lines)

    # -------------------------------------------------------- recording
    def submit(self, req, source: str = "engine"):
        """Mint a trace id for ``req`` (idempotent — a request the router
        already traced is not re-minted by the engine) and open its
        timeline. Returns the trace id, or None while disabled."""
        if not self._enabled:
            return None
        tid = getattr(req, "trace_id", None)
        if tid is not None and self._has(tid):
            return tid                     # already tracked (router → engine)
        if tid is None:
            tid = next(self._ids)
            req.trace_id = tid
        line = _Timeline(tid, getattr(req, "req_id", None),
                         time.monotonic())
        line.events.append({"t": 0.0, "kind": "submitted", "source": source,
                            "prompt_tokens": int(len(req.prompt))})
        with self._lock:
            self._lines[tid] = line
            while len(self._lines) > self._capacity:
                self._lines.popitem(last=False)
                self.evicted += 1
        return tid

    def _has(self, tid) -> bool:
        with self._lock:
            return tid in self._lines

    def _line(self, req):
        tid = getattr(req, "trace_id", None)
        if tid is None:
            return None
        with self._lock:
            return self._lines.get(tid)

    def event(self, req, kind: str, **fields):
        """Append one timeline event. Fields must be JSON-safe (call
        sites pass ints/strs). Hop kinds additionally emit TRACER flow
        events so replica crossings stitch in the Chrome trace."""
        if not self._enabled:
            return
        line = self._line(req)
        if line is None:
            return
        t = time.monotonic() - line.t0
        replica = fields.get("replica")
        with self._lock:
            if replica is not None and replica not in line.replicas:
                line.replicas.append(replica)
            if kind == "preempted":
                line.counters["preemptions"] += 1
            elif kind == "requeued":
                line.counters["requeues"] += 1
            elif kind == "kv_install":
                line.await_decode = True
            if len(line.events) >= self.event_cap:
                line.dropped_events += 1
                return
            line.events.append({"t": round(t, 6), "kind": kind, **fields})
        if kind in ("dispatched", "kv_install"):
            phase = "t" if line.flow_open else "s"
            line.flow_open = True
            TRACER.flow("request", line.trace_id, phase, track=replica,
                        rid=line.req_id, kind=kind, replica=replica)

    def tokens(self, req, n: int = 1, spec_committed: int = 0):
        """Per-token hot path: counter bumps only, no event append —
        except the one "decode_resume" marker after a KV handoff, which
        closes the TTFT handoff/first-decode breakdown."""
        if not self._enabled:
            return
        line = self._line(req)
        if line is None:
            return
        with self._lock:
            line.counters["tokens_sampled"] += n
            line.counters["spec_committed"] += spec_committed
            resume = line.await_decode
            line.await_decode = False
        if resume:
            self.event(req, "decode_resume")

    def spec(self, req, proposed: int, accepted: int):
        """Per-spec-commit counter bumps (no event append)."""
        if not self._enabled:
            return
        line = self._line(req)
        if line is None:
            return
        with self._lock:
            line.counters["spec_proposed"] += proposed
            line.counters["spec_accepted"] += accepted

    def finish(self, req, reason: str, replica: str = None):
        """Record the terminal event, compute the summary once, attach
        it to ``req.trace_summary``, and close the flow arrow."""
        if not self._enabled:
            return
        line = self._line(req)
        if line is None or line.done:
            return
        self.event(req, "finished", reason=str(reason), replica=replica)
        with self._lock:
            line.done = True
            line.summary = self._summarize(line, reason)
        req.trace_summary = line.summary
        if line.flow_open:
            TRACER.flow("request", line.trace_id, "f", track=replica,
                        rid=line.req_id, reason=str(reason))

    # ------------------------------------------------------- summaries
    @staticmethod
    def _summarize(line: _Timeline, reason) -> dict:
        """TTFT breakdown from first-occurrence event times: queue =
        submitted→admitted, prefill = admitted→first token, handoff =
        kv_extract→kv_install (0 colocated), first-decode = install→
        first post-handoff token (0 colocated)."""
        t_end = line.events[-1]["t"] if line.events else 0.0
        t_adm = line.first("admitted")
        t_tok = line.first("first_token")
        t_ext = line.first("kv_extract")
        t_ins = line.first("kv_install")
        t_res = line.first("decode_resume")

        def _delta(a, b):
            return round(max(0.0, b - a), 6) if (a is not None and
                                                 b is not None) else 0.0

        c = line.counters
        proposed = c["spec_proposed"]
        # peak KV blocks over the request's whole life — max over the
        # kv_peak events its finish paths stamped (preemption replays and
        # multi-replica hops each stamp one)
        peaks = [ev.get("blocks", 0) for ev in line.events
                 if ev["kind"] == "kv_peak"]
        return {
            "trace_id": line.trace_id,
            "req_id": line.req_id,
            "finish_reason": str(reason),
            "ok": str(reason) in _OK_REASONS,
            "tokens": c["tokens_sampled"],
            "total_s": round(t_end, 6),
            "queue_wait_s": _delta(0.0, t_adm),
            "ttft_s": _delta(0.0, t_tok),
            "breakdown": {
                "queue_s": _delta(0.0, t_adm),
                "prefill_s": _delta(t_adm, t_tok),
                "handoff_s": _delta(t_ext, t_ins),
                "first_decode_s": _delta(t_ins, t_res),
            },
            "kv_peak_blocks": max(peaks) if peaks else None,
            "replicas": list(line.replicas),
            "preemptions": c["preemptions"],
            "requeues": c["requeues"],
            "spec_proposed": proposed,
            "spec_accepted": c["spec_accepted"],
            "spec_acceptance": (round(c["spec_accepted"] / proposed, 6)
                                if proposed else None),
        }

    def _timeline_doc(self, line: _Timeline) -> dict:
        return {"trace_id": line.trace_id, "req_id": line.req_id,
                "done": line.done, "events": list(line.events),
                "dropped_events": line.dropped_events,
                "counters": dict(line.counters),
                "summary": line.summary}

    def timeline(self, trace_id) -> dict:
        """Full timeline doc for one trace id (None when evicted/unknown)."""
        with self._lock:
            line = self._lines.get(trace_id)
            return self._timeline_doc(line) if line is not None else None

    def summaries(self) -> list:
        """Summaries of finished timelines, oldest first."""
        with self._lock:
            return [line.summary for line in self._lines.values()
                    if line.summary is not None]

    def to_doc(self, timelines: int = 32) -> dict:
        """The ``/requests`` endpoint document: every tracked request's
        summary (or live progress) plus full timelines for the newest
        ``timelines`` of them."""
        with self._lock:
            lines = list(self._lines.values())
        reqs = []
        for line in lines:
            if line.summary is not None:
                reqs.append(line.summary)
            else:
                reqs.append({"trace_id": line.trace_id,
                             "req_id": line.req_id,
                             "finish_reason": None,
                             "tokens": line.counters["tokens_sampled"],
                             "replicas": list(line.replicas),
                             "events": len(line.events)})
        return {"enabled": self._enabled, "capacity": self._capacity,
                "tracked": len(lines), "evicted": self.evicted,
                "requests": reqs,
                "timelines": [self._timeline_doc(line)
                              for line in lines[-timelines:]]}

    def flight_excerpt(self, slowest: int = 3, failed: int = 5) -> dict:
        """What the flight recorder embeds in a dump: full timelines of
        the ``slowest`` finished requests (by total_s) and the newest
        ``failed`` ones (finish reason outside eos/length/beam)."""
        with self._lock:
            done = [line for line in self._lines.values()
                    if line.summary is not None]
        slow = sorted(done, key=lambda l: l.summary["total_s"],
                      reverse=True)[:slowest]
        bad = [line for line in done if not line.summary["ok"]][-failed:]
        return {"slowest": [self._timeline_doc(l) for l in slow],
                "failed": [self._timeline_doc(l) for l in bad]}


REQUESTS = RequestTracker()
