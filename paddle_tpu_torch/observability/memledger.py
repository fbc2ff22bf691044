"""Per-pool KV MEMORY ledger: every physical block
classified into exactly one state, reconciled against the block manager
by construction.

The serving stack measures time (tick anatomy), tokens (goodput ledger)
and the FLOPs/bytes roofline — this module measures *where the memory
is*. Each :class:`~paddle_tpu_torch.models.paged.BlockManager` owns one
:class:`MemLedger`; the manager's own mutation choke points
(``allocate``/``free``/``free_prefix``/``adopt_prefix``/``_evict_one``/
``take_copy_plan``) notify it
with primitive transitions (``table_enter``/``table_exit``/``park``/
``unpark``/``pin``/``unpin``), so every call path — engine admission,
beam forks, radix adoption, preemption, KV extract/install — is covered
without any engine-side bookkeeping. The ledger folds the transitions
into five mutually-exclusive states:

    active        block referenced by at least one live block table
    parked        radix/prefix-cache resident, rc == 0, matchable
    cow_pending   adopted COW source pinned until the fused copy drains
    reserved      promised by the reservation ledger but not yet held
                  (carved out of free first, then parked — a promise
                  can only be kept by reclaimable blocks)
    free          none of the above

with ``sum(states) == num_blocks`` an identity, not an aspiration:
:meth:`MemLedger.reconcile` independently re-walks the manager's
``tables``/``_pending``/``_parked``/``_free`` and must agree
block-for-block — the chaos suites assert it after every tick (the same
design as the goodput↔token-counter reconciliation).

On top of the ledger: ``serving_kv_blocks{state}`` / occupancy /
fragmentation / bytes-per-token gauges, Chrome-trace counter events
(``"ph": "C"`` — Perfetto renders pool occupancy-by-state over time
next to the tick spans), per-request peak-block attribution
(:meth:`take_peak` → ``req.trace_summary["kv_peak_blocks"]``),
admission-stall forensics (:meth:`record_stall` →
``serving_kv_stall_total{blocked_on}``), and the ``GET /memory`` httpd
document (:func:`memory_doc`) + flight-dump excerpt
(:func:`flight_excerpt`) over a weak registry of live pools.

``PT_MEM_LEDGER=0`` (checked at construction, per pool — the
RequestTracker pattern) turns every hook into one boolean read and
restores bit-identical serving behavior.
"""
from __future__ import annotations

import itertools
import os
import threading
import weakref
from collections import Counter, OrderedDict

from paddle_tpu_torch.observability.metrics import METRICS
from paddle_tpu_torch.observability.tracing import TRACER

__all__ = ["MemLedger", "pools", "memory_doc", "flight_excerpt"]

_KV_STATE = METRICS.gauge(
    "serving_kv_blocks",
    "physical KV-pool blocks by ledger state (active / parked / "
    "cow_pending / reserved / free); the five states sum to the pool "
    "size by construction", labelnames=("state",))
_KV_POOL = METRICS.gauge(
    "serving_kv_pool_blocks",
    "total physical blocks in the serving KV pool (the ledger's "
    "denominator)")
_KV_OCC = METRICS.gauge(
    "serving_kv_occupancy",
    "fraction of pool blocks holding resident KV (active + parked + "
    "cow_pending) / pool size")
_KV_FRAG = METRICS.gauge(
    "serving_kv_fragmentation",
    "window-recycling holes / (holes + live table entries): the share "
    "of block-table positions that are None placeholders")
_KV_PARKED_RATIO = METRICS.gauge(
    "serving_kv_parked_ratio",
    "radix/prefix-cache parked blocks / pool size (reclaimable cache "
    "residency)")
_KV_BPT = METRICS.gauge(
    "serving_kv_bytes_per_token",
    "HBM bytes held by active KV blocks per resident token (block-"
    "rounding overhead included) — the baseline quantized KV benches "
    "against")
_KV_STALL = METRICS.counter(
    "serving_kv_stall_total",
    "admissions blocked at the headroom gate, by which ledger state "
    "holds the missing blocks (active / reserved / cow_pending / "
    "slots / capacity)", labelnames=("blocked_on",))

# the card's allocator, refreshed by device_memory_stats (the /memory
# document, the metrics shipper); the names are the reference's
_DEV_MEM = METRICS.gauge(
    "device_bytes_in_use", "per-device bytes in use (0 when the backend "
    "does not report memory stats)", labelnames=("device",))
_DEV_MEM_PEAK = METRICS.gauge(
    "device_bytes_peak", "per-device peak bytes in use (0 when the "
    "backend does not report memory stats)", labelnames=("device",))
_DEV_MEM_LIMIT = METRICS.gauge(
    "device_bytes_limit", "per-device memory capacity visible to the "
    "allocator (0 when the backend does not report it)",
    labelnames=("device",))

# every live ledger, for /memory and flight-dump excerpts; weak so an
# engine's pool dies with the engine
_LEDGERS: "weakref.WeakSet[MemLedger]" = weakref.WeakSet()
_SEQ = itertools.count(1)

# per-request peak attribution survives table_drop (preemption must not
# reset a lifetime max) but beam groups mint fresh sids every tick, so
# the peak map is LRU-bounded instead of dropped at free
_PEAK_CAP = 4096


class MemLedger:
    """Per-pool block-state ledger. Hooks are called by the block
    manager's own mutation choke points; every hook is gated on one
    enabled-bool read (``PT_MEM_LEDGER=0`` → no-op)."""

    STATES = ("active", "parked", "cow_pending", "reserved", "free")

    def __init__(self, num_blocks: int, block_size: int,
                 enabled: bool = None):
        if enabled is None:
            enabled = os.environ.get("PT_MEM_LEDGER", "1") != "0"
        self._enabled = bool(enabled)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._seq_no = next(_SEQ)
        self._lock = threading.Lock()
        self._table_refs: dict[int, int] = {}   # blk -> live table entries
        self._pin_refs: dict[int, int] = {}     # blk -> pending-COW src pins
        self._parked: set[int] = set()
        self._reserved = 0                      # mirror of KVManager.reserved
        self._req_live: dict = {}               # seq_id -> live table entries
        self._req_holes: dict = {}              # seq_id -> None placeholders
        self._req_peak: OrderedDict = OrderedDict()   # seq_id -> peak live
        self._live_total = 0                    # Σ live entries (all tables)
        self._holes_total = 0                   # Σ holes (all tables)
        self.stall_counts: dict[str, int] = {}  # blocked_on -> stalls
        self.peak_states = dict.fromkeys(self.STATES, 0)   # per-publish max
        self.bytes_per_token = 0.0
        self.peak_bytes_per_token = 0.0
        _LEDGERS.add(self)

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -------------------------------------------------- manager hooks
    # (each is one bool read when disabled — the kill-switch contract)
    def table_enter(self, seq_id, blk: int):
        """A block became (one more) live entry of ``seq_id``'s table."""
        if not self._enabled:
            return
        with self._lock:
            self._table_refs[blk] = self._table_refs.get(blk, 0) + 1
            self._live_total += 1
            live = self._req_live.get(seq_id, 0) + 1
            self._req_live[seq_id] = live
            if live > self._req_peak.get(seq_id, 0):
                self._req_peak[seq_id] = live
            self._req_peak.move_to_end(seq_id)
            while len(self._req_peak) > _PEAK_CAP:
                self._req_peak.popitem(last=False)

    def table_exit(self, seq_id, blk: int, hole: bool = False):
        """A table entry left ``seq_id``'s table; ``hole=True`` when the
        position stays behind as a None placeholder (window recycling)."""
        if not self._enabled:
            return
        with self._lock:
            n = self._table_refs.get(blk, 0) - 1
            if n > 0:
                self._table_refs[blk] = n
            else:
                self._table_refs.pop(blk, None)
            self._live_total -= 1
            self._req_live[seq_id] = self._req_live.get(seq_id, 1) - 1
            if hole:
                self._holes_total += 1
                self._req_holes[seq_id] = self._req_holes.get(seq_id, 0) + 1

    def table_drop(self, seq_id):
        """``seq_id``'s table is gone — retire its holes and live count
        (the peak survives: preemption/replay must not reset it)."""
        if not self._enabled:
            return
        with self._lock:
            self._req_live.pop(seq_id, None)
            self._holes_total -= self._req_holes.pop(seq_id, 0)

    def park(self, blk: int):
        if not self._enabled:
            return
        with self._lock:
            self._parked.add(blk)

    def unpark(self, blk: int):
        if not self._enabled:
            return
        with self._lock:
            self._parked.discard(blk)

    def pin(self, blk: int):
        """A pending-COW order pinned ``blk`` as its copy source."""
        if not self._enabled:
            return
        with self._lock:
            self._pin_refs[blk] = self._pin_refs.get(blk, 0) + 1

    def unpin(self, blk: int):
        if not self._enabled:
            return
        with self._lock:
            n = self._pin_refs.get(blk, 0) - 1
            if n > 0:
                self._pin_refs[blk] = n
            else:
                self._pin_refs.pop(blk, None)

    def set_reserved(self, n: int):
        """Mirror of the KVManager reservation count (blocks promised to
        in-flight requests but not yet materialised as table entries)."""
        if not self._enabled:
            return
        self._reserved = max(0, int(n))

    # ---------------------------------------------------------- reads
    def _classify_locked(self) -> dict:
        """The five-state breakdown from the transition mirrors.
        Precedence: a tabled block is active even while pinned (the COW
        source may still be live in its writer's table); a pinned block
        is cow_pending even while parked-by-history. ``reserved`` is a
        COUNT, not identified blocks — carved out of free first, then
        parked (both are what an unheld promise would be kept with), so
        the five states always sum to num_blocks."""
        active = len(self._table_refs)
        pinned = sum(1 for b in self._pin_refs if b not in self._table_refs)
        parked = sum(1 for b in self._parked
                     if b not in self._table_refs
                     and b not in self._pin_refs)
        free_raw = self.num_blocks - active - pinned - parked
        resv = max(0, min(self._reserved, free_raw + parked))
        r_free = min(resv, free_raw)
        r_parked = resv - r_free
        return {"active": active, "parked": parked - r_parked,
                "cow_pending": pinned, "reserved": resv,
                "free": free_raw - r_free}

    def counts(self) -> dict:
        """Current {state: blocks}; zeros while disabled."""
        if not self._enabled:
            return dict.fromkeys(self.STATES, 0)
        with self._lock:
            return self._classify_locked()

    def fragmentation(self) -> float:
        """Holes / (holes + live table entries) — the share of table
        positions window recycling left as None placeholders."""
        if not self._enabled:
            return 0.0
        with self._lock:
            denom = self._holes_total + self._live_total
            return self._holes_total / denom if denom else 0.0

    def take_peak(self, seq_id) -> int:
        """Pop and return ``seq_id``'s lifetime peak live-block count
        (0 when unknown). Works while disabled so finish paths can
        always call it for cleanup."""
        with self._lock:
            return self._req_peak.pop(seq_id, 0)

    def describe(self) -> str:
        """One-line state breakdown for assertion messages."""
        if not self._enabled:
            return "disabled (PT_MEM_LEDGER=0)"
        c = self.counts()
        body = " ".join(f"{s}={c[s]}" for s in self.STATES)
        return f"{body} (of {self.num_blocks})"

    def snapshot(self) -> dict:
        """JSON-safe pool document (/memory, flight dumps)."""
        c = self.counts()
        with self._lock:
            holders = sorted(self._req_live.items(),
                             key=lambda kv: -kv[1])[:8]
            top = [{"seq_id": str(s), "live": n,
                    "peak": self._req_peak.get(s, n)} for s, n in holders]
            stalls = dict(self.stall_counts)
        return {"pool": self._seq_no, "enabled": self._enabled,
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "states": c, "reserved_promised": self._reserved,
                "fragmentation": round(self.fragmentation(), 6),
                "bytes_per_token": round(self.bytes_per_token, 3),
                "stalls": stalls, "top_holders": top}

    def flight_fields(self) -> dict:
        """kwargs for ``FLIGHT.record`` at alloc-failure/leak sites."""
        return {"states": self.counts(), "num_blocks": self.num_blocks,
                "reserved_promised": self._reserved,
                "fragmentation": round(self.fragmentation(), 6)}

    # ------------------------------------------------ stall forensics
    def record_stall(self, need: int, slots_short: bool = False):
        """An admission was blocked: attribute the missing blocks to the
        state holding them — the largest of active/reserved/cow_pending
        (parked and free blocks never block an admission: both count as
        free_blocks). ``slots_short`` marks a slot-limited (not block-
        limited) stall; an all-idle pool that is simply too small is
        ``capacity``."""
        if not self._enabled:
            return
        if slots_short:
            label = "slots"
        else:
            c = self.counts()
            holders = [(s, c[s]) for s in ("active", "reserved",
                                           "cow_pending")]
            label = (max(holders, key=lambda kv: kv[1])[0]
                     if any(v for _, v in holders) else "capacity")
        _KV_STALL.inc(blocked_on=label)
        with self._lock:
            self.stall_counts[label] = self.stall_counts.get(label, 0) + 1

    # --------------------------------------------------------- publish
    def publish(self, bytes_per_block: int = None,
                resident_tokens: int = None):
        """Fold the current breakdown into the gauges, the per-state
        peaks (bench columns), and a Chrome-trace counter event ("C") —
        Perfetto stacks the five series into an occupancy-by-state track
        next to the serving.step spans."""
        if not self._enabled:
            return
        c = self.counts()
        for s, v in c.items():
            _KV_STATE.set(v, state=s)
            if v > self.peak_states[s]:
                self.peak_states[s] = v
        _KV_POOL.set(self.num_blocks)
        _KV_OCC.set((c["active"] + c["parked"] + c["cow_pending"])
                    / max(self.num_blocks, 1))
        _KV_FRAG.set(self.fragmentation())
        _KV_PARKED_RATIO.set(c["parked"] / max(self.num_blocks, 1))
        if bytes_per_block:
            bpt = (c["active"] * bytes_per_block / resident_tokens
                   if resident_tokens else 0.0)
            _KV_BPT.set(bpt)
            self.bytes_per_token = bpt
            if bpt > self.peak_bytes_per_token:
                self.peak_bytes_per_token = bpt
        TRACER.counter("serving_kv_blocks",
                       **{s: float(v) for s, v in c.items()})

    # ------------------------------------------------- reconciliation
    def reconcile(self, mgr, reserved: int = None) -> dict:
        """Independently re-walk the block manager and diff it against
        the transition mirrors, block-for-block: table refs vs
        ``mgr.tables``, COW pins vs live ``mgr._pending`` orders, the
        parked set vs ``mgr._parked`` (radix) / ``mgr._evictable``
        (flat), and the raw free list vs the complement of all of the
        above. Then re-derive the five-state breakdown from the walk and
        require it to equal :meth:`counts` with ``sum == num_blocks``.
        Returns ``{"ok", "diffs", "counts", "walk"}``."""
        if not self._enabled:
            return {"ok": True, "skipped": True, "diffs": [],
                    "counts": self.counts(), "walk": None}
        diffs = []
        truth_tables: Counter = Counter()
        for t in mgr.tables.values():
            for b in t:
                if b is not None:
                    truth_tables[b] += 1
        truth_pins = Counter(e.src for e in getattr(mgr, "_pending", ())
                             if not e.dead)
        if hasattr(mgr, "_parked"):
            truth_parked = set(mgr._parked)
        elif hasattr(mgr, "_evictable"):
            truth_parked = set(mgr._evictable)
        else:
            truth_parked = set()
        with self._lock:
            led_tables = dict(self._table_refs)
            led_pins = dict(self._pin_refs)
            led_parked = set(self._parked)
            led_reserved = self._reserved
        for blk in sorted(set(truth_tables) | set(led_tables)):
            a, b = truth_tables.get(blk, 0), led_tables.get(blk, 0)
            if a != b:
                diffs.append(f"block {blk}: {a} table entries in the "
                             f"manager, {b} in the ledger")
        for blk in sorted(set(truth_pins) | set(led_pins)):
            a, b = truth_pins.get(blk, 0), led_pins.get(blk, 0)
            if a != b:
                diffs.append(f"block {blk}: {a} live COW pins in the "
                             f"manager, {b} in the ledger")
        for blk in sorted(truth_parked ^ led_parked):
            where = "manager" if blk in truth_parked else "ledger"
            diffs.append(f"block {blk}: parked only in the {where}")
        free = list(mgr._free)
        if len(free) != len(set(free)):
            diffs.append("free list contains duplicate blocks")
        expected_free = (set(range(self.num_blocks)) - set(truth_tables)
                         - set(truth_pins) - truth_parked)
        for blk in sorted(set(free) ^ expected_free):
            where = ("free list" if blk in set(free)
                     else "unaccounted (neither tabled, pinned, parked, "
                          "nor free)")
            diffs.append(f"block {blk}: {where}")
        if reserved is not None and led_reserved != max(0, reserved):
            diffs.append(f"reservation mirror: manager promises "
                         f"{reserved}, ledger mirrors {led_reserved}")
        # re-derive the published breakdown from the walk (same
        # precedence + reserved carve-out as _classify_locked)
        w_active = len(truth_tables)
        w_pinned = len(set(truth_pins) - set(truth_tables))
        w_parked = len(truth_parked - set(truth_tables) - set(truth_pins))
        w_free_raw = self.num_blocks - w_active - w_pinned - w_parked
        w_resv = max(0, min(led_reserved if reserved is None
                            else max(0, reserved),
                            w_free_raw + w_parked))
        w_r_free = min(w_resv, w_free_raw)
        walk = {"active": w_active, "parked": w_parked - (w_resv - w_r_free),
                "cow_pending": w_pinned, "reserved": w_resv,
                "free": w_free_raw - w_r_free}
        counts = self.counts()
        if walk != counts:
            diffs.append(f"state breakdown: walk {walk} != ledger {counts}")
        if sum(counts.values()) != self.num_blocks:
            diffs.append(f"sum(states) = {sum(counts.values())} != "
                         f"num_blocks = {self.num_blocks}")
        return {"ok": not diffs, "diffs": diffs[:20], "counts": counts,
                "walk": walk}


# ------------------------------------------------------- pool registry
def pools() -> list:
    """Live ledgers, oldest pool first."""
    return sorted(_LEDGERS, key=lambda led: led._seq_no)


def device_memory_stats() -> dict:
    """Per-device memory of the CUDA caching allocator
    (``torch.cuda.memory_stats``), also pushed into the
    ``device_bytes_in_use`` / ``device_bytes_peak`` / ``device_bytes_limit``
    gauges. Without a card: one zeroed ``cpu`` placeholder, the backend
    named, never an empty dict. The queries hold
    ``core.device.CAPTURE_LOCK``, so they never land inside a CUDA graph
    capture of another thread."""
    import torch

    from paddle_tpu_torch.core.device import CAPTURE_LOCK
    out = {}
    if torch.cuda.is_available():
        with CAPTURE_LOCK:
            for i in range(torch.cuda.device_count()):
                st = torch.cuda.memory_stats(i)
                out[f"cuda:{i}"] = {
                    "backend": "cuda",
                    "name": torch.cuda.get_device_name(i),
                    "bytes_in_use": int(
                        st.get("allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(
                        st.get("allocated_bytes.all.peak", 0)),
                    "bytes_reserved": int(
                        st.get("reserved_bytes.all.current", 0)),
                    "bytes_limit": int(
                        torch.cuda.get_device_properties(i).total_memory)}
    else:
        out["cpu"] = {"backend": "cpu", "bytes_in_use": 0,
                      "peak_bytes_in_use": 0, "bytes_limit": 0}
    for dev, rec in out.items():
        _DEV_MEM.set(rec["bytes_in_use"], device=dev)
        _DEV_MEM_PEAK.set(rec["peak_bytes_in_use"], device=dev)
        _DEV_MEM_LIMIT.set(rec["bytes_limit"], device=dev)
    return out


def memory_doc() -> dict:
    """The ``GET /memory`` document: every live pool's snapshot plus
    per-device allocator stats (:func:`device_memory_stats`)."""
    return {"pools": [led.snapshot() for led in pools()],
            "device": device_memory_stats()}


def flight_excerpt() -> list:
    """What flight dumps embed on alloc failure / quiescence violation:
    the newest few pools' snapshots (dump paths must stay cheap)."""
    return [led.snapshot() for led in pools()[-4:]]
