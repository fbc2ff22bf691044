"""A copy of ``paddle_tpu/observability/flight.py`` (it never imported
JAX). Flight recorder — a process-global, thread-safe bounded ring of
structured runtime events.

The metrics registry answers "how many" while the process is alive and
someone is polling ``/metrics``; the flight recorder answers "what were
the last N things that happened" AFTER the process is dead. Every
instrumented subsystem drops cheap structured events into the ring
(:meth:`FlightRecorder.record` is a lock + dict append):

    train.step          one per drained optimizer step (step, loss)
    train.nan_skip      a non-finite loss skipped the update
    train.nan_backoff   a backoff sleep was taken during a NaN streak
    train.giveup        the NaN streak hit max_bad_steps
    train.crash         fit() is about to re-raise — last event of a run
    fault               a chaos rule fired (site, hit)
    watchdog.trip       the stall watchdog gave up waiting for a poke
    elastic.restart / elastic.giveup
    serving.preempt / serving.timeout / serving.cancel
    ckpt.save           a checkpoint became durable (step)
    compile             a jitted function compiled (fn, seconds, flops)

On crash, NaN give-up, or watchdog trip the instrumented sites call
:meth:`FlightRecorder.dump`, which atomically writes
``flight_<step>.json`` (same tmp + ``os.replace`` durability idiom as
the checkpoints) so a dead run always leaves its last N events behind.

Dumping is gated on a destination directory: set :attr:`FlightRecorder.dir`
(or the ``PT_FLIGHT_DIR`` environment variable) to enable it. Recording
is always on — the ring costs a few hundred dicts of memory — and an
unconfigured recorder simply never touches the filesystem.

Import-light on purpose: stdlib only, so the faults/watchdog layers can
feed it without any import cycle.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["FLIGHT", "FlightRecorder"]

_DEFAULT_CAPACITY = 512


class FlightRecorder:
    """Bounded ring of event dicts. ``record`` never raises and never
    blocks beyond the ring lock; ``dump`` writes the whole ring as one
    JSON document via tmp + ``os.replace`` (atomic on POSIX)."""

    def __init__(self, capacity: int = None, directory: Optional[str] = None):
        if capacity is None:
            capacity = int(os.environ.get("PT_FLIGHT_CAPACITY",
                                          _DEFAULT_CAPACITY))
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.last_step = 0          # newest step seen in any event
        self.dumps = 0              # dump() calls that produced a file
        # dump destination; None/"" = recording only, never write a file
        self.dir: Optional[str] = (directory if directory is not None
                                   else os.environ.get("PT_FLIGHT_DIR") or None)

    # ---------------------------------------------------------- recording
    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def set_capacity(self, capacity: int):
        """Resize the ring, keeping the newest events."""
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        with self._lock:
            self._ring = deque(self._ring, maxlen=capacity)

    def record(self, kind: str, **fields):
        """Append one structured event. ``step=`` (when present and an
        int) also advances :attr:`last_step`, which names the dump file."""
        step = fields.get("step")
        with self._lock:
            self._seq += 1
            if isinstance(step, int) and step > self.last_step:
                self.last_step = step
            self._ring.append({"seq": self._seq, "t_mono": time.monotonic(),
                               "kind": kind, **fields})

    @property
    def total_recorded(self) -> int:
        """Events ever recorded (>= len(events()) once the ring wraps)."""
        return self._seq

    def events(self) -> list:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self.last_step = 0

    # ------------------------------------------------------------ dumping
    def dump(self, reason: str = "", directory: Optional[str] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Atomically write ``flight_<step>.json`` and return its path.

        ``directory`` overrides :attr:`dir` for this call; ``path`` pins
        the exact file. With no destination configured anywhere, returns
        None without touching the filesystem — crash paths call this
        unconditionally, so "not configured" must be a cheap no-op."""
        if path is None:
            d = directory or self.dir
            if not d:
                return None
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"flight_{self.last_step:08d}.json")
        with self._lock:
            events = list(self._ring)
            total = self._seq
        doc = {
            "reason": reason,
            "t_wall": time.time(),      # humans correlate dumps by wall clock
            "last_step": self.last_step,
            "capacity": self._ring.maxlen,
            "total_recorded": total,
            "dropped": max(0, total - len(events)),
            "events": events,
        }
        # slowest/failed request timelines — lazy import keeps
        # this module stdlib-only for everyone who never enables tracking
        try:
            from paddle_tpu_torch.observability.requests import REQUESTS
            if len(REQUESTS):
                doc["requests"] = REQUESTS.flight_excerpt()
        except Exception:
            pass                        # dump paths must never raise
        # KV memory-ledger snapshots: where every pool block
        # was when the dump fired — the OOM-forensics payload
        try:
            from paddle_tpu_torch.observability.memledger import flight_excerpt
            mem = flight_excerpt()
            if mem:
                doc["memory"] = mem
        except Exception:
            pass                        # dump paths must never raise
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.dumps += 1
        return path


FLIGHT = FlightRecorder()
