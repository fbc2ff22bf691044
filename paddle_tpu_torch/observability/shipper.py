"""Periodic metrics-snapshot shipper — a copy of
``paddle_tpu/observability/shipper.py``.

The registry answers queries only while the process is alive and
someone is polling ``/metrics``. :class:`MetricsShipper` makes the
telemetry survive the process: a ``pt-metrics-shipper`` daemon thread
periodically appends one JSON line per snapshot to a size-capped
rotating ring of files on disk —

    <path>          newest lines
    <path>.1        previous segment
    ...
    <path>.<max_files-1>   oldest segment (deleted on the next rotation)

Each line carries the full snapshot PLUS per-series deltas of every
cumulative value (counters, histogram sums/counts) since the previous
ship, so a consumer can reconstruct rates from any single line without
the line before it — and a process restart (registry back to zero)
shows up as an empty ``deltas`` object instead of a negative rate.

Shipping must never take the host process down: the thread swallows
(and counts) per-ship errors and keeps going; ``stop()`` ships one
final snapshot so the tail of a run is on disk. Each ship refreshes the
``device_bytes_*`` gauges from the CUDA caching allocator
(``memledger.device_memory_stats``, under the capture lock).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from paddle_tpu_torch.observability.memledger import device_memory_stats
from paddle_tpu_torch.observability.metrics import METRICS

__all__ = ["MetricsShipper", "start_metrics_shipper", "stop_metrics_shipper"]


class MetricsShipper:
    """One output ring + (optionally) one daemon ship thread."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 max_bytes: int = 1 << 20, max_files: int = 3,
                 registry=None):
        if max_files < 1:
            raise ValueError(f"max_files must be >= 1, got {max_files}")
        self.path = str(path)
        self.interval_s = interval_s
        self.max_bytes = max_bytes
        self.max_files = max_files
        self._reg = registry if registry is not None else METRICS
        self._prev: Optional[dict] = None     # flat cumulative series
        self._prev_t: Optional[float] = None
        self._seq = 0
        self.shipped = 0
        self.errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)

    # ------------------------------------------------------------- thread
    def start(self) -> "MetricsShipper":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pt-metrics-shipper", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._ship_guarded()
        self._ship_guarded()      # final snapshot: the tail reaches disk

    def _ship_guarded(self):
        try:
            self.ship_now()
        except Exception:         # shipping never kills the host process
            self.errors += 1

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)

    def __enter__(self) -> "MetricsShipper":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --------------------------------------------------------------- ship
    @staticmethod
    def _flat_cumulative(snap: dict) -> dict:
        """Every monotonically-increasing series as one flat dict —
        counters plus histogram sums/counts (gauges can go down, so they
        get no deltas)."""
        flat = dict(snap["counters"])
        for series, h in snap["histograms"].items():
            flat[series + "_sum"] = h["sum"]
            flat[series + "_count"] = h["count"]
        return flat

    def ship_now(self) -> dict:
        """Take one snapshot, append it as one JSONL line (rotating
        first when the current segment is over ``max_bytes``), and
        return the shipped record."""
        # device-memory gauges must be fresh in every shipped snapshot —
        # pull them here rather than hoping an engine tick refreshed them
        # recently (the allocator's stats; zeroed without a card)
        try:
            device_memory_stats()
        except Exception:
            pass
        snap = self._reg.snapshot()
        now = time.monotonic()
        flat = self._flat_cumulative(snap)
        deltas = {}
        if self._prev is not None:
            for k, v in flat.items():
                d = v - self._prev.get(k, 0.0)
                if d:
                    deltas[k] = d
        rec = {
            "seq": self._seq,
            "t_wall": time.time(),    # cross-process correlation timestamp
            "t_mono": now,
            "interval_s": (now - self._prev_t
                           if self._prev_t is not None else None),
            "snapshot": snap,
            "deltas": deltas,
        }
        self._seq += 1
        self._prev, self._prev_t = flat, now
        self._rotate_if_needed()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True, separators=(",", ":"))
                    + "\n")
        self.shipped += 1
        return rec

    def _rotate_if_needed(self):
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size < self.max_bytes:
            return
        if self.max_files == 1:       # ring of one: rotation = truncation
            os.remove(self.path)
            return
        oldest = f"{self.path}.{self.max_files - 1}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for i in range(self.max_files - 1, 1, -1):
            src = f"{self.path}.{i - 1}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i}")
        os.replace(self.path, f"{self.path}.1")


_default: Optional[MetricsShipper] = None
_default_lock = threading.Lock()


def start_metrics_shipper(path: str, interval_s: float = 10.0,
                          **kw) -> MetricsShipper:
    """Start (or return the already-running) module-default shipper."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsShipper(path, interval_s=interval_s,
                                      **kw).start()
        return _default


def stop_metrics_shipper():
    """Stop the module-default shipper, if one is running."""
    global _default
    with _default_lock:
        shp, _default = _default, None
    if shp is not None:
        shp.stop()
