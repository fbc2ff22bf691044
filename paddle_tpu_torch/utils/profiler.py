"""Profiling — counterpart of ``paddle_tpu/utils/profiler.py`` (ref
``python/paddle/profiler/``: Profiler, RecordEvent, chrome-trace export).

:class:`Profiler` drives ``torch.profiler`` (host and CUDA activities;
CUPTI traces the card's kernels) and the host span tracer, and writes
both traces under ``log_dir`` on stop: ``trace.json`` (torch's Chrome
trace) and ``host_trace.json`` (the spans). :func:`record_event` /
:class:`RecordEvent` open a ``torch.profiler.record_function`` range and a
host span together; :class:`StepTimer` feeds the shared
``train_tokens_per_sec`` / ``train_mfu`` gauges through
:func:`~paddle_tpu_torch.observability.flops.record_throughput`, the
choke point the Trainer uses; :func:`device_memory_stats` reads
``torch.cuda.memory_stats``.

``dump_cost_analysis`` and ``compiled_memory_analysis`` read XLA's
compiled program; an eager PyTorch step has no such program, so they
raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from paddle_tpu_torch.observability import METRICS, TRACER, span as _span
from paddle_tpu_torch.observability.flops import record_throughput

_STEPTIMER_S = METRICS.histogram(
    "steptimer_step_seconds", "wall time per StepTimer start/stop window")
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


class ProfilerTarget:
    """Ref profiler.ProfilerTarget — the activities to trace."""
    CPU = "cpu"
    GPU = "gpu"
    CUSTOM_DEVICE = "custom_device"


def _activities(targets):
    acts = []
    for t in (targets or (ProfilerTarget.CPU, ProfilerTarget.GPU)):
        if t == ProfilerTarget.CPU:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """Reference-shaped API: ``Profiler(targets=..., scheduler=...,
    on_trace_ready=...)`` ... ``start`` / ``stop`` (or a ``with`` block).
    ``on_trace_ready`` runs BEFORE the trace starts, so
    :func:`export_chrome_tracing` can direct the output directory.
    ``scheduler`` (:func:`make_scheduler`'s callable) is kept for parity:
    the window is the start/stop span. After ``stop``,
    :attr:`prof` holds the ``torch.profiler.profile`` (its
    ``key_averages()``)."""

    def __init__(self, log_dir: str = "profile_out", targets=None,
                 scheduler=None, on_trace_ready=None):
        self.log_dir = log_dir
        self.targets = targets
        self.scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self._active = False
        self._owns_tracer = False
        self.prof = None
        self.trace_path: Optional[str] = None
        self.host_trace_path: Optional[str] = None

    def start(self):
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)  # may redirect self.log_dir
        self.prof = torch.profiler.profile(
            activities=_activities(self.targets))
        self.prof.__enter__()
        self._owns_tracer = not TRACER._enabled
        if self._owns_tracer:
            TRACER.enable()
        self._active = True
        return self

    def stop(self):
        if not self._active:
            return
        self.prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self.prof.export_chrome_trace(self.trace_path)
        if self._owns_tracer:
            self.host_trace_path = os.path.join(self.log_dir,
                                                "host_trace.json")
            TRACER.export_chrome_trace(self.host_trace_path)
            TRACER.disable()
            self._owns_tracer = False
        self._active = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@contextlib.contextmanager
def record_event(name: str):
    """Ref ``paddle.profiler.RecordEvent``: a ``record_function`` range in
    torch's trace and a span on the host timeline."""
    with torch.profiler.record_function(name), _span(name):
        yield


class RecordEvent:
    """Ref ``profiler.RecordEvent``: a context manager with begin/end."""

    def __init__(self, name: str):
        self.name = name
        self._cm = None

    def begin(self):
        self._cm = record_event(self.name)
        self._cm.__enter__()

    def end(self):
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def device_memory_stats() -> dict:
    """Per-device memory use (ref ``paddle.device.cuda.memory_allocated``)
    from ``torch.cuda.memory_stats``; with no card, one zeroed CPU record
    with the backend named, never an empty dict."""
    out = {}
    if not torch.cuda.is_available():
        out["cpu"] = {"backend": "cpu", "bytes_in_use": 0,
                      "peak_bytes_in_use": 0, "bytes_limit": 0}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "backend": "gpu",
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    for dev, rec in out.items():
        _DEV_MEM.set(rec["bytes_in_use"] or 0, device=dev)
        _DEV_MEM_PEAK.set(rec["peak_bytes_in_use"] or 0, device=dev)
        _DEV_MEM_LIMIT.set(rec["bytes_limit"] or 0, device=dev)
    return out


@dataclass
class StepTimer:
    """Host-side step timing and MFU meter. ``peak_flops`` is the
    device's row (``observability.flops.chip_peak_flops``); 0 reports no
    MFU."""
    flops_per_token: float = 0.0
    peak_flops: float = 0.0
    _t0: float = field(default=0.0, repr=False)
    records: list = field(default_factory=list)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, tokens: int = 0) -> dict:
        dt = time.perf_counter() - self._t0
        rec = {"step_s": dt}
        _STEPTIMER_S.observe(dt)
        if tokens and dt > 0:
            rec["tokens_per_sec"] = tokens / dt
            mfu = record_throughput(tokens / dt, self.flops_per_token,
                                    self.peak_flops)
            if self.flops_per_token:
                rec["mfu"] = mfu
        self.records.append(rec)
        return rec


def _no_xla(what):
    raise NotImplementedError(
        f"{what} reads XLA's compiled program; an eager PyTorch step has "
        f"none (XLA compile introspection is not ported)")


def dump_cost_analysis(fn, *args) -> dict:
    _no_xla("dump_cost_analysis")


def compiled_memory_analysis(fn, *args) -> dict:
    _no_xla("compiled_memory_analysis")


def make_scheduler(*, closed, ready, record, repeat=0, skip_first=0):
    """Ref ``profiler.make_scheduler``: step -> "closed" / "ready" /
    "record"."""
    if record <= 0:
        raise ValueError("make_scheduler: record must be > 0")
    if closed < 0 or ready < 0:
        raise ValueError("make_scheduler: closed/ready must be >= 0")
    cycle = closed + ready + record

    def schedule(step: int) -> str:
        if step < skip_first:
            return "closed"
        s = step - skip_first
        if repeat and s >= repeat * cycle:
            return "closed"
        pos = s % cycle
        if pos < closed:
            return "closed"
        if pos < closed + ready:
            return "ready"
        return "record"

    return schedule


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    """Ref ``profiler.export_chrome_tracing``: the callback
    ``Profiler.start`` runs before tracing, directing the traces to
    ``dir_name``."""
    def on_export(prof):
        prof.log_dir = dir_name
        return dir_name
    return on_export
