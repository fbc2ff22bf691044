"""``/metrics`` pull endpoint — a copy of
``paddle_tpu/observability/httpd.py`` with ``/profile`` on
``torch.profiler``.

A stdlib-only ``http.server`` running on a daemon thread, exposing the
process-global registry the way a Prometheus scraper expects:

  * ``GET /metrics``       → text exposition format 0.0.4
  * ``GET /metrics.json``  → the one-line JSON snapshot
  * ``GET /healthz``       → HEALTH.evaluate() JSON; HTTP 503 on CRIT so
    a TCP/status-code health checker needs zero JSON parsing
  * ``GET /flight``        → the flight recorder's current ring as JSON
  * ``GET /requests``      → the request tracker's recent per-request
    timelines + summaries; empty lists while tracking is off
  * ``GET /roofline``      → the serving roofline ledger's per-phase
    MFU/MBU/intensity reports + the machine roofs
  * ``GET /memory``        → every live KV pool's memory-ledger snapshot
    (blocks by state, fragmentation, stalls, top holders) plus the
    CUDA caching allocator's stats per card
  * ``GET /slo``           → every live SLO tracker's objectives, per-
    tenant burn rates / budget remaining and recent breaches
  * ``GET /tenants``       → the usage-metering cost ledger: per-tenant
    device-seconds, KV block-seconds and goodput/waste/saved tokens
  * ``GET /profile?seconds=N`` → run ONE ``torch.profiler`` capture of N
    seconds (0 < N <= 600) and write it as a Chrome-trace JSON into
    ``PT_PROFILE_DIR`` (default ``pt_profile``); 400 on a missing/bad
    ``seconds``, 409 while a capture is already running — at most one
    capture at a time — and 500, with the lock released, when the
    capture fails
  * anything else          → 404

The capture records CPU activity, and CUDA activity (CUPTI: every
kernel of the process, whichever thread launched it) when a card is
present. Its CPU operator events cover every thread where the installed
PyTorch's profiler takes ``profile_all_threads``; with an older one,
only the operators of the thread that started the profiler — this
server's handler thread, not the engine's. The first capture of a
process starts Kineto and CUPTI before its window opens, which takes
seconds on a card (the answer's ``start_s``; later captures start in
milliseconds); started from a thread other than the one that imported
torch, Kineto prints "External init callback must run in same thread
as registerClient", and the kernels and every thread's operators are
recorded all the same. The capture holds
``core.device.CAPTURE_LOCK`` for its whole window, so no CUDA graph is
captured while the profiler runs (an engine being built waits for the
window to end); ``/memory`` holds it across its allocator queries.

Usage::

    from paddle_tpu_torch.observability import start_metrics_server
    srv = start_metrics_server(port=9100)    # port=0 picks a free port
    ...                                      # scrape http://host:srv.port/metrics
    srv.stop()

``start_metrics_server``/``stop_metrics_server`` also manage one
module-level default server so a serving script can expose metrics in
two lines and not hold a handle. The serving thread is named
``pt-metrics-http``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from paddle_tpu_torch.observability.metrics import METRICS

__all__ = ["MetricsServer", "start_metrics_server", "stop_metrics_server"]

_PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"

# one profiler capture at a time, process-wide: torch.profiler keeps one
# global Kineto session
_PROFILE_LOCK = threading.Lock()
_PROFILE_MAX_SECONDS = 600.0


def _run_profile_capture(seconds: float) -> dict:
    """One ``torch.profiler`` capture of ``seconds`` written as a
    Chrome-trace JSON into ``PT_PROFILE_DIR``. torch imports lazily — the
    metrics server itself must stay usable in processes that never touch
    a device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core.device import CAPTURE_LOCK
    out_dir = os.environ.get("PT_PROFILE_DIR", "pt_profile")
    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
        all_threads = True
    except (ImportError, TypeError):
        all_threads = False      # only this thread's CPU operators
    t0 = time.monotonic()
    with CAPTURE_LOCK:
        prof = profile(activities=acts, **kw)
        prof.start()
        started = time.monotonic()
        try:
            time.sleep(seconds)
        finally:
            prof.stop()
    path = os.path.join(out_dir, f"torch_profile_{os.getpid()}_"
                                 f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return {"dir": out_dir, "seconds": seconds, "trace": path,
            "bytes": os.path.getsize(path),
            "start_s": started - t0, "wall_s": time.monotonic() - t0,
            "cuda": ProfilerActivity.CUDA in acts,
            "all_threads": all_threads}


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — http.server API
        path = self.path.split("?", 1)[0]
        status = 200
        if path == "/metrics":
            body = METRICS.to_prometheus().encode()
            ctype = _PROM_CTYPE
        elif path == "/metrics.json":
            body = (METRICS.to_json() + "\n").encode()
            ctype = "application/json"
        elif path == "/healthz":
            from paddle_tpu_torch.observability.health import HEALTH
            report = HEALTH.evaluate()
            if report["status"] == "CRIT":
                status = 503
            body = (json.dumps(report, sort_keys=True) + "\n").encode()
            ctype = "application/json"
        elif path == "/flight":
            from paddle_tpu_torch.observability.flight import FLIGHT
            doc = {"last_step": FLIGHT.last_step,
                   "capacity": FLIGHT.capacity,
                   "total_recorded": FLIGHT.total_recorded,
                   "events": FLIGHT.events()}
            body = (json.dumps(doc, sort_keys=True) + "\n").encode()
            ctype = "application/json"
        elif path == "/requests":
            from paddle_tpu_torch.observability.requests import REQUESTS
            body = (json.dumps(REQUESTS.to_doc(), sort_keys=True)
                    + "\n").encode()
            ctype = "application/json"
        elif path == "/roofline":
            from paddle_tpu_torch.observability.roofline import (
                serving_roofline_report)
            body = (json.dumps(serving_roofline_report(), sort_keys=True)
                    + "\n").encode()
            ctype = "application/json"
        elif path == "/memory":
            from paddle_tpu_torch.observability.memledger import memory_doc
            body = (json.dumps(memory_doc(), sort_keys=True)
                    + "\n").encode()
            ctype = "application/json"
        elif path == "/slo":
            from paddle_tpu_torch.observability.slo import slo_doc
            body = (json.dumps(slo_doc(), sort_keys=True) + "\n").encode()
            ctype = "application/json"
        elif path == "/tenants":
            from paddle_tpu_torch.observability.slo import tenants_doc
            body = (json.dumps(tenants_doc(), sort_keys=True)
                    + "\n").encode()
            ctype = "application/json"
        elif path == "/profile":
            qs = parse_qs(self.path.partition("?")[2])
            raw = qs.get("seconds", [None])[0]
            try:
                seconds = float(raw)
            except (TypeError, ValueError):
                self.send_error(
                    400, "need /profile?seconds=N with numeric N")
                return
            if not 0.0 < seconds <= _PROFILE_MAX_SECONDS:
                self.send_error(
                    400, f"seconds must be in (0, "
                         f"{_PROFILE_MAX_SECONDS:.0f}], got {raw}")
                return
            if not _PROFILE_LOCK.acquire(blocking=False):
                self.send_error(
                    409, "a profiler capture is already running")
                return
            # the lock is released before any reply: a client that has
            # its answer finds the next capture free
            failed = None
            try:
                doc = _run_profile_capture(seconds)
            except Exception as e:     # noqa: BLE001 — report, don't die
                failed = f"{type(e).__name__}: {e}"
            finally:
                _PROFILE_LOCK.release()
            if failed is not None:
                self.send_error(500, f"profiler capture failed: {failed}")
                return
            body = (json.dumps(doc, sort_keys=True) + "\n").encode()
            ctype = "application/json"
        else:
            self.send_error(
                404, "try /metrics, /metrics.json, /healthz, /flight, "
                     "/requests, /roofline, /memory, /slo, /tenants or "
                     "/profile?seconds=N")
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):   # scrapes must not spam stderr
        pass


class MetricsServer:
    """One bound listener + one daemon serve thread. ``port=0`` binds an
    ephemeral port; read it back from :attr:`port` (useful in tests and
    when several trainers share a host)."""

    def __init__(self, port: int = 9100, host: str = "0.0.0.0"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pt-metrics-http",
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host == "0.0.0.0" else self.host
        return f"http://{host}:{self.port}/metrics"

    def stop(self, timeout: float = 5.0):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


_default: Optional[MetricsServer] = None
_default_lock = threading.Lock()


def start_metrics_server(port: int = 9100, host: str = "0.0.0.0") -> MetricsServer:
    """Start (or return the already-running) module-default server."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsServer(port=port, host=host)
        return _default


def stop_metrics_server():
    """Stop the module-default server, if one is running."""
    global _default
    with _default_lock:
        srv, _default = _default, None
    if srv is not None:
        srv.stop()
