"""Observability — the port's counterpart of ``paddle_tpu/observability``.

Copied, as they never imported JAX: the metrics registry
(:data:`METRICS`), trace spans (:data:`TRACER`, :func:`span`), the
per-pool KV memory ledger (:mod:`.memledger`, whose device statistics
come from ``torch.cuda.memory_stats``), the flight recorder
(:data:`FLIGHT`, a bounded ring of runtime events dumped on failure),
the goodput ledger (:data:`GOODPUT`: useful vs wasted device tokens by
reason), the request tracker (:data:`REQUESTS`: per-request lifecycle
timelines) and the windowed metric reads (:class:`WindowedReads`).

Ported: :mod:`.flops` and :mod:`.roofline`, the peak tables and the
serving roofline ledger behind ``serving_mfu`` / ``serving_mbu`` /
``serving_arith_intensity{phase}``. Their peaks resolve from a torch
device: the card's name keys the H100's row, and any device no row
names (the CPU) reads 0.0, "undefined".

The operations layer, copied: :data:`HEALTH` (declarative OK/WARN/CRIT
rules over the registry), :class:`SLOTracker` (per-tenant objectives
with multi-window burn-rate alerting) and its :class:`CostLedger`
(device-seconds, KV block-seconds and tokens by tenant), the
:class:`MetricsShipper` (registry snapshots with deltas into a rotating
JSONL ring) and the :class:`MetricsServer` (``/metrics``, ``/healthz``,
``/flight``, ``/requests``, ``/roofline``, ``/memory``, ``/slo``,
``/tenants`` and ``/profile``, the last on ``torch.profiler``).
"""
from paddle_tpu_torch.observability.flight import (FLIGHT,  # noqa: F401
                                                   FlightRecorder)
from paddle_tpu_torch.observability.flops import (PEAK_BF16,  # noqa: F401
                                                  chip_peak_flops)
from paddle_tpu_torch.observability.goodput import (GOODPUT,  # noqa: F401
                                                    GoodputLedger)
from paddle_tpu_torch.observability.health import (  # noqa: F401
    HEALTH, HealthEvaluator, HealthRule, install_default_rules)
from paddle_tpu_torch.observability.httpd import (  # noqa: F401
    MetricsServer, start_metrics_server, stop_metrics_server)
from paddle_tpu_torch.observability.memledger import (  # noqa: F401
    MemLedger, device_memory_stats, memory_doc)
from paddle_tpu_torch.observability.metrics import METRICS  # noqa: F401
from paddle_tpu_torch.observability.requests import (  # noqa: F401
    REQUESTS, RequestTracker)
from paddle_tpu_torch.observability.shipper import (  # noqa: F401
    MetricsShipper, start_metrics_shipper, stop_metrics_shipper)
from paddle_tpu_torch.observability.slo import (  # noqa: F401
    CostLedger, Objective, SLOTracker, default_objectives, slo_doc,
    slo_enabled, tenants_doc)
from paddle_tpu_torch.observability.roofline import (  # noqa: F401
    PEAK_HBM_BPS, ModelGeometry, chip_peak_hbm_bw,
    record_serving_throughput, resolve_serving_peaks,
    serving_roofline_report)
from paddle_tpu_torch.observability.tracing import (TRACER,  # noqa: F401
                                                    instant, span)
from paddle_tpu_torch.observability.windows import (  # noqa: F401
    WindowedReads)

__all__ = ["METRICS", "TRACER", "span", "instant",
           "FLIGHT", "FlightRecorder", "GOODPUT", "GoodputLedger",
           "REQUESTS", "RequestTracker", "WindowedReads",
           "PEAK_BF16", "chip_peak_flops",
           "PEAK_HBM_BPS", "ModelGeometry", "chip_peak_hbm_bw",
           "resolve_serving_peaks", "record_serving_throughput",
           "serving_roofline_report",
           "MetricsServer", "start_metrics_server", "stop_metrics_server",
           "MetricsShipper", "start_metrics_shipper", "stop_metrics_shipper",
           "HEALTH", "HealthEvaluator", "HealthRule", "install_default_rules",
           "MemLedger", "memory_doc", "device_memory_stats",
           "SLOTracker", "Objective", "CostLedger", "default_objectives",
           "slo_enabled", "slo_doc", "tenants_doc"]
