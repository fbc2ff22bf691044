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
"""
from paddle_tpu_torch.observability.flight import (FLIGHT,  # noqa: F401
                                                   FlightRecorder)
from paddle_tpu_torch.observability.flops import (PEAK_BF16,  # noqa: F401
                                                  chip_peak_flops)
from paddle_tpu_torch.observability.goodput import (GOODPUT,  # noqa: F401
                                                    GoodputLedger)
from paddle_tpu_torch.observability.metrics import METRICS  # noqa: F401
from paddle_tpu_torch.observability.requests import (  # noqa: F401
    REQUESTS, RequestTracker)
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
           "serving_roofline_report"]
