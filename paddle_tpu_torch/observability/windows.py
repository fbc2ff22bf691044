"""A copy of ``paddle_tpu/observability/windows.py`` (it never imported
JAX). Windowed metric reads: delta reads of counters and
histogram bucket counts against a per-reader snapshot.

Extracted from the degradation ladder (``serving/degrade.py``) so the
same machinery drives both the ladder's pressure signals and the SLO
tracker's burn-rate windows. Each :class:`WindowedReads` instance owns
its own snapshot dict, so two consumers polling at different cadences
never steal each other's deltas.

Semantics (unchanged from the ladder):

  * the FIRST read of a name baselines at the current total, so
    pre-existing counts never register as a window delta;
  * counter deltas clamp at zero (a registry reset between polls reads
    as an empty window, not a negative one);
  * an empty histogram window quantile is NaN — no traffic is healthy,
    not zero-latency.

The per-series variants (:meth:`window_counter_series`,
:meth:`window_histogram_series`) snapshot EVERY series of an instrument
in one call and return per-label-tuple deltas; call them once per poll
and fan the result out, rather than once per label (each call advances
the window).

This module registers no instruments — it only reads them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from paddle_tpu_torch.observability.metrics import METRICS, Histogram

__all__ = ["WindowedReads"]


def _nan() -> float:
    return float("nan")


class WindowedReads:
    """Snapshot-diff reads over a metrics registry. Host-side dicts
    only; safe to call from any gauge sweep."""

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else METRICS
        self._snap: dict = {}

    # ------------------------------------------------------- aggregate
    def window_counter(self, name: str) -> float:
        """Counter delta (summed over label series) since the previous
        poll. The first read of a name baselines it at the current
        total, so pre-existing counts never trigger the consumer."""
        inst = self.registry.get(name)
        total = 0.0 if inst is None else \
            float(sum(cell[0] for cell in inst._series.values()))
        key = ("c", name)
        prev = self._snap.get(key, total)
        self._snap[key] = total
        return max(0.0, total - prev)

    def gauge(self, name: str) -> float:
        """Instantaneous gauge read (summed over label series)."""
        inst = self.registry.get(name)
        if inst is None:
            return 0.0
        return float(sum(cell[0] for cell in inst._series.values()))

    def window_goodput(self) -> Tuple[float, float]:
        """(goodput ratio, token volume) over the window — NaN ratio on
        an empty window, so no-traffic polls read as healthy."""
        good = self.window_counter("serving_goodput_tokens_total")
        waste = self.window_counter("serving_waste_total")
        volume = good + waste
        return (good / volume if volume > 0 else _nan()), volume

    def window_quantile(self, name: str, q: float) -> float:
        """Histogram quantile over THIS window's observations: per-
        bucket count deltas vs the previous poll, interpolated exactly
        like ``Histogram.quantile``. NaN when the window saw nothing."""
        inst = self.registry.get(name)
        if not isinstance(inst, Histogram):
            return _nan()
        n = len(inst.buckets) + 1
        agg = [0] * n
        for s in inst._series.values():
            for i, c in enumerate(s.counts):
                agg[i] += c
        key = ("h", name)
        prev = self._snap.get(key, agg)
        self._snap[key] = agg
        delta = [max(0, a - p) for a, p in zip(agg, prev)]
        return quantile_from_deltas(inst.buckets, delta, q)

    # ------------------------------------------------------ per-series
    def window_counter_series(self, name: str) -> Dict[tuple, float]:
        """Per-label-series counter deltas since the previous poll, as
        ``{label_values_tuple: delta}``. The first poll of an instrument
        baselines every existing series at its current total (all-zero
        deltas, matching :meth:`window_counter`); a series appearing on
        a LATER poll reports its full count — a brand-new series'
        increments all happened inside this window."""
        inst = self.registry.get(name)
        key = ("cs", name)
        prev = self._snap.get(key)
        if inst is None:
            self._snap[key] = {}
            return {}
        cur = {k: float(cell[0]) for k, cell in inst._series.items()}
        self._snap[key] = cur
        if prev is None:                       # first poll: baseline
            return {k: 0.0 for k in cur}
        return {k: max(0.0, v - prev.get(k, 0.0)) for k, v in cur.items()}

    def window_histogram_series(self, name: str) \
            -> Dict[tuple, List[int]]:
        """Per-label-series histogram bucket-count deltas since the
        previous poll, as ``{label_values_tuple: [delta per bucket]}``
        (last entry is the +Inf overflow bucket). First-poll baselining
        and late-series semantics match :meth:`window_counter_series`."""
        inst = self.registry.get(name)
        key = ("hs", name)
        prev = self._snap.get(key)
        if not isinstance(inst, Histogram):
            self._snap[key] = {}
            return {}
        cur = {k: list(s.counts) for k, s in inst._series.items()}
        self._snap[key] = cur
        if prev is None:                       # first poll: baseline
            return {k: [0] * len(c) for k, c in cur.items()}
        out = {}
        for k, counts in cur.items():
            p = prev.get(k, [0] * len(counts))
            out[k] = [max(0, a - b) for a, b in zip(counts, p)]
        return out


def quantile_from_deltas(buckets, delta, q: float) -> float:
    """Interpolated quantile over one window's bucket-count deltas —
    the same linear interpolation ``Histogram.quantile`` applies to
    lifetime counts. NaN on an empty window; an overflow-only window
    reads as the highest finite bound."""
    count = sum(delta)
    if count == 0:
        return _nan()
    rank, cum = q * count, 0.0
    for i, bound in enumerate(buckets):
        prev_cum = cum
        cum += delta[i]
        if cum >= rank and delta[i] > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            return lo + (bound - lo) * ((rank - prev_cum) / delta[i])
    return buckets[-1]
