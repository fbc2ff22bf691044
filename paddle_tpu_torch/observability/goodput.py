"""A copy of ``paddle_tpu/observability/goodput.py`` (it never imported
JAX). Goodput ledger: attribute every device token to useful vs
wasted work, MegaScale-style.

``serving_tokens_total`` counts what came out; it says nothing about
what the device burned to get there. The ledger splits device token
work into

  * **goodput** — sampled/committed tokens the caller keeps; the
    ``serving_goodput_tokens_total`` counter increments at exactly the
    same sites as ``serving_tokens_total``, so the two reconcile
    tick-for-tick by construction, and
  * **waste** — ``serving_waste_total{why}`` token-positions computed
    and thrown away:

      ``spec_rejected``     draft tokens the target model refused
      ``replay_prefill``    re-prefilled positions after a preemption
                            replay (minus prefix-cache hits)
      ``pad_rows``          whole padding rows in chunked-prefill and
                            spec-verify batches (row slots launched
                            with no live sequence)
      ``moe_capacity_drop`` MoE routing assignments dropped at expert
                            capacity
      ``chaos_abort``       drafted-but-never-verified tokens when a
                            fault aborts a spec tick
      ``async_overrun``     async-pipeline ticks that ran on device for
                            a slot the host had already torn down by
                            the time the window drained

A third, token-level column closes the books: **saved** —
``serving_goodput_saved_tokens_total`` — prefill token-positions the
device never had to compute because admission adopted them from the
prefix cache (full-block shares plus the radix trie's partial
copy-on-write hits). Saved tokens are neither good nor waste: they are
work that did not happen, the direct counterpart of the
``replay_prefill`` waste column.

The lifetime ratio good/(good+waste) is exported as the
``serving_goodput_ratio`` gauge (refreshed by the engine's gauge sweep
and on demand via :meth:`GoodputLedger.refresh_gauge`), and the stock
low-goodput health rule of :mod:`.health` flags a server whose waste
fraction says the card mostly heats air.

All state lives in the metrics registry — the ledger owns no counters
of its own, so the conftest registry reset is the only hygiene needed.

Usage metering: the ledger is also the tenant-attribution choke point.
An attached sink (the SLO tracker's cost ledger, :mod:`.slo`) receives
every ``good``/``waste``/``saved`` charge together with the ``tenant=``
the call site knows (``None`` for batch-level overheads like padding
rows) — because attribution happens INSIDE the same call that moves the
counters, per-tenant sums reconcile with the untenanted totals exactly,
by construction, not by auditing call sites.
"""
from __future__ import annotations

from paddle_tpu_torch.observability.metrics import METRICS

__all__ = ["GOODPUT", "GoodputLedger", "WASTE_WHYS"]

WASTE_WHYS = ("spec_rejected", "replay_prefill", "pad_rows",
              "moe_capacity_drop", "chaos_abort", "async_overrun")

_GOOD = METRICS.counter(
    "serving_goodput_tokens_total",
    "device tokens that produced output the caller keeps (same increment "
    "sites as serving_tokens_total, so the two reconcile)")
_WASTE = METRICS.counter(
    "serving_waste_total",
    "device token-positions computed then thrown away, by cause "
    "(spec_rejected, replay_prefill, pad_rows, moe_capacity_drop, "
    "chaos_abort, async_overrun)",
    labelnames=("why",))
_RATIO = METRICS.gauge(
    "serving_goodput_ratio",
    "lifetime goodput/(goodput+waste) token ratio")
_SAVED = METRICS.counter(
    "serving_goodput_saved_tokens_total",
    "prefill token-positions skipped outright at admission — adopted "
    "from the prefix cache instead of recomputed")


def _series_total(inst) -> float:
    return float(sum(cell[0] for cell in inst._series.values()))


class GoodputLedger:
    """Thin façade over the three instruments. Methods never allocate
    beyond the counter increment; ``waste(n<=0)`` is a no-op so call
    sites can pass raw deltas without guarding. ``tenant=`` is optional
    attribution metadata forwarded to the attached metering sink (if
    any) — it never affects the untenanted counters."""

    def __init__(self):
        self._sink = None

    def attach_sink(self, sink):
        """Install (or clear, with ``None``) the tenant-attribution
        sink — an object with ``good(tenant, n)`` / ``waste(tenant,
        why, n)`` / ``saved(tenant, n)``. One sink per process; the SLO
        tracker's cost ledger attaches itself at construction."""
        self._sink = sink

    def good(self, n: int = 1, tenant=None):
        _GOOD.inc(n)
        if self._sink is not None:
            self._sink.good(tenant, n)

    def waste(self, why: str, n: int, tenant=None):
        if n > 0:
            _WASTE.inc(n, why=why)
            if self._sink is not None:
                self._sink.waste(tenant, why, n)

    def saved(self, n: int, tenant=None):
        """Token-positions admission adopted from the prefix cache —
        device work avoided entirely (no-op for n <= 0)."""
        if n > 0:
            _SAVED.inc(n)
            if self._sink is not None:
                self._sink.saved(tenant, n)

    def saved_total(self) -> float:
        return _series_total(_SAVED)

    def good_total(self) -> float:
        return _series_total(_GOOD)

    def waste_total(self) -> float:
        return _series_total(_WASTE)

    def waste_by_why(self) -> dict:
        return {key[0] if key else "": float(cell[0])
                for key, cell in _WASTE._series.items()}

    def ratio(self) -> float:
        """good/(good+waste); NaN while no tokens have been accounted
        (no traffic is not 0% goodput)."""
        g, w = self.good_total(), self.waste_total()
        return g / (g + w) if (g + w) else float("nan")

    def refresh_gauge(self):
        """Push the current ratio into ``serving_goodput_ratio`` (skipped
        while there is no data, so the gauge stays absent not zero)."""
        g, w = self.good_total(), self.waste_total()
        if g + w:
            _RATIO.set(g / (g + w))


GOODPUT = GoodputLedger()
