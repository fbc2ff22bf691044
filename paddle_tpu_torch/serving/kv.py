"""KVManager: block tables, prefix cache, and the reservation ledger —
counterpart of ``paddle_tpu/serving/kv.py``.

It owns the block manager —
:class:`~paddle_tpu_torch.models.paged.RadixPrefixBlockManager` (token-
span radix trie, copy-on-write partial-block reuse) by default, or the
flat :class:`~paddle_tpu_torch.models.paged.PrefixCachingBlockManager`
under ``PT_RADIX_CACHE=0`` — plus the RESERVATION LEDGER admission runs
on: ``need[rid]`` is a request's worst-case block count, ``resv[rid]``
the part not yet materialised as live table entries, and ``reserved``
their sum — the blocks the free list must keep clear of other requests.
"""
from __future__ import annotations

import os

from paddle_tpu_torch.models.paged import (PrefixCachingBlockManager,
                                           RadixPrefixBlockManager)
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.serving.telemetry import (_PREFIX_EVICTIONS,
                                                _PREFIX_HIT_RATE,
                                                _PREFIX_HITS,
                                                _PREFIX_PARTIAL_HITS,
                                                _PREFIX_TOKEN_HIT_RATE,
                                                _PREFIX_TOKEN_HITS)


def cache_block_bytes(cache) -> int:
    """Device bytes ONE pool block holds across all layers: K and V at
    their stored type, plus the fp32 scale pools of an int8 pool (1-byte
    codes and a 4-byte scale per (position, KV head))."""
    return sum(p[0].numel() * p.element_size()
               for p in (*cache.k_store, *cache.v_store,
                         *cache.k_scale_store, *cache.v_scale_store))


class KVManager:
    """Block allocation + worst-case reservation accounting."""

    def __init__(self, num_blocks: int, block_size: int):
        cls = (PrefixCachingBlockManager
               if os.environ.get("PT_RADIX_CACHE", "1") == "0"
               else RadixPrefixBlockManager)
        self.mgr = cls(num_blocks, block_size)
        # the block manager owns the per-pool memory ledger; this layer
        # mirrors the reservation count into it
        self.ledger = self.mgr.ledger
        self.reserved = 0            # blocks promised to in-flight requests
        self.resv: dict[int, int] = {}    # req_id -> outstanding reserve
        self.need: dict[int, int] = {}    # req_id -> worst-case blocks
        self._prefix_pushed = dict(self.mgr.cache_stats)

    # --------------------------------------------------- pool passthroughs
    @property
    def free_blocks(self):
        return self.mgr.free_blocks

    def blocks_needed(self, n_tokens: int) -> int:
        return self.mgr.blocks_needed(n_tokens)

    def allocate(self, rid: int, n_tokens: int):
        return self.mgr.allocate(rid, n_tokens)

    def free(self, rid: int):
        self.mgr.free(rid)

    # ------------------------------------------------------------- ledger
    def live_blocks(self, rid: int) -> int:
        return sum(b is not None for b in self.mgr.tables.get(rid, []))

    def begin(self, rid: int, need: int):
        """Open a ledger entry: worst case recorded, nothing held yet."""
        self.need[rid] = need
        self.resv[rid] = 0

    def hold(self, rid: int, n: int):
        """Set the outstanding reserve to ``n`` blocks (chunk-prefill and
        beam admissions hold their whole worst case up front)."""
        self.reserved += n - self.resv.get(rid, 0)
        self.resv[rid] = n
        self.ledger.set_reserved(self.reserved)

    def update(self, rid: int, live: int = None):
        """Outstanding reserve = worst case minus blocks currently held.
        Beam groups pass their deduplicated ``live`` count (shared prompt
        blocks appear in several beams' tables)."""
        if live is None:
            live = self.live_blocks(rid)
        new = max(0, self.need[rid] - live)
        self.reserved += new - self.resv[rid]
        self.resv[rid] = new
        self.ledger.set_reserved(self.reserved)

    def release(self, rid: int):
        """Close the ledger entry, returning its reserve to the pool."""
        self.reserved -= self.resv.pop(rid, 0)
        self.need.pop(rid, None)
        self.ledger.set_reserved(self.reserved)

    def take_peak(self, rid) -> int:
        """Pop the request's lifetime peak live-block count."""
        return self.ledger.take_peak(rid)

    def record_stall(self, need: int, slots_short: bool = False):
        """An admission was blocked at the headroom gate — attribute the
        missing blocks to the ledger state holding them."""
        self.ledger.record_stall(need, slots_short=slots_short)

    def reconcile(self) -> dict:
        """Block-for-block walk of the manager vs the ledger mirrors."""
        return self.ledger.reconcile(self.mgr, reserved=self.reserved)

    # ----------------------------------------------------------- hygiene
    def assert_quiescent(self):
        """Every block back in the pool (prefix-cache parked blocks count
        — they are reclaimable), no standing reservations, no tables."""
        try:
            assert self.mgr.free_blocks == self.mgr.num_blocks, (
                f"block leak: {self.mgr.num_blocks - self.mgr.free_blocks} "
                f"of {self.mgr.num_blocks} blocks unaccounted for")
            assert self.reserved == 0, f"reservation leak: {self.reserved}"
            assert not self.resv and not self.need, (
                f"ledger leak: resv={self.resv} need={self.need}")
            assert not self.mgr.tables, f"table leak: {list(self.mgr.tables)}"
        except AssertionError as e:
            FLIGHT.record("serving.quiescence_violation",
                          **self.ledger.flight_fields())
            raise AssertionError(
                f"{e} | kv ledger: {self.ledger.describe()}") from None

    def push_prefix_metrics(self):
        """Counters are process-global and cumulative; the manager's stats
        are per-engine — push only what this engine added since the last
        refresh."""
        stats = self.mgr.cache_stats
        pushed = self._prefix_pushed

        def delta(key):
            return stats.get(key, 0) - pushed.get(key, 0)

        _PREFIX_HITS.inc(delta("hit_blocks"))
        _PREFIX_EVICTIONS.inc(delta("evictions"))
        _PREFIX_TOKEN_HITS.inc(delta("token_hits"))
        _PREFIX_PARTIAL_HITS.inc(delta("partial_hits"))
        self._prefix_pushed = dict(stats)
        _PREFIX_HIT_RATE.set(stats.get("hit_blocks", 0)
                             / max(stats.get("lookup_blocks", 0), 1))
        if stats.get("lookup_tokens", 0):
            _PREFIX_TOKEN_HIT_RATE.set(stats["token_hits"]
                                       / stats["lookup_tokens"])
