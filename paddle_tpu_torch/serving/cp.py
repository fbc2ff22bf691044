"""Context-parallel serving instruments — counterpart of
``paddle_tpu/serving/cp.py``.

Apart from ``telemetry.py``: ``LLMEngine`` imports this module only for
``cp > 1``, so a cp = 1 engine never registers (or exports) the cp family.

``serving_cp_shard_blocks`` is derived on the host: the pool is split
contiguously — shard ``s`` owns the global block ids ``[s·per, (s+1)·per)``
with ``per = num_blocks // cp`` — so a block manager's allocated ids bucket
into per-shard occupancy without touching the device.
"""
from __future__ import annotations

from paddle_tpu_torch.observability import METRICS

_CP_AXIS = METRICS.gauge(
    "serving_cp_axis_size",
    "context-parallel axis size of the serving engine (1 = cp disabled)")
_CP_SHARD_BLOCKS = METRICS.gauge(
    "serving_cp_shard_blocks",
    "allocated KV blocks resident on each cp shard (contiguous split: "
    "shard s owns global ids [s*per, (s+1)*per))", labelnames=("shard",))
_CP_GATHER_S = METRICS.histogram(
    "serving_cp_gather_seconds",
    "wall time of one cp>1 decode tick — the forward whose cp-added cost "
    "over the cp=1 baseline is the cross-shard partial merge (the "
    "all-reduces of the per-layer online-softmax triple)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))


def shard_occupancy(allocated_ids, num_blocks: int, cp: int) -> list[int]:
    """Bucket allocated GLOBAL block ids into per-shard counts under the
    contiguous split. ``allocated_ids`` is any iterable of ints."""
    per = num_blocks // cp
    counts = [0] * cp
    for b in allocated_ids:
        s = int(b) // per
        if 0 <= s < cp:
            counts[s] += 1
    return counts
