"""KV handoff between engine replicas (disaggregated prefill/decode) —
counterpart of ``paddle_tpu/serving/transfer.py``.

A prefill-role replica runs admission and (chunked) prefill; its
finished sequences move to a decode-role replica. The unit of transfer
is a :class:`KVPayload`: the sequence's KV blocks gathered out of the
source pool into a dense ``[L, n_blocks, block_size, H_kv, D]`` tensor
pair (int8 pools add their ``[L, n_blocks, block_size, H_kv]`` fp32
scale rows), plus the host bookkeeping a decode replica needs to resume
bit-exactly (cur / gen / last_tok).

Where the reference gathers ``max_blocks_per_seq`` rows (a fixed shape,
so its jitted gather never recompiles), the port gathers only the
``n_blocks`` rows the sequence holds: eager torch indexing has no shape
to keep, and at Llama-2-7B width with 32 blocks a sequence the padded
payload would carry 268 MB, mostly copies of block 0. The gather
(``LLMEngine.extract_sequence``) and the install
(``LLMEngine.install_sequence``, ``index_copy_`` into the target's pools
in place) are torch indexing on the card: the reference's are XLA jits,
not Pallas kernels.

:class:`KVTransfer` is the seam a multi-host wire plugs into; the
in-process :class:`DeviceKVTransfer` moves the tensors onto the target
pool's device (a no-op when both replicas share the card).

The handoff is hardened against a lossy wire: the source engine seals
each payload (:meth:`KVPayload.seal`) with its geometry and per-tensor
checksums, and the router runs :func:`validate_payload` on the shipped
copy before install. A truncated or corrupted transfer raises
:class:`KVTransferError` and is retried from the pristine source payload
under a :class:`TransportPolicy` (deadline, bounded exponential
backoff, straggler hedging to another decode replica).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from paddle_tpu_torch.serving.types import Request


class KVTransferError(RuntimeError):
    """A shipped payload failed geometry/checksum validation — a partial
    or corrupted transfer. The handoff is retried from the pristine source
    payload; the rejected copy is never installed."""


def _tensor_checksum(x) -> float:
    """Order-independent content checksum: the f32 sum of all elements
    (one reduction and one fetch). Any zeroed or truncated block row of
    real KV activations moves it far past tolerance."""
    return float(x.sum(dtype=torch.float32))


@dataclass
class KVPayload:
    """One prefilled sequence in flight between replicas."""
    req: Request
    cur: int                 # tokens stored in the source cache
    gen: int                 # tokens generated so far (1 after prefill)
    last_tok: int            # sampled but not yet written to cache
    n_blocks: int            # rows of k/v (the sequence's blocks)
    block_size: int
    k: object                # [L, n_blocks, block_size, H_kv, D]
    v: object
    # int8 pools: the codes above mean nothing without their per-
    # (position, KV head) scales, which ride the same wire as [L,
    # n_blocks, block_size, H_kv] fp32 (None for a pool of the model's
    # type)
    k_scale: object = None
    v_scale: object = None
    # filled by seal(): what the payload looked like when it left the
    # source pool — validate_payload checks the shipped copy against it
    expect: dict = None

    @property
    def tokens_bytes(self):
        n = (self.k.numel() * self.k.element_size()
             + self.v.numel() * self.v.element_size())
        if self.k_scale is not None:
            n += (self.k_scale.numel() * self.k_scale.element_size()
                  + self.v_scale.numel() * self.v_scale.element_size())
        return n

    def seal(self):
        """Record the wire contract at the source: geometry and content
        checksums (the scales' too for an int8 payload — a corrupted scale
        row silently rescales whole positions). Called once by
        ``extract_sequence`` before the payload leaves the engine."""
        self.expect = {
            "shape": tuple(self.k.shape),
            "cur": self.cur,
            "n_blocks": self.n_blocks,
            "ksum": _tensor_checksum(self.k),
            "vsum": _tensor_checksum(self.v),
            "quant": self.k_scale is not None,
        }
        if self.k_scale is not None:
            self.expect["kssum"] = _tensor_checksum(self.k_scale)
            self.expect["vssum"] = _tensor_checksum(self.v_scale)
        return self


def validate_payload(payload: KVPayload, target_engine) -> KVPayload:
    """Reject partial or corrupt transfers before they touch the target
    pool. Geometry is checked against both the seal and the target
    engine; checksums against the seal (the tolerance covers f32
    summation order, not content). An unsealed payload (hand-built, or a
    custom transport that re-packs) gets the geometry checks only."""
    k, v = payload.k, payload.v
    cache = target_engine.cache
    pool = cache.k_pools[0]
    if tuple(k.shape) != tuple(v.shape):
        raise KVTransferError(
            f"k/v geometry diverged in flight: {tuple(k.shape)} vs "
            f"{tuple(v.shape)}")
    if k.shape[0] != len(cache.k_store) \
            or tuple(k.shape[2:]) != tuple(pool.shape[1:]):
        raise KVTransferError(
            f"payload geometry {tuple(k.shape)} does not match the "
            f"target pool [{len(cache.k_store)}, *, "
            f"{tuple(pool.shape[1:])}]")
    if payload.n_blocks * payload.block_size < payload.cur:
        raise KVTransferError(
            f"payload truncated: {payload.n_blocks} blocks × "
            f"{payload.block_size} cannot cover cur={payload.cur}")
    # an int8 pool takes int8 codes WITH their scales; a payload of the
    # model's type must not target one
    quant_target = bool(cache.k_scale_store)
    quant_payload = payload.k_scale is not None
    if quant_target != quant_payload:
        raise KVTransferError(
            f"KV dtype mismatch: payload is "
            f"{'int8+scales' if quant_payload else 'model-dtype'} but the "
            f"target pool is "
            f"{'int8+scales' if quant_target else 'model-dtype'} — "
            "replicas in one handoff group must share kv_dtype")
    if k.dtype != pool.dtype:
        raise KVTransferError(
            f"payload element dtype {k.dtype} != target pool dtype "
            f"{pool.dtype}")
    if quant_payload and (tuple(payload.k_scale.shape) != tuple(k.shape[:4])
                          or tuple(payload.v_scale.shape)
                          != tuple(v.shape[:4])):
        raise KVTransferError(
            f"scale geometry {tuple(payload.k_scale.shape)} does not "
            f"match the code blocks {tuple(k.shape[:4])}")
    exp = payload.expect
    if exp is not None:
        if (tuple(k.shape) != exp["shape"] or payload.cur != exp["cur"]
                or payload.n_blocks != exp["n_blocks"]):
            raise KVTransferError(
                f"payload drifted from its seal: shape={tuple(k.shape)} "
                f"cur={payload.cur} n_blocks={payload.n_blocks}, sealed "
                f"{exp['shape']}/{exp['cur']}/{exp['n_blocks']}")
        if exp.get("quant", False) != quant_payload:
            raise KVTransferError(
                "payload quantization drifted from its seal (scales "
                "added or dropped in flight)")
        checks = [(k, exp["ksum"], "k"), (v, exp["vsum"], "v")]
        if quant_payload:
            checks += [(payload.k_scale, exp["kssum"], "k-scale"),
                       (payload.v_scale, exp["vssum"], "v-scale")]
        for x, want, name in checks:
            got = _tensor_checksum(x)
            if abs(got - want) > 1e-3 * max(1.0, abs(want)):
                raise KVTransferError(
                    f"{name}-checksum mismatch (partial/corrupt "
                    f"transfer): got {got!r}, sealed {want!r}")
    return payload


class TransportPolicy:
    """Retry/deadline/hedging policy for one handoff delivery.

    ``deadline_s=None`` derives the straggler deadline from live data:
    ``deadline_margin ×`` the p95 of ``router_kv_transfer_seconds``
    (floored at ``min_deadline_s``), once at least ``min_samples``
    deliveries have been observed — before that there is no deadline and
    no hedging, so cold starts never hedge on noise. Retries use bounded
    exponential backoff through the injectable ``sleep``."""

    def __init__(self, *, deadline_s: float = None,
                 deadline_margin: float = 3.0,
                 min_deadline_s: float = 0.05, min_samples: int = 8,
                 max_attempts: int = 3, backoff_base_s: float = 0.005,
                 backoff_max_s: float = 0.1, hedge: bool = True,
                 sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.deadline_s = deadline_s
        self.deadline_margin = deadline_margin
        self.min_deadline_s = min_deadline_s
        self.min_samples = min_samples
        self.max_attempts = max_attempts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.hedge = hedge
        self.sleep = sleep

    def backoff_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt+1`` (attempt is 0-based)."""
        return min(self.backoff_base_s * (2 ** attempt), self.backoff_max_s)

    def deadline(self, hist) -> float:
        """The straggler deadline, or None while underinformed."""
        if self.deadline_s is not None:
            return self.deadline_s
        count = sum(s.count for s in hist._series.values())
        if count < self.min_samples:
            return None
        p95 = hist.quantile(0.95)
        if p95 != p95:                       # NaN: no data
            return None
        return max(self.min_deadline_s, self.deadline_margin * p95)


class KVTransfer:
    """Moves a payload's tensors onto the target replica's device. The
    base class is the identity wire (same process, same device) — a
    multi-host deployment subclasses ``ship`` with its transport;
    everything above this seam is transport-agnostic."""

    def ship(self, payload: KVPayload, target_engine) -> KVPayload:
        return payload


class DeviceKVTransfer(KVTransfer):
    """In-process device-to-device copy: place the gathered blocks on the
    device that holds the target engine's pool (a peer copy between two
    cards, a no-op when both replicas share one)."""

    def ship(self, payload: KVPayload, target_engine) -> KVPayload:
        dev = target_engine.cache.device
        payload.k = payload.k.to(dev)
        payload.v = payload.v.to(dev)
        if payload.k_scale is not None:
            payload.k_scale = payload.k_scale.to(dev)
            payload.v_scale = payload.v_scale.to(dev)
        return payload
