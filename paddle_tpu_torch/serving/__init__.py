"""LLM serving — counterpart of ``paddle_tpu/serving``:

  * :mod:`.engine`    — ``LLMEngine``, the orchestrator
  * :mod:`.scheduler` — admission/deadlines/preemption/backpressure
  * :mod:`.kv`        — block tables, radix prefix cache, reservations
  * :mod:`.executor`  — the prefill/chunk/decode forwards on the device
  * :mod:`.router`    — LOR dispatch over N replicas, session affinity,
                        health gating, disaggregated prefill/decode
  * :mod:`.transfer`  — the sealed KV handoff between replicas
  * :mod:`.types`     — ``Request`` and the intake errors (copied)
  * :mod:`.degrade`   — the degradation ladder (copied)
  * :mod:`.adapters`  — the multi-tenant LoRA adapter store
  * :mod:`.grammar`   — token-mask automata for constrained decoding

Everything the reference's ``paddle_tpu.serving`` re-exports from a
module the port has is re-exported here too, so imports written against
the reference resolve (``tests/test_torch_exports.py``).
"""
from paddle_tpu_torch.models.decoding import KVCache, _sample_rows  # noqa: F401
from paddle_tpu_torch.models.paged import (  # noqa: F401
    PagedKVCache, PrefixCachingBlockManager, PrefixMatch,
    RadixPrefixBlockManager, _beam_finalize, greedy_accept_length,
    is_moe_model, stochastic_accept_row)
from paddle_tpu_torch.observability import METRICS, span as _span  # noqa: F401
from paddle_tpu_torch.observability.flight import FLIGHT  # noqa: F401
from paddle_tpu_torch.utils.faults import fault_point  # noqa: F401

from paddle_tpu_torch.serving.adapters import AdapterStore  # noqa: F401
from paddle_tpu_torch.serving.degrade import (  # noqa: F401
    DegradationController, SessionSnapshot, default_signals)
from paddle_tpu_torch.serving.engine import LLMEngine  # noqa: F401
from paddle_tpu_torch.serving.executor import ModelExecutor  # noqa: F401
from paddle_tpu_torch.serving.grammar import (  # noqa: F401
    TokenMaskAutomaton, json_schema_regex)
from paddle_tpu_torch.serving.kv import KVManager  # noqa: F401
from paddle_tpu_torch.serving.router import Replica, Router  # noqa: F401
from paddle_tpu_torch.serving.scheduler import Scheduler  # noqa: F401
from paddle_tpu_torch.serving.telemetry import (  # noqa: F401
    _ACTIVE_SLOTS, _ADMITTED, _CANCELLED, _DRAIN, _FINISHED, _KV_IN_USE,
    _KV_UTIL, _PREEMPTED, _PREFIX_EVICTIONS, _PREFIX_HIT_RATE,
    _PREFIX_HITS, _QUEUE_DEPTH, _QUEUE_WAIT, _R_DEATHS, _R_DISPATCH,
    _R_HEALTH, _R_OUTSTANDING, _R_REQUEUES, _R_TRANSFER_BLOCKS,
    _R_TRANSFERS, _REJECTED, _SPEC_ACCEPTED, _SPEC_FALLBACKS,
    _SPEC_PROPOSED, _SPEC_RATE, _SPEC_TOKENS, _TICK, _TIMEOUTS, _TOK_LAT,
    _TOKENS, _TTFT)
from paddle_tpu_torch.serving.transfer import (  # noqa: F401
    DeviceKVTransfer, KVPayload, KVTransfer, KVTransferError,
    TransportPolicy, validate_payload)
from paddle_tpu_torch.serving.types import (  # noqa: F401
    EngineDrainingError, OverloadError, QueueFullError, Request,
    _BeamGroup)

__all__ = ["LLMEngine", "Request", "QueueFullError", "EngineDrainingError",
           "OverloadError", "Router", "Replica", "Scheduler", "KVManager",
           "ModelExecutor", "KVTransfer", "DeviceKVTransfer", "KVPayload",
           "KVTransferError", "TransportPolicy", "validate_payload",
           "DegradationController", "SessionSnapshot", "default_signals",
           "AdapterStore", "TokenMaskAutomaton", "json_schema_regex"]
