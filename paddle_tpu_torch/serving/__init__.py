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
"""
from paddle_tpu_torch.serving.degrade import (  # noqa: F401
    DegradationController, SessionSnapshot, default_signals)
from paddle_tpu_torch.serving.engine import LLMEngine  # noqa: F401
from paddle_tpu_torch.serving.executor import ModelExecutor  # noqa: F401
from paddle_tpu_torch.serving.kv import KVManager  # noqa: F401
from paddle_tpu_torch.serving.router import Replica, Router  # noqa: F401
from paddle_tpu_torch.serving.scheduler import Scheduler  # noqa: F401
from paddle_tpu_torch.serving.transfer import (  # noqa: F401
    DeviceKVTransfer, KVPayload, KVTransfer, KVTransferError,
    TransportPolicy, validate_payload)
from paddle_tpu_torch.serving.types import (  # noqa: F401
    EngineDrainingError, OverloadError, QueueFullError, Request)

__all__ = ["LLMEngine", "Request", "QueueFullError", "EngineDrainingError",
           "OverloadError", "Router", "Replica", "Scheduler", "KVManager",
           "ModelExecutor", "KVTransfer", "DeviceKVTransfer", "KVPayload",
           "KVTransferError", "TransportPolicy", "validate_payload",
           "DegradationController", "SessionSnapshot", "default_signals"]
