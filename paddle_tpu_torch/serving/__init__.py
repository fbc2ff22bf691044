"""LLM serving — counterpart of ``paddle_tpu/serving`` (single device):

  * :mod:`.engine`    — ``LLMEngine``, the orchestrator
  * :mod:`.scheduler` — admission/deadlines/preemption/backpressure
  * :mod:`.kv`        — block tables, radix prefix cache, reservations
  * :mod:`.executor`  — the prefill/chunk/decode forwards on the device
  * :mod:`.types`     — ``Request`` and the intake errors (copied)
  * :mod:`.degrade`   — the degradation ladder (copied)
"""
from paddle_tpu_torch.serving.degrade import (  # noqa: F401
    DegradationController, SessionSnapshot, default_signals)
from paddle_tpu_torch.serving.engine import LLMEngine  # noqa: F401
from paddle_tpu_torch.serving.executor import ModelExecutor  # noqa: F401
from paddle_tpu_torch.serving.kv import KVManager  # noqa: F401
from paddle_tpu_torch.serving.scheduler import Scheduler  # noqa: F401
from paddle_tpu_torch.serving.types import (  # noqa: F401
    EngineDrainingError, OverloadError, QueueFullError, Request)

__all__ = ["LLMEngine", "Request", "QueueFullError", "EngineDrainingError",
           "OverloadError", "Scheduler", "KVManager", "ModelExecutor",
           "DegradationController", "SessionSnapshot", "default_signals"]
