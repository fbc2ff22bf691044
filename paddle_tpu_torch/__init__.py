"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, with the same layout and names, so
each module here has its counterpart at the same path under
``paddle_tpu/``. It imports ``torch`` and never ``jax`` nor anything of
``paddle_tpu``. Every Pallas kernel on a ported path has a hand-written
CUDA kernel for Hopper (``sm_90a``) under ``csrc/``, built at first use
by :mod:`paddle_tpu_torch.ops.cuda._build`; plain PyTorch code covers
what XLA fused for free.

Entry points (the model classes, ``serving.LLMEngine``,
``train.make_train_step``, ``train.Trainer``, ``io.prefetch_to_device``)
run on ``cuda`` unless the caller passes ``device="cpu"``; with no device
given and no card present they raise.

Ported so far: the single-device paged serving path and the train step
(``train``, ``optimizer``) for the Llama family and the MoE families
(``models.mixtral``, ``models.qwen2_moe``, ``models.moe_llm`` on
``distributed.moe``), and BLOOM and Falcon (``models.bloom``,
``models.falcon``) through ``models.generic_generate`` and the same train
step, and the trainer stack around it (``train.Trainer``, checkpoints,
``ElasticRunner``, ``io``, ``amp``, adapter-only LoRA training), and
its distribution over a hybrid mesh of processes (``distributed``: dp,
fsdp, tp, the 1F1B and zero-bubble pipeline, fleet, launch) — see
``ROADMAP.md`` for the queues that remain.
"""
from paddle_tpu_torch.core.device import resolve_device  # noqa: F401
from paddle_tpu_torch.core.random import generator  # noqa: F401

__all__ = ["resolve_device", "generator"]
