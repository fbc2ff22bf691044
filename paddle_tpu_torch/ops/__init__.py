"""Fused/accelerated ops — counterpart of ``paddle_tpu/ops/__init__.py``.

The reference picks its Pallas kernel only on a TPU, only for some
widths, and falls back silently on any exception. Here the dispatch is
the tensor's device and nothing else: a CUDA tensor goes to the kernel
at every width (or the kernel raises), a CPU tensor to its plain version.
"""
from __future__ import annotations

from paddle_tpu_torch.ops.attention import (  # noqa: F401
    apply_rope, apply_rope_interleaved, eager_attention,
    fused_rotary_position_embedding, rope_cos_sin,
    scaled_dot_product_attention)
from paddle_tpu_torch.ops.cuda import norms as _norms


def fused_rms_norm(x, weight=None, epsilon=1e-6):
    """K1 on a CUDA tensor, its plain version on a CPU tensor. ``weight``
    None normalises with a unit weight, as the reference's does."""
    return _norms.rms_norm(x, weight, epsilon)
