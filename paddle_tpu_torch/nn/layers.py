"""Layers of ``paddle_tpu/nn/layers.py`` that the ported models use.

Parameters keep the reference's names (``weight``, ``bias``) and are made
on the caller's device and dtype, so ``models.convert.load_jax_state_dict``
fills them name for name.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.nn import functional as F


class LayerNorm(nn.Module):
    """``paddle_tpu.nn.LayerNorm``: weight 1 and bias 0 at init;
    ``weight_attr=False`` / ``bias_attr=False`` leave that parameter
    ``None``, as in the reference. ``device=None`` is the card."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=True,
                 bias_attr=True, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape))
        self.weight = (nn.Parameter(torch.ones(shape, dtype=dtype,
                                               device=device))
                       if weight_attr else None)
        self.bias = (nn.Parameter(torch.zeros(shape, dtype=dtype,
                                              device=device))
                     if bias_attr else None)
        self.normalized_shape, self.epsilon = shape, epsilon

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)
