"""Layers of ``paddle_tpu/nn/layers.py`` that the ported models and the
QAT/PTQ API (``quantization.py``) use.

Parameters keep the reference's names (``weight``, ``bias``) and layouts
(``Linear.weight`` is ``[in, out]``, ``Embedding.weight`` ``[num,
dim]``) and are made on the caller's device and dtype, so
``models.convert.load_jax_state_dict`` fills them name for name. A
layer draws its random weight from ``generator`` when one is passed (a
model's layers share one, so no two draw the same numbers), else from a
fresh generator seeded with ``seed``. The rest of ``nn/`` is ROADMAP.md
queue 1 item 8.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.nn import functional as F


def init_generator(device, seed, gen=None):
    """(``device`` resolved — the card when None —, ``gen`` or a fresh
    generator seeded with ``seed`` on it): where a layer or model draws
    its random weights. A model passes one generator to all its layers."""
    device = resolve_device(device)
    return device, gen if gen is not None else generator(seed, device)


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` ``[in, out]`` (the reference's layout).
    Xavier-normal weight drawn on ``device`` (the card when none is named)
    from ``generator`` or ``seed``, zero bias; ``bias_attr=False`` leaves
    ``bias`` None."""

    def __init__(self, in_features: int, out_features: int, bias_attr=True,
                 dtype=torch.float32, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        std = math.sqrt(2.0 / (in_features + out_features))
        w = torch.empty((in_features, out_features), dtype=dtype,
                        device=device)
        w.normal_(0.0, std, generator=gen)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if bias_attr else None)
        self.in_features, self.out_features = in_features, out_features

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """``paddle_tpu.nn.Embedding``: a ``[num_embeddings, embedding_dim]``
    table read by index (``weight[x]``); the rows of ``padding_idx`` read
    as zeros. Normal(0, ``std``) weight (the reference's default std 1;
    the encoders pass their ``initializer_range``), drawn on ``device``
    (the card when none is named) from ``generator`` or ``seed``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, std: float = 1.0, dtype=torch.float32,
                 device=None, seed: int = 0, generator=None):
        super().__init__()
        device, gen = init_generator(device, seed, generator)
        w = torch.empty((num_embeddings, embedding_dim), dtype=dtype,
                        device=device)
        w.normal_(0.0, std, generator=gen)
        self.weight = nn.Parameter(w)
        self.padding_idx = padding_idx
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class ReLU(nn.Module):
    def forward(self, x):
        return torch.relu(x)


class LayerList(nn.Module):
    """The reference's list container: its sublayers in ``layers`` (an
    ``nn.ModuleList``, so parameter names read ``layers.<i>.``, as the
    reference's do), indexed and iterated like a list."""

    def __init__(self, layers=()):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def __getitem__(self, idx):
        return self.layers[idx]

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        return iter(self.layers)

    def append(self, layer):
        self.layers.append(layer)

    def extend(self, layers):
        self.layers.extend(layers)


class Sequential(LayerList):
    """The reference's container: a ``LayerList`` of its sublayers,
    applied in order."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        super().__init__(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Dropout(nn.Module):
    """``paddle_tpu.nn.Dropout``: :func:`~.functional.dropout` while the
    module is training. ``forward(x, generator=None, keep=None)``: the
    mask is drawn from ``generator`` (the reference's ``rng``), or is
    ``keep``."""

    def __init__(self, p=0.5, axis=None):
        super().__init__()
        self.p, self.axis = p, axis

    def forward(self, x, generator=None, keep=None):
        return F.dropout(x, self.p, training=self.training,
                         generator=generator, axis=self.axis, keep=keep)


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
