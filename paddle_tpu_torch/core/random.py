"""Seeded generators (counterpart of ``paddle_tpu/core/random.py``).

JAX threads explicit keys; the port threads explicit
``torch.Generator``s, one per consumer, each made from a seed on the
device it draws on. The two frameworks give different numbers from the
same seed, so parity tests make their inputs with numpy and hand them to
both packages.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.device import resolve_device


def generator(seed: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` seeded with ``seed`` on ``device``: the card
    when none is named (raises without one), ``"cpu"`` when asked."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
