"""Device resolution (counterpart of ``paddle_tpu/core/device.py``).

The JAX package selects a process-global platform; here every entry
point takes an explicit ``device``. The default is the card: with no
device given and no CUDA device present, :func:`resolve_device` raises
instead of carrying on on the CPU. Tests pass ``device="cpu"``, which
runs each kernel's plain PyTorch version.

:data:`CAPTURE_LOCK` keeps CUDA graph captures apart from the other
threads' CUDA calls. A capture in PyTorch's default ("global") mode is
invalidated by a CUDA API call that another thread makes while it runs
(an allocation, a synchronisation, the profiler turning CUPTI on). The
executor holds the lock across each capture; the metrics endpoints and
the shipper hold it across their device-memory queries, and a
``/profile`` capture across its whole window, so none of them runs
while a graph is being captured.
"""
from __future__ import annotations

import threading

import torch

CAPTURE_LOCK = threading.RLock()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is
    taken as asked, and a CUDA device that is not there raises too."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; paddle_tpu_torch runs on the card "
            "unless the caller passes device='cpu' (the plain PyTorch path)")
    return dev
