"""The peak-FLOPs table — counterpart of
``paddle_tpu/observability/flops.py`` (its train-MFU gauges are left out:
the port's serving roofline is the table's one reader). The table gains
the H100's row, keyed on the name the card reports; a device whose kind
no row names reads 0.0 ("undefined"), exactly as the reference's does
off-TPU.
"""
from __future__ import annotations

import torch

__all__ = ["PEAK_BF16", "chip_peak_flops", "device_kind"]

# Peak dense bf16 FLOP/s per device, keyed on the device's kind string
# (``torch.cuda.get_device_name`` for a card). The TPU rows are the
# reference's, kept so a kind means the same thing in both packages; the
# port's serving MFU divides by the card's row.
PEAK_BF16 = {
    "TPU v5 lite": 197e12,   # v5e
    "TPU v5e": 197e12,
    "TPU v5p": 459e12,
    "TPU v4": 275e12,
    "TPU v6": 918e12,
    "NVIDIA H100 80GB HBM3": 989e12,   # SXM, dense bf16 tensor cores
}


def device_kind(dev) -> tuple:
    """(kind, platform) of a device: a ``torch.device`` (or its string)
    of type cuda reads ``torch.cuda.get_device_name``, platform "gpu";
    any other torch device is (its type, its type); another object is
    duck-typed on ``device_kind`` / ``platform`` as in the reference;
    None is ("", "")."""
    if dev is None:
        return "", ""
    if isinstance(dev, str):
        dev = torch.device(dev)
    if isinstance(dev, torch.device):
        if dev.type == "cuda":
            return torch.cuda.get_device_name(dev), "gpu"
        return dev.type, dev.type
    return (getattr(dev, "device_kind", "") or "",
            getattr(dev, "platform", "") or "")


def _lookup(table: dict, dev, kind) -> float:
    """The table's peak for a device (or an explicit kind string): a row
    whose key the kind starts with or contains. An unrecognised kind
    that names a TPU takes the v5e row, as in the reference; anything
    else — the CPU, another card, a mock with no attributes — reads 0.0,
    "undefined", never a made-up number."""
    platform = None
    if kind is None:
        kind, platform = device_kind(dev)
        if platform and platform not in ("tpu", "gpu"):
            return 0.0
    for k, v in table.items():
        if kind.startswith(k) or k in kind:
            return v
    if "TPU" in kind.upper() or (kind == "" and platform == "tpu"):
        return table["TPU v5e"]
    return 0.0


def chip_peak_flops(dev=None, kind: str = None) -> float:
    """Peak dense bf16 FLOP/s of a device (a torch device, or an explicit
    kind string); 0.0 when unknown."""
    return _lookup(PEAK_BF16, dev, kind)
