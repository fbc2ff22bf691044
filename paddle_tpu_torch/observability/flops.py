"""The peak-FLOPs table and MFU accounting — counterpart of
``paddle_tpu/observability/flops.py``: the one copy the serving roofline,
the Trainer and ``utils.profiler.StepTimer`` read. The table gains the
H100's row, keyed on the name the card reports; a device whose kind no
row names reads 0.0 ("undefined"), exactly as the reference's does
off-TPU.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.observability.metrics import METRICS

__all__ = ["PEAK_BF16", "chip_peak_flops", "device_kind", "mfu",
           "record_throughput"]

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


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak_flops: float) -> float:
    """Model FLOPs utilisation; 0.0 when the peak is unknown."""
    if not peak_flops or not flops_per_token:
        return 0.0
    return tokens_per_sec * flops_per_token / peak_flops


_TOKENS_PER_SEC = METRICS.gauge(
    "train_tokens_per_sec", "training throughput, tokens/sec")
_MFU = METRICS.gauge(
    "train_mfu", "model FLOPs utilisation vs the device's peak-bf16 row")
_MFU_OVERLAP = METRICS.gauge(
    "train_mfu_overlap", "MFU with host time hidden behind in-flight "
    "device steps subtracted from the wall-clock denominator")


def record_throughput(tokens_per_sec: float, flops_per_token: float = 0.0,
                      peak_flops: float = 0.0, hidden_host_s: float = 0.0,
                      window_s: float = 0.0) -> float:
    """The one choke point for throughput/MFU accounting: sets the
    ``train_tokens_per_sec``, ``train_mfu`` and ``train_mfu_overlap``
    gauges and returns the (naive) MFU. ``hidden_host_s`` of a
    ``window_s``-second logging window is host input/dispatch time that
    rode in the shadow of in-flight device steps (the pipelined trainer
    measures it); the overlap-aware MFU removes it from the denominator,
    ``mfu(tps * window / (window - hidden), ...)``. Without overlap
    information the overlap gauge mirrors the naive value."""
    m = mfu(tokens_per_sec, flops_per_token, peak_flops)
    if window_s > 0.0 and 0.0 < hidden_host_s < window_s:
        m_ov = mfu(tokens_per_sec * window_s / (window_s - hidden_host_s),
                   flops_per_token, peak_flops)
    else:
        m_ov = m
    _TOKENS_PER_SEC.set(tokens_per_sec)
    _MFU.set(m)
    _MFU_OVERLAP.set(m_ov)
    return m
