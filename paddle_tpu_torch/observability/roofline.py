"""Serving roofline ledger — counterpart of
``paddle_tpu/observability/roofline.py``: per-phase FLOPs *and* bytes.

Decode at continuous-batching sizes streams the whole weight set plus
every cached KV position per emitted token, so it pins the memory roof
long before the compute roof, and MFU alone cannot say whether the
decode tick runs at the hardware's speed (Williams et al., "Roofline",
CACM 2009). Every serving phase gets THREE numbers:

  * ``serving_mfu{phase}``              — FLOPs/s vs the device's bf16 peak
  * ``serving_mbu{phase}``              — bytes/s vs its memory peak
  * ``serving_arith_intensity{phase}``  — FLOPs/byte

Phases are the engine tick's anatomy: ``prefill`` (admission + chunked
prefill forwards), ``decode`` (the one-token tick), ``spec_draft``
(draft-model feeds), ``spec_verify`` (the batched (slots, k+1) target
chunk). The engine accumulates per-phase seconds / tokens / weight
passes / KV-read positions and folds them through
:func:`record_serving_throughput` at every gauge sweep.

The peaks resolve from the torch device: the card's name
(``torch.cuda.get_device_name``) keys :data:`PEAK_HBM_BPS` and
``flops.PEAK_BF16``; an unknown device (the CPU, another card) yields
peak 0.0, and every utilisation gauge then reads 0.0 = "undefined",
never a fabricated number. ``PT_ROOFLINE_KIND`` overrides the detected
kind.

Bytes model scope: weights (every resident weight streamed once per
forward — all experts for MoE), KV reads (2 x kv_heads x head_dim per
layer per attended position; the engine counts decode positions
block-rounded because the paged decode kernel reads whole blocks), KV
writes (one position per token), and fp32 logits. Activations are left
out.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, asdict

from paddle_tpu_torch.observability.flops import (PEAK_BF16, _lookup,
                                                  chip_peak_flops)
from paddle_tpu_torch.observability.metrics import METRICS

__all__ = ["PEAK_HBM_BPS", "chip_peak_hbm_bw", "resolve_serving_peaks",
           "ModelGeometry", "weight_bytes", "kv_bytes_per_position",
           "phase_flops", "phase_bytes", "arith_intensity",
           "roofline_verdict", "record_serving_throughput",
           "serving_roofline_report", "reset_serving_roofline"]

# Peak memory bandwidth per device, bytes/sec — the denominator of MBU,
# keyed exactly like PEAK_BF16 so the two tables can never disagree about
# what a device is. The TPU rows are the reference's.
PEAK_HBM_BPS = {
    "TPU v5 lite": 819e9,    # v5e
    "TPU v5e": 819e9,
    "TPU v5p": 2765e9,
    "TPU v4": 1228e9,
    "TPU v6": 1640e9,
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM, HBM3
}

assert set(PEAK_HBM_BPS) == set(PEAK_BF16), \
    "PEAK_HBM_BPS and PEAK_BF16 must cover the same chips"


def chip_peak_hbm_bw(dev=None, kind: str = None) -> float:
    """Peak memory bytes/sec of a device (a torch device, or an explicit
    kind string); 0.0 when unknown ("MBU undefined")."""
    return _lookup(PEAK_HBM_BPS, dev, kind)


def resolve_serving_peaks(dev=None) -> tuple:
    """(peak_flops, peak_hbm_bps) of the torch device ``dev`` for the
    serving roofline. ``PT_ROOFLINE_KIND`` (a kind string, e.g. ``NVIDIA
    H100 80GB HBM3``) overrides the detected device — what-if analysis,
    and the only way to exercise a device's arithmetic in a CPU test
    without fabricating utilisation by default."""
    kind = os.environ.get("PT_ROOFLINE_KIND")
    if kind:
        return chip_peak_flops(kind=kind), chip_peak_hbm_bw(kind=kind)
    return chip_peak_flops(dev), chip_peak_hbm_bw(dev)


@dataclass(frozen=True)
class ModelGeometry:
    """The shape facts the FLOPs/bytes models need — duck-typed off any
    of the port's LLM configs via :meth:`from_config`, never a live
    model."""
    num_layers: int
    hidden: int
    intermediate: int
    vocab: int
    heads: int
    kv_heads: int
    head_dim: int
    dtype_bytes: int = 2          # bf16 weights and KV
    num_experts: int = 0          # routed experts (0 = dense MLP)
    experts_per_tok: int = 0
    # quantized serving — actual storage dtypes, so an int8
    # pool or weight-only model is not billed at bf16 (which would
    # double its bytes and overstate MBU). 0 = inherit dtype_bytes.
    kv_dtype_bytes: int = 0       # bytes per cached KV element
    kv_scale_bytes: int = 0       # extra bytes per (position, kv-head)
    weight_dtype_bytes: float = 0.0   # 1.0 int8, 0.5 packed int4
    # context-parallel serving — cp>1 means every decode
    # token pays a cross-shard partial merge (psum of the online-softmax
    # (o, m, l) triple per layer); billed as extra bytes so
    # serving_mbu{decode} stays honest about the per-step gather cost.
    cp: int = 1

    @classmethod
    def from_config(cls, cfg, dtype_bytes: int = 2) -> "ModelGeometry":
        h = int(cfg.hidden_size)
        nh = int(cfg.num_attention_heads)
        experts = int(getattr(cfg, "num_experts", 0)
                      or getattr(cfg, "num_local_experts", 0) or 0)
        per_tok = int(getattr(cfg, "num_experts_per_tok", 0)
                      or getattr(cfg, "experts_per_tok", 0) or 0)
        inter = int(getattr(cfg, "moe_intermediate_size", 0)
                    or cfg.intermediate_size)
        return cls(num_layers=int(cfg.num_hidden_layers), hidden=h,
                   intermediate=inter, vocab=int(cfg.vocab_size), heads=nh,
                   kv_heads=int(getattr(cfg, "num_key_value_heads", nh)),
                   head_dim=h // nh, dtype_bytes=int(dtype_bytes),
                   num_experts=experts, experts_per_tok=per_tok)

    # ---- derived counts -------------------------------------------------
    @property
    def attn_params_per_layer(self) -> int:
        """Fused qkv + output projection."""
        return (self.hidden * (self.heads + 2 * self.kv_heads)
                * self.head_dim + self.heads * self.head_dim * self.hidden)

    @property
    def mlp_params_per_expert(self) -> int:
        """gate + up + down projections of one (dense or expert) MLP."""
        return 3 * self.hidden * self.intermediate

    @property
    def activated_params(self) -> int:
        """Weight parameters ONE token's forward multiplies against:
        attention + experts_per_tok MLPs (all of the dense MLP) + head."""
        e = self.experts_per_tok if self.num_experts else 1
        return (self.num_layers * (self.attn_params_per_layer
                                   + e * self.mlp_params_per_expert)
                + self.hidden * self.vocab)

    @property
    def resident_params(self) -> int:
        """Weight parameters a batched forward streams from HBM: every
        expert is resident (the batch routes across all of them)."""
        e = self.num_experts if self.num_experts else 1
        return (self.num_layers * (self.attn_params_per_layer
                                   + e * self.mlp_params_per_expert)
                + self.hidden * self.vocab)


def weight_bytes(geom: ModelGeometry) -> float:
    """Bytes of weights one forward reads from memory (honouring
    weight-only quantization when ``weight_dtype_bytes`` is set)."""
    return float(geom.resident_params) * (geom.weight_dtype_bytes
                                          or geom.dtype_bytes)


def kv_bytes_per_position(geom: ModelGeometry) -> float:
    """K + V bytes of ONE cached position across all layers; GQA head
    grouping makes this kv_heads/heads of the MHA figure. An int8 pool
    stores head_dim codes plus a per-(position, kv-head) scale."""
    per_head = (geom.head_dim * (geom.kv_dtype_bytes or geom.dtype_bytes)
                + geom.kv_scale_bytes)
    return float(geom.num_layers * 2 * geom.kv_heads * per_head)


def phase_flops(geom: ModelGeometry, tokens: float,
                kv_read_positions: float) -> float:
    """Forward FLOPs of a phase that computed ``tokens`` token positions
    attending ``kv_read_positions`` (query, cached-position) pairs in
    total: 2 × activated params per token (matmuls), plus the qk^T and
    p·v terms — 4 × heads × head_dim FLOPs per attended pair per layer
    (2 mult-adds). The attention term rides the PAIR count, so callers
    describe causal prefill (Σ ctx per query) and single-query decode
    (whole table per token) with the same argument."""
    matmul = 2.0 * geom.activated_params * tokens
    attn = 4.0 * geom.heads * geom.head_dim * kv_read_positions
    return matmul + attn


def phase_bytes(geom: ModelGeometry, *, tokens: float, weight_passes: float,
                kv_read_positions: float) -> float:
    """Memory bytes of a phase: weights once per forward, KV reads
    per attended (query, position) pair, one KV write per computed
    token, and the f32 logits row per token."""
    w = weight_passes * weight_bytes(geom)
    kv_r = kv_read_positions * kv_bytes_per_position(geom)
    kv_w = tokens * kv_bytes_per_position(geom)
    logits = tokens * geom.vocab * 4.0
    total = w + kv_r + kv_w + logits
    if geom.cp > 1:
        # cross-shard partial merge per computed token: each member
        # psums an f32 (o [H, D], m [H], l [H]) triple per layer —
        # 2·(cp-1)/cp of it crosses the interconnect per member
        triple = geom.num_layers * geom.heads * (geom.head_dim + 2) * 4.0
        total += tokens * triple * 2.0 * (geom.cp - 1) / geom.cp
    return total


def arith_intensity(flops: float, nbytes: float) -> float:
    """FLOPs per HBM byte — the roofline x-axis."""
    return flops / nbytes if nbytes else 0.0


def roofline_verdict(intensity: float, peak_flops: float,
                     peak_hbm_bps: float) -> str:
    """Which roof the phase sits under: intensity below the machine
    balance (peak_flops / peak_hbm) means the bandwidth roof caps it."""
    if not peak_flops or not peak_hbm_bps:
        return "undefined"
    return ("compute-bound" if intensity >= peak_flops / peak_hbm_bps
            else "bandwidth-bound")


_MFU = METRICS.gauge(
    "serving_mfu",
    "per-phase model FLOPs utilisation vs the device bf16 peak "
    "(0.0 = undefined on an unknown device)", labelnames=("phase",))
_MBU = METRICS.gauge(
    "serving_mbu",
    "per-phase model bandwidth utilisation vs the device memory peak "
    "(0.0 = undefined on an unknown device)", labelnames=("phase",))
_AI = METRICS.gauge(
    "serving_arith_intensity",
    "per-phase arithmetic intensity, FLOPs per HBM byte",
    labelnames=("phase",))

# last full report per phase, served verbatim at /roofline
_REPORTS: dict = {}
_REPORTS_LOCK = threading.Lock()


def record_serving_throughput(phase: str, *, seconds: float, tokens: float,
                              weight_passes: float, kv_read_positions: float,
                              geom: ModelGeometry, peak_flops: float = 0.0,
                              peak_hbm_bps: float = 0.0) -> dict:
    """Single choke point for serving utilisation: fold one phase's
    cumulative (seconds, tokens, weight passes, KV-read positions)
    through the analytic models, set the three per-phase gauges, stash
    the full report for ``/roofline``, and return it. Unknown peaks
    (CPU, mock backends) keep MFU/MBU at 0.0 — undefined, never
    fabricated — while intensity and the byte/FLOP tallies stay real."""
    if seconds <= 0.0 or tokens <= 0:
        return {}
    fl = phase_flops(geom, tokens, kv_read_positions)
    by = phase_bytes(geom, tokens=tokens, weight_passes=weight_passes,
                     kv_read_positions=kv_read_positions)
    ai = arith_intensity(fl, by)
    mfu_v = fl / seconds / peak_flops if peak_flops else 0.0
    mbu_v = by / seconds / peak_hbm_bps if peak_hbm_bps else 0.0
    report = {
        "phase": phase, "seconds": seconds, "tokens": tokens,
        "weight_passes": weight_passes,
        "kv_read_positions": kv_read_positions,
        "flops": fl, "bytes": by,
        "flops_per_sec": fl / seconds, "bytes_per_sec": by / seconds,
        "arith_intensity": ai, "mfu": mfu_v, "mbu": mbu_v,
        "bound": roofline_verdict(ai, peak_flops, peak_hbm_bps),
        "geometry": asdict(geom),
    }
    _MFU.set(mfu_v, phase=phase)
    _MBU.set(mbu_v, phase=phase)
    _AI.set(ai, phase=phase)
    with _REPORTS_LOCK:
        _REPORTS[phase] = report
        _REPORTS["_machine"] = {
            "peak_flops": peak_flops, "peak_hbm_bps": peak_hbm_bps,
            "balance_flops_per_byte": (peak_flops / peak_hbm_bps
                                       if peak_hbm_bps else 0.0),
        }
    return report


def serving_tick_anatomy() -> dict:
    """Overlap-aware tick anatomy: cumulative wall-seconds
    per tick phase from the breakdown histogram, with host time split
    into *exposed* (the breakdown's ``host`` remainder — device idle
    while the host works) and *hidden* (host work done under an
    in-flight async dispatch, ``serving_tick_host_hidden_seconds``;
    zero for synchronous engines). ``overlap_fraction`` is the share of
    total host work the pipeline hid."""
    def _hist_sum(name, **labels):
        m = METRICS.get(name)
        if m is None:
            return 0.0
        try:
            return float(m.value(**labels)["sum"])
        except (KeyError, TypeError):
            return 0.0

    phases = {p: _hist_sum("serving_tick_breakdown_seconds", phase=p)
              for p in ("prefill", "draft", "verify", "sample", "host")}
    hidden = _hist_sum("serving_tick_host_hidden_seconds")
    exposed = phases["host"]
    host_total = exposed + hidden
    return {
        "ticks_seconds": _hist_sum("serving_tick_seconds"),
        "phases_seconds": phases,
        "host_exposed_seconds": exposed,
        "host_hidden_seconds": hidden,
        "overlap_fraction": hidden / host_total if host_total else 0.0,
    }


def serving_roofline_report() -> dict:
    """The ``/roofline`` document: machine roofs + the last per-phase
    reports the choke point recorded + the overlap-aware tick anatomy."""
    with _REPORTS_LOCK:
        machine = _REPORTS.get("_machine", {
            "peak_flops": 0.0, "peak_hbm_bps": 0.0,
            "balance_flops_per_byte": 0.0})
        phases = {k: dict(v) for k, v in _REPORTS.items()
                  if k != "_machine"}
    return {"machine": machine, "phases": phases,
            "tick_anatomy": serving_tick_anatomy()}


def reset_serving_roofline():
    """Drop every stashed phase report (test hygiene)."""
    with _REPORTS_LOCK:
        _REPORTS.clear()
