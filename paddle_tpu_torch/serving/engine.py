"""Continuous-batching LLM serving engine — counterpart of
``paddle_tpu/serving/engine.py``, the single-device path.

  * MODELS — the Llama family and, through the structure adapters of
    ``models/paged.py``, the MoE families (Mixtral, Qwen2-MoE,
    ``MoEForCausalLM``); an MoE model arms the ``serving.moe_dispatch``
    fault site before each decode tick.
  * DEVICE — :class:`~paddle_tpu_torch.serving.executor.ModelExecutor`:
    slot-aware prefill (flash kernel), chunked prefill (paged chunk
    kernel) and the fused decode tick (paged decode kernel + on-device
    sampling), all updating the paged pool in place.
  * HOST — :class:`~paddle_tpu_torch.serving.scheduler.Scheduler` (FCFS
    or weighted fair-share queue, deadlines, preemption policy,
    backpressure) and
    :class:`~paddle_tpu_torch.serving.kv.KVManager` (block tables, radix
    prefix cache, reservation ledger). Per-tick bookkeeping is numpy; the
    only per-tick device-to-host traffic is the [num_slots] token fetch.

One tick (:meth:`step`) admits queued requests and runs the padded
whole-prompt prefill for prompts of at most ``max_prompt_len`` tokens,
streams longer prompts and prefix-cache hits through chunked prefill,
then runs one decode tick for every active slot. Host decisions —
admission, reservations, preemption victims, table growth — are the
reference's, so a greedy request mix yields the same token streams.

Capacity discipline: without ``preemption`` a request is admitted only
when the pool covers its whole worst case (prompt + max_new_tokens) net
of other reservations; with ``preemption=True`` admission is optimistic
and out-of-blocks evicts the youngest request, which later resumes from
prompt + tokens so far (prefix-cache hits make the recompute cheap).

Sliding-window models (Mistral) recycle the blocks that fall wholly
below ``cur - window``: the paged decode kernel never reads below
``lens - window``, so a sequence holds O(window) live blocks however
long it grows. Dynamic-NTK rope bases follow each row's length (the
prefill's whole prompt, the decode tick's position + 1). Both turn
prefix caching off and refuse chunked prefill, as the reference does.

On the card the decode tick replays a CUDA graph (the port's counterpart
of the reference's jitted tick; ``serving/executor.py``), and the
constructor refuses a model whose head dim or GQA group no card kernel
takes (:func:`card_shape_error`), before any slot or block is claimed.

Async pipelined decode: ``async_depth=K`` keeps up to K decode ticks
dispatched but not yet fetched. While the engine only decodes (no
admission, no chunked prefill, no table growth within the window), each
step replays the next tick with the previous tick's tokens still on the
device and fetches the oldest tick's tokens, so the host's emission work
overlaps the card's. Every other step drains the window first and runs
the synchronous path, so streams are the synchronous engine's, token for
token. ``PT_ASYNC_DECODE=0`` at construction is the kill switch.

Quantized serving: ``kv_dtype="int8"`` keeps the KV pool in int8 with
per-(position, KV head) fp32 scales (quantize on write, dequantize on
read in the paged kernels' int8 mode); ``PT_QUANT_KV=0`` at construction
falls back to a pool of the model's type. Weight-only int8/int4 models
come from ``serving.quant.quantize_for_serving``. An int8 pool arms the
``serving.kv_quant`` fault site before each decode tick.

Multi-LoRA serving: with an ``adapter_store``
(:class:`~paddle_tpu_torch.serving.adapters.AdapterStore`), a request
carrying an ``adapter_id`` is admitted once its adapter is
device-resident and pinned, and every forward of its slot adds the
grouped rank-r correction of that adapter (``models/paged.py``
``_lora_delta``: two grouped products on K6a); rows without an adapter
take the base path, and a tick with no adapter row replays the base
graph. ``PT_MULTILORA=0`` is the kill switch (read at each use).

Speculative decoding: with a ``draft_model``, each eligible slot drafts
up to ``spec_k`` tokens through the draft's dense per-slot cache
(``models/speculative.py``), ONE batched target chunk forward verifies
them through the paged pool (K3), greedy or stochastic accept commits
up to k + 1 tokens, and the rejected positions are rolled back by
lengths alone. ``spec_adaptive`` shrinks a slot's k with its acceptance
rate. ``PT_SPEC_DECODE=0`` is the kill switch (read every tick); the
``serving.spec_verify`` fault site falls the round back to the one-token
tick.

Beam search: a ``num_beams=K`` request occupies K cache slots, its
prompt prefilled once (one row of the admission prefill) and shared by
the beams' block tables copy-on-write; each tick selects the K best
continuations on the card (``models/decoding.py`` ``beam_select``, the
same function ``paged_beam_search`` runs) and forks the tables along the
chosen parents, writing the tables, lengths and partial blocks in place
(``ModelExecutor.beam_group_update``) so the captured tick stays valid.
The beams' log-probs come from the tick's fp32 logits. Beams run over a
pool of the model's type and over an int8 pool alike; they refuse a
window, streaming, adapters and grammars, as the reference does.

Grammar-constrained decoding: a request's ``grammar``
(:class:`~paddle_tpu_torch.serving.grammar.TokenMaskAutomaton`) masks
every token it samples — the first one after prefill, every decode tick
(the executor's biased graph; a tick with no grammar row replays the
unbiased graph), and each position of a speculative verify, where an
illegal draft is rejected before the accept rule sees it.

Observability: every request-tracker event and flight-recorder record
of the reference engine at the same sites; the goodput ledger's good,
saved and waste columns (``pad_rows``, ``replay_prefill``,
``spec_rejected``, ``chaos_abort``, ``async_overrun``); the tick
breakdown (``serving_tick_breakdown_seconds`` by phase, summing to
``serving_tick_seconds``, and ``serving_tick_host_hidden_seconds`` under
async decode); and the roofline ledger — per-phase seconds, tokens,
weight passes and KV positions folded into ``serving_mfu`` /
``serving_mbu`` / ``serving_arith_intensity{phase}`` against the peaks
of the engine's device (0.0, "undefined", on the CPU).

Tenants and operations: a request's ``tenant_id`` enters the
scheduler's weighted fair share, token-bucket rate limits and service
classes, and the per-tenant counters (tokens, admissions, queue wait,
TTFT, token latency, finishes, rejections). ``degrade=`` takes a
:class:`~paddle_tpu_torch.serving.degrade.DegradationController`: L1
turns speculation off, L2 shrinks the chunked-prefill budget (the
``[a_cap, cap]`` staging keeps its shape), L3 sheds best-effort tenants
at admission, L4 rejects new sessions with ``OverloadError``. ``slo=``
takes an :class:`~paddle_tpu_torch.observability.slo.SLOTracker`,
charged each tick's ``serving_tick_seconds`` observation. Both are
polled from the gauge sweep after every tick, unless a router claimed
them; ``PT_DEGRADE=0`` and ``PT_SLO=0`` are their kill switches.

Multi-replica serving (``serving/router.py``): ``prefill_only=True``
stops the tick after prefill — a prefill-role replica admits and
prefills, and the router lifts each prefilled sequence out with
:meth:`LLMEngine.extract_sequence` (its blocks gathered into a sealed
``KVPayload``) and hands it to a decode-role replica's
:meth:`LLMEngine.install_sequence`, which writes the blocks, the table
row and the length into that engine's pool IN PLACE, so its captured
tick graphs stay valid. :meth:`LLMEngine.release_request` pulls a live
request out unfinished (rebalancing, replica death) and
:meth:`LLMEngine.snapshot_session` captures a request's ids for a
restore after a second replica death. Each drains the async window
first.

Context parallelism: ``cp=N`` serves one engine over N ranks, one
process a rank (``torch.distributed`` initialised, every rank building
the same engine and stepping it in lockstep). Each rank holds
``num_blocks / N`` blocks of the KV pool (``num_blocks`` rounded up to a
multiple of N), so the admissible length grows with N; the model, the
tables and the host's managers are the same on every rank, and the
paged forwards merge the ranks' attention partials (``serving/
executor.py``), so every rank samples the same tokens. ``PT_CP=0``
collapses to cp = 1. Beams, multi-LoRA, MoE models and KV handoff are
refused by name; the ``serving.cp_gather`` fault site fires before each
cp tick's table growth; ``serving_cp_*`` gauges and the gather histogram
exist only above cp = 1; the roofline bills the merge traffic.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import replace as _dc_replace

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.distributed.moe import replicated_tokens
from paddle_tpu_torch.models.decoding import beam_init
from paddle_tpu_torch.models.paged import (_beam_finalize, _beam_select,
                                           greedy_accept_length,
                                           is_moe_model, kv_quant_enabled,
                                           model_config,
                                           stochastic_accept_row)
from paddle_tpu_torch.observability import span as _span
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.observability.goodput import GOODPUT
from paddle_tpu_torch.observability.requests import REQUESTS
from paddle_tpu_torch.observability.roofline import (
    ModelGeometry, record_serving_throughput, resolve_serving_peaks)
from paddle_tpu_torch.ops.cuda import flash_attention as _flash
from paddle_tpu_torch.ops.cuda import grouped_matmul as _grouped
from paddle_tpu_torch.ops.cuda import paged_attention as _paged
from paddle_tpu_torch.serving.degrade import SessionSnapshot
from paddle_tpu_torch.serving.executor import ModelExecutor
from paddle_tpu_torch.serving.kv import KVManager, cache_block_bytes
from paddle_tpu_torch.serving.scheduler import Scheduler
from paddle_tpu_torch.serving.telemetry import (_ACTIVE_SLOTS, _ASYNC_DEPTH,
                                                _ASYNC_DRAINS, _CANCELLED,
                                                _DRAIN, _FINISHED,
                                                _GRAMMAR_SPEC_REJECTS,
                                                _GRAMMAR_TOKENS,
                                                _KV_IN_USE, _KV_UTIL,
                                                _QUEUE_DEPTH, _REJECTED,
                                                _SPEC_ACCEPTED,
                                                _SPEC_DRAFT_REUSE,
                                                _SPEC_FALLBACKS,
                                                _SPEC_PROPOSED, _SPEC_RATE,
                                                _SNAPSHOTS, _SPEC_TOKENS,
                                                _TENANT_FINISHED,
                                                _TENANT_REJECTED,
                                                _TENANT_TOK_LAT,
                                                _TENANT_TOKENS,
                                                _TENANT_TTFT, _TICK,
                                                _TICK_BREAKDOWN,
                                                _TICK_HIDDEN, _TIMEOUTS,
                                                _TOK_LAT, _TOKENS, _TTFT,
                                                tenant_label)
from paddle_tpu_torch.serving.transfer import KVPayload
from paddle_tpu_torch.serving.types import (EngineDrainingError,
                                            OverloadError, Request,
                                            _BeamGroup)
from paddle_tpu_torch.utils.faults import fault_point

def card_shape_error(cfg, max_rank=None):
    """Why the card's kernels cannot serve a model of config ``cfg`` (with
    an adapter store of rank ``max_rank``), or None when they can: the
    engine runs the flash kernels (K2, K5; ``_flash.HEAD_DIMS``: 64, 80,
    128, 256) and the paged kernels (K3, K4; ``_paged.HEAD_DIMS``: 64, 128), so
    a head dim must be in both; the paged decode kernel (K4) takes GQA
    groups up to ``MAX_GROUP``, and the LoRA expand kernel ranks up to
    ``LORA_MAX_RANK``. The CPU's plain paths serve every shape."""
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    d = cfg.hidden_size // nh
    if d not in _flash.HEAD_DIMS or d not in _paged.HEAD_DIMS:
        return (f"head dim {d} (hidden {cfg.hidden_size} over {nh} heads): "
                f"the flash kernels (K2, K5) take head dims "
                f"{_flash.HEAD_DIMS} and the paged kernels (K3, K4) "
                f"{_paged.HEAD_DIMS}")
    if nh // nkv > _paged.MAX_GROUP:
        return (f"GQA group {nh // nkv} ({nh} query heads over {nkv} KV "
                f"heads): the paged decode kernel takes groups "
                f"1-{_paged.MAX_GROUP}")
    if max_rank is not None and max_rank > _grouped.LORA_MAX_RANK:
        return (f"adapter max_rank {max_rank}: the LoRA expand kernel takes "
                f"ranks up to {_grouped.LORA_MAX_RANK}")
    return None


class LLMEngine:
    """Continuous-batching engine over a shared paged KV pool.

    ``num_slots`` concurrent sequences; queued requests are admitted
    MID-FLIGHT into slots freed by finished ones (prefill interleaves with
    decode ticks). ``step()`` is one engine tick; ``run()`` drains
    everything and returns {req_id: generated token list}. ``device``
    defaults to the model's device."""

    def __init__(self, model, *, num_slots=8, block_size=16,
                 max_prompt_len=128, max_seq_len=None, num_blocks=None,
                 eos_token_id=None, temperature=0.0, top_k=None, top_p=None,
                 seed=0, prefix_caching=True, preemption=False,
                 max_queue_len=None, clock=None, draft_model=None,
                 spec_k=4, spec_adaptive=True, prefill_only=False,
                 adapter_store=None, degrade=None, slo=None, kv_dtype=None,
                 cp=1, async_depth=0, device=None):
        # context-parallel serving: PT_CP=0 is the kill switch, read
        # HERE, so the engine collapses to the single-rank path
        cp = int(cp)
        if cp != 1 and os.environ.get(
                "PT_CP", "1").strip().lower() in ("0", "off", "false"):
            cp = 1
        if cp < 1:
            raise ValueError(f"cp must be >= 1, got {cp}")
        self.cp = cp
        # async pipelined decode: PT_ASYNC_DECODE=0 is the kill switch,
        # read HERE, so depth collapses to 0 and the engine runs exactly
        # the synchronous tick
        async_depth = int(async_depth)
        if async_depth and os.environ.get(
                "PT_ASYNC_DECODE", "1").strip().lower() in (
                    "0", "off", "false"):
            async_depth = 0
        if async_depth < 0:
            raise ValueError(
                f"async_depth must be >= 0, got {async_depth}")
        self.async_depth = async_depth
        cfg = model_config(model)
        self.model = model
        # int8 KV: PT_QUANT_KV=0 is the kill switch, read here — the pool
        # then keeps the model's type
        if kv_dtype is not None and not kv_quant_enabled():
            kv_dtype = None
        self.kv_dtype = kv_dtype
        # MoE models route tokens to experts inside the tick — give chaos a
        # hook at that boundary (a dead expert shard)
        self._is_moe = is_moe_model(model)
        self.device = (model.device if device is None
                       else resolve_device(device))
        if self.device.type == "cuda":
            # refuse HERE, before any slot or block is claimed: a kernel's
            # refusal inside step() would wedge the request mid-tick
            err = card_shape_error(cfg, getattr(adapter_store, "max_rank",
                                                None))
            if err is not None:
                raise NotImplementedError(
                    f"LLMEngine on the card: {err} (ROADMAP.md queue 2, "
                    f"Shapes the kernels refuse)")
        self.num_slots = num_slots
        self.block_size = block_size
        # graceful degradation: an optional DegradationController,
        # consulted by the spec gate, the chunked-prefill budget,
        # admission shedding and the session gate. None means full
        # service, always
        self.degrade = degrade
        # per-tenant SLO tracking and usage metering: an optional
        # SLOTracker, charged per tick from step() and polled from the
        # gauge sweep. None means no tracking, ever
        self.slo = slo
        self.max_prompt_len = max_prompt_len
        self.max_seq_len = max_seq_len or (max_prompt_len + 256)
        self.max_blocks_per_seq = -(-self.max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = num_slots * self.max_blocks_per_seq
        if self.cp > 1:
            if self._is_moe:
                raise NotImplementedError(
                    "context-parallel serving (cp>1) does not compose with "
                    "MoE models yet — the expert all_to_all would need its "
                    "own mesh axis")
            if adapter_store is not None:
                raise NotImplementedError(
                    "context-parallel serving (cp>1) does not compose with "
                    "multi-LoRA (adapter_store) yet — per-slot adapter "
                    "gathers are not sharded over cp")
            # each rank holds num_blocks/cp blocks: round the pool up so
            # the contiguous split is exact
            num_blocks = -(-num_blocks // self.cp) * self.cp
        self.eos_token_id = eos_token_id
        # engine defaults; each request may override temperature/top_p
        # (top_k stays engine-global)
        self.default_temp = float(temperature)
        self.default_top_p = 1.0 if top_p is None else float(top_p)
        self.top_k = top_k
        self.temps = np.zeros(num_slots, np.float32)
        self.top_ps = np.ones(num_slots, np.float32)
        # sliding-window models: blocks entirely below cur - window are
        # never attended again (the paged decode kernel reads only
        # positions >= lens - window) — recycle them, bounding live blocks
        # per sequence by O(window), not O(length)
        self.window = cfg.sliding_window
        self._dyn_rope = (cfg.rope_scaling or {}).get("type") == "dynamic"
        # prefix caching is sound only when a block's KV is a function of
        # its token prefix alone: windowed recycling punches holes in the
        # table, and dynamic-NTK makes KV depend on the FULL prompt length
        self.prefix_caching = (bool(prefix_caching) and self.window is None
                               and not self._dyn_rope)
        self.preemption = bool(preemption)
        # prefill-role replica (disaggregated serving): the tick stops
        # after prefill; the router extracts the prefilled sequences
        self.prefill_only = bool(prefill_only)
        # replica name stamped on request-tracker events (None: a lone
        # engine)
        self.trace_name = None

        # speculative decoding: ``draft_model`` enables it; each eligible
        # slot drafts up to spec_k tokens through a per-slot dense draft
        # cache, then ONE batched target chunk forward verifies them
        # through the paged pool. PT_SPEC_DECODE=0 is the kill switch
        # (read every tick, so it also disables a live engine)
        self.draft_model = draft_model
        self.spec_k = int(spec_k)
        self.spec_adaptive = bool(spec_adaptive)
        if draft_model is not None:
            dcfg = model_config(draft_model)
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if self.window is not None or dcfg.sliding_window:
                raise NotImplementedError(
                    "speculative decoding needs full (un-windowed) caches "
                    "on both models — rewind relies on masked stale KV")
            if self._dyn_rope:
                raise NotImplementedError(
                    "speculative decoding with dynamic-NTK rope is not "
                    "supported (the verify chunk shares the chunked-"
                    "prefill forward, which refuses per-chunk bases)")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {dcfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}")
            # host RNG for draft sampling + accept/reject (temperature >
            # 0): the accept rule preserves the target distribution for
            # any uniform source, so this stream need not match the
            # engine's generator
            self._spec_rs = np.random.RandomState(
                (seed ^ 0x5eed) & 0x7fffffff)
        # multi-LoRA: a request carrying an adapter_id is admitted only
        # once its adapter is device-resident AND pinned (the scheduler
        # acquires it); PT_MULTILORA=0 (read per use) hands every forward
        # lora=None, the exact base path
        if adapter_store is not None and (
                adapter_store.device.type != self.device.type
                or None not in (adapter_store.device.index,
                                self.device.index)
                and adapter_store.device.index != self.device.index):
            raise ValueError(
                f"adapter store on {adapter_store.device}, engine on "
                f"{self.device}")
        self.adapter_store = adapter_store

        self.kv = KVManager(num_blocks, block_size)
        self.sched = Scheduler(max_queue_len=max_queue_len, clock=clock)
        # the engine's forwards hold the whole batch on every rank: under
        # a mesh an MoE layer takes its share of it (distributed.moe)
        with replicated_tokens():
            self.exe = ModelExecutor(
                model, num_slots=num_slots, num_blocks=num_blocks,
                block_size=block_size,
                max_blocks_per_seq=self.max_blocks_per_seq, top_k=top_k,
                seed=seed, kv_dtype=kv_dtype, async_depth=async_depth,
                adapter_store=adapter_store, draft_model=draft_model,
                spec_k=self.spec_k, max_seq_len=self.max_seq_len,
                device=self.device, cp=self.cp)

        # host mirrors (vectorised bookkeeping)
        self.slot_req = np.full(num_slots, -1, np.int64)   # req_id or -1
        self.active = np.zeros(num_slots, bool)
        self.cur = np.zeros(num_slots, np.int64)     # tokens stored in cache
        self.gen = np.zeros(num_slots, np.int64)     # tokens generated
        self.max_gen = np.zeros(num_slots, np.int64)
        self.table_len = np.zeros(num_slots, np.int64)
        self.last_tok = np.zeros(num_slots, np.int32)
        self.slot_aidx = np.full(num_slots, -1, np.int64)  # cache idx / -1
        self._adapter_pins: dict[int, object] = {}   # rid -> adapter_id
        # grammar-constrained decoding: slot -> [automaton, state]. The
        # state advances in ``_emit`` as tokens commit, so it is always
        # the state AFTER everything in req.tokens — a pure function of
        # the emitted stream (a resume replays it)
        self._grammar: dict[int, list] = {}
        # beam groups: rid -> _BeamGroup; is_beam marks their slots
        self.is_beam = np.zeros(num_slots, bool)
        self.groups: dict[int, _BeamGroup] = {}
        self._sid_counter = 0        # unique fork keys: (req_id, counter)
        # this tick's greedy admits whose prefill rows are staged but not
        # yet written: a beam fork in the same tick must not evict them
        self._staged_admits = frozenset()
        # speculative per-slot state (allocated even when spec is off, so
        # reset sites need no guards). ``draft_cur``: committed-sequence
        # positions 0..draft_cur-1 are in the draft cache — 0 means empty,
        # which is how eviction "frees" a draft cache
        self.draft_cur = np.zeros(num_slots, np.int64)
        self.slot_k = np.full(num_slots, self.spec_k, np.int64)
        self._acc_ema = np.ones(num_slots, np.float64)
        # draft-cache reuse: the token ids whose K/V sit in a slot's draft
        # cache rows 0..draft_cur-1, snapshotted at each commit; a new
        # request whose radix-adopted prefix matches them seeds draft_cur
        # past the match instead of re-feeding from 0
        self._draft_resident: dict[int, np.ndarray] = {}
        # per-slot adopted span of the current request: the draft
        # catch-up feed bills only re-embeds inside it as replay_prefill
        # waste (first-time prompt embedding is not waste)
        self._adopted_span = np.zeros(num_slots, np.int64)
        # chunked prefill (prompts > max_prompt_len, prefix-cache hits):
        # rid -> (slot, tokens consumed); slots stay inactive until the
        # last chunk
        self.prefilling: dict[int, tuple] = {}
        # spec_draft_s / spec_verify_s: wall seconds of the draft phase and
        # of the verify call (its logits fetched) over all spec ticks;
        # grammar_ticks: decode ticks with
        # a grammar-bound row (the biased graph on the card); bias_s:
        # host seconds building their bias rows; lora_grammar_ticks:
        # those that also carried adapter rows (the eager tick on the
        # card); beam_select_s /
        # beam_update_s: wall seconds of the beam groups' selects (with
        # the parents' fetch) and cache reorders
        self.stats = {"ticks": 0, "preemptions": 0, "timeouts": 0,
                      "cancelled": 0, "rejected": 0, "spec_ticks": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_fallbacks": 0, "spec_draft_s": 0.0,
                      "spec_verify_s": 0.0, "grammar_ticks": 0,
                      "lora_grammar_ticks": 0, "bias_s": 0.0,
                      "beam_selects": 0, "beam_select_s": 0.0,
                      "beam_update_s": 0.0}
        self._adm_counter = 0                # admission recency, per slot
        self.adm_order = np.zeros(num_slots, np.int64)
        # the async window: oldest-first dispatched-but-unfetched ticks,
        # each {"tick": the executor's handle, "rng_before": the sampling
        # generator's state before that tick}. _async_live: the executor
        # holds this window's device loop state (seeded from the host
        # mirrors at the window's start). _async_rewound guards the
        # one-shot generator rewind when draining a fully masked tick.
        # stats["async_overrun"]: rows that ran on the card for a slot the
        # host tore down meanwhile (a stream-callback cancel mid-window)
        self._async_win: list[dict] = []
        self._async_live = False
        self._async_rewound = False
        self._async_draining = False
        self.stats["async_overrun"] = 0
        # hidden host time of this tick (drain work overlapped with
        # in-flight device ticks); observed once a step
        self._hidden_acc = 0.0

        # roofline ledger: cumulative per-phase [seconds, tokens, weight
        # passes, KV-read positions], folded into serving_mfu/mbu/
        # arith_intensity at each gauge sweep. The peaks resolve once
        # from the engine's device (0.0 on the CPU: the gauges then read
        # 0.0 = undefined; PT_ROOFLINE_KIND overrides for a what-if).
        # _tick_phase holds the current tick's wall-time split; step()
        # folds it into the breakdown histogram and these accumulators.
        self._geom = self._geometry(model, self.cache, self.cp)
        self._draft_geom = (self._geometry(draft_model)
                            if draft_model is not None else None)
        self._peak_flops, self._peak_hbm = resolve_serving_peaks(self.device)
        self._phase_acc = {p: [0.0, 0, 0, 0] for p in
                           ("prefill", "decode", "spec_draft", "spec_verify")}
        self._tick_phase: dict[str, float] = {}

    @staticmethod
    def _geometry(m, cache=None, cp=1):
        """The model's roofline geometry with the stored types billed:
        an int8 pool's 1-byte codes plus a 4-byte scale per (position, KV
        head), a weight-only model's bits/8 bytes a weight. None for a
        model whose config the geometry cannot read."""
        try:
            g = ModelGeometry.from_config(
                m.cfg, dtype_bytes=torch.empty(
                    (), dtype=model_config(m).dtype).element_size())
        except Exception:
            return None
        kw = {}
        if cache is not None and cache.k_scale_store:
            kw.update(kv_dtype_bytes=cache.k_store[0].element_size(),
                      kv_scale_bytes=4)
        bits = getattr(m, "_wo_bits", None)
        if bits:
            kw["weight_dtype_bytes"] = bits / 8.0
        # context parallelism: bill each decode token's cross-rank merge
        if cache is not None and cp > 1:
            kw["cp"] = cp
        return _dc_replace(g, **kw) if kw else g

    # -------------------------------------------------- attribute surface
    @property
    def mgr(self):
        return self.kv.mgr

    @property
    def queue(self):
        return self.sched.queue

    @property
    def requests(self):
        return self.sched.requests

    @property
    def cache(self):
        return self.exe.cache

    @property
    def _clock(self):
        return self.sched.clock

    @property
    def _draining(self):
        return self.sched.draining

    @_draining.setter
    def _draining(self, value):
        self.sched.draining = value

    # ------------------------------------------------------------- intake
    def add_request(self, req: Request) -> int:
        self.sched.check_backpressure(self.stats)
        # ladder L4: explicit backpressure on NEW sessions. Requests a
        # router already accepted (_preadmitted) pass
        if (self.degrade is not None and not req._preadmitted
                and not self.degrade.accepting_sessions()):
            self.stats["rejected"] += 1
            _REJECTED.inc(reason="degraded")
            if req.tenant_id is not None:
                _TENANT_REJECTED.inc(tenant=tenant_label(req.tenant_id))
            raise OverloadError(
                "degradation ladder at L4 — new sessions rejected, "
                "retry after the cluster recovers")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the prefill "
                             "itself produces the first token)")
        if req.num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        if req.num_beams > 1:
            if req.num_beams > self.num_slots:
                raise ValueError(f"num_beams {req.num_beams} exceeds "
                                 f"num_slots={self.num_slots}")
            if self.cp > 1:
                raise NotImplementedError(
                    "beam search under context parallelism (cp>1) is not "
                    "supported — the beam select needs full logprobs, "
                    "which the cp tick does not gather")
            if self.window is not None:
                raise NotImplementedError(
                    "beam search + sliding-window block recycling are not "
                    "combined (a recycled parent block may be needed by a "
                    "forked child)")
            if req.stream is not None:
                raise ValueError("streaming is not supported for beam "
                                 "requests (tokens are only known at the "
                                 "final selection)")
        if len(req.prompt) < 1:
            raise ValueError("prompt must contain at least one token "
                             "(an empty row has no logit to sample from)")
        if len(req.prompt) > self.max_prompt_len and req.num_beams > 1:
            raise ValueError(f"prompt length {len(req.prompt)} exceeds "
                             f"max_prompt_len={self.max_prompt_len} "
                             "(chunked prefill does not combine with "
                             "beam search)")
        if len(req.prompt) > self.max_prompt_len and self.window is not None:
            raise NotImplementedError(
                "chunked prefill + sliding-window recycling not combined")
        if len(req.prompt) > self.max_prompt_len and self._dyn_rope:
            # refuse HERE: a raise inside step() would leave the slot
            # claimed and the request wedged in self.prefilling
            raise NotImplementedError(
                "chunked prefill with dynamic-NTK rope is not supported")
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if self._worst_case_blocks(req) > self.mgr.num_blocks:
            # the request could NEVER be admitted: finish it gracefully
            # (finish_reason="too_long") so the FCFS head never jams on it
            rid = self.sched.enqueue(req)
            self.queue.pop()
            REQUESTS.submit(req, source="engine")
            req.done = True
            req.finish_reason = "too_long"
            self.stats["rejected"] += 1
            _REJECTED.inc(reason="too_long")
            _FINISHED.inc(reason="too_long")
            if req.tenant_id is not None:
                _TENANT_REJECTED.inc(tenant=tenant_label(req.tenant_id))
                _TENANT_FINISHED.inc(tenant=tenant_label(req.tenant_id),
                                     reason="too_long")
            FLIGHT.record("serving.reject", rid=rid, reason="too_long")
            REQUESTS.finish(req, "too_long", replica=self.trace_name)
            return rid
        if req.adapter_id is not None:
            if self.adapter_store is None:
                raise ValueError(
                    "request carries an adapter_id but the engine was "
                    "built without an adapter_store")
            if not self.adapter_store.known(req.adapter_id):
                raise ValueError(f"adapter {req.adapter_id!r} is not "
                                 "registered with the adapter store")
            if req.num_beams > 1:
                raise NotImplementedError(
                    "multi-LoRA + beam search are not combined")
        if req.grammar is not None:
            if req.num_beams > 1:
                raise NotImplementedError(
                    "grammar-constrained decoding + beam search are not "
                    "combined (beam tokens come from the select, not "
                    "the sampler)")
            if not (hasattr(req.grammar, "bias")
                    and hasattr(req.grammar, "advance")):
                raise ValueError("req.grammar must be a "
                                 "serving.grammar.TokenMaskAutomaton")
            vocab = model_config(self.model).vocab_size
            if len(req.grammar.vocab) != vocab:
                raise ValueError(
                    f"grammar vocab {len(req.grammar.vocab)} != model "
                    f"vocab {vocab}")
        rid = self.sched.enqueue(req)
        REQUESTS.submit(req, source="engine")       # idempotent re-submit
        REQUESTS.event(req, "queued", replica=self.trace_name,
                       depth=len(self.queue))
        _QUEUE_DEPTH.set(len(self.queue))
        return rid

    def pop_finished(self) -> dict:
        """Remove and return completed requests ({req_id: Request})."""
        return self.sched.pop_finished()

    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.active.any())
                or bool(self.groups) or bool(self.prefilling)
                or bool(self._async_win))

    def outstanding(self) -> int:
        """Requests accepted but not yet finished (queued, prefilling or
        decoding) — the router's least-outstanding-requests load
        signal."""
        return sum(1 for r in self.requests.values() if not r.done)

    # --------------------------------------------- cancellation/deadlines
    def cancel(self, req_id: int, reason: str = "cancelled") -> bool:
        """Terminate a request wherever it currently lives — queued,
        chunk-prefilling, decoding or mid-beam — freeing its blocks,
        reservation and slot(s). Returns False for unknown/finished
        requests."""
        req = self.requests.get(req_id)
        if req is None or req.done:
            return False
        # in-flight async ticks may already hold this request's next
        # tokens: drain so the emitted stream is exact before its slot is
        # torn down. The drain can finish the request — re-check after
        self._drain_async("cancel")
        if req.done:
            return False
        g = self.groups.get(req_id)
        sids = list(g.sid.values()) if g is not None else None
        if not self._detach(req_id):
            return False
        self.kv.release(req_id)
        # peak attribution survives the free above (the ledger keeps a
        # request's lifetime max past its table drop)
        peak = (sum(self.kv.take_peak(s) for s in sids) if sids
                else self.kv.take_peak(req_id))
        REQUESTS.event(req, "kv_peak", replica=self.trace_name, blocks=peak)
        req.done = True
        req.finish_reason = reason
        self.stats["timeouts" if reason == "timeout" else "cancelled"] += 1
        (_TIMEOUTS if reason == "timeout" else _CANCELLED).inc()
        _FINISHED.inc(reason=reason)
        if req.tenant_id is not None:
            _TENANT_FINISHED.inc(tenant=tenant_label(req.tenant_id),
                                 reason=reason)
        FLIGHT.record("serving.timeout" if reason == "timeout"
                      else "serving.cancel", rid=req_id)
        REQUESTS.finish(req, reason, replica=self.trace_name)
        return True

    def _detach(self, req_id: int) -> bool:
        """Free a live request's slot/blocks wherever it currently is,
        without touching the ledger or finishing it."""
        for i, q in enumerate(self.queue):          # still waiting
            if q.req_id == req_id:
                del self.queue[i]
                return True
        if req_id in self.prefilling:
            slot, _ = self.prefilling.pop(req_id)
            self.mgr.free(req_id)
            self.slot_req[slot] = -1
            self._release_adapter(req_id)
            return True
        if req_id in self.groups:
            g = self.groups.pop(req_id)
            for sid in g.sid.values():
                self.mgr.free(sid)
            for slot in g.slots:
                self.active[slot] = False
                self.is_beam[slot] = False
                self.slot_req[slot] = -1
            return True
        slots = np.nonzero(self.slot_req == req_id)[0]
        if not len(slots):
            return False
        slot = int(slots[0])
        self.mgr.free(req_id)
        self.active[slot] = False
        self.slot_req[slot] = -1
        self.draft_cur[slot] = 0
        self.slot_aidx[slot] = -1
        self._grammar.pop(slot, None)
        self._release_adapter(req_id)
        return True

    def release_request(self, rid: int):
        """Pull a live request OUT of the engine (router rebalancing,
        replica death): free its slot(s), blocks and reservation and
        forget it — WITHOUT finishing it. Returns the Request (with
        whatever tokens it generated) so the caller can re-dispatch it,
        or None for an unknown or finished request."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return None
        self._drain_async("boundary")
        if req.done:
            return None
        g = self.groups.get(rid)
        sids = list(g.sid.values()) if g is not None else None
        if not self._detach(rid):
            return None
        self.kv.release(rid)
        # the request leaves this engine: stamp its peak here (the next
        # replica's incarnation stamps its own; the summary takes the max)
        peak = (sum(self.kv.take_peak(s) for s in sids) if sids
                else self.kv.take_peak(rid))
        REQUESTS.event(req, "kv_peak", replica=self.trace_name, blocks=peak)
        return self.sched.release(rid)

    def drain(self, cancel_queued: bool = False) -> dict:
        """Graceful shutdown: stop admitting (``add_request`` raises
        EngineDrainingError) but finish everything in flight; returns
        {req_id: tokens} like ``run``."""
        t0 = time.monotonic()
        with _span("serving.drain", cancel_queued=cancel_queued):
            self.sched.draining = True
            if cancel_queued:
                for r in list(self.queue):
                    self.cancel(r.req_id)
            while self.has_work():
                self.step()
            self._refresh_gauges()
        _DRAIN.observe(time.monotonic() - t0)
        return {rid: r.tokens for rid, r in self.requests.items()}

    def assert_quiescent(self):
        """Invariant check once idle: every block is back in the pool
        (prefix-cache parked blocks count — they are reclaimable), no
        standing reservations, no per-sequence tables, and the memory
        ledger reconciles with the block manager, and no adapter pin is
        held."""
        assert not self.has_work(), "engine still has work"
        self.kv.assert_quiescent()
        rec = self.kv.reconcile()
        assert rec["ok"], f"memory ledger out of step: {rec['diffs']}"
        assert not self._adapter_pins, \
            f"adapter pin leak: {self._adapter_pins}"

    def _pr(self, req) -> np.ndarray:
        """Effective prompt: the resume form (prompt + tokens generated
        before a preemption), the original prompt otherwise."""
        return req.prompt if req._resume is None else req._resume

    def _remaining(self, req) -> int:
        return req.max_new_tokens - len(req.tokens)

    def _worst_case_blocks(self, req) -> int:
        """Blocks a request can ever hold at once. Windowed models recycle
        below-window blocks, so the live span is bounded by the window
        (plus the write-frontier block) — but prefill scatters the WHOLE
        prompt before any recycling, so that is a floor.

        Beam requests (K slots): shared prompt blocks once, plus per beam
        the generated span (straddling <= ceil(new/bs)+1 blocks), plus 2
        per beam for the copy-on-write partial forks (one held, one
        transient while the new fork exists before the parent is
        freed)."""
        p = len(self._pr(req))
        if req.num_beams > 1:
            k = req.num_beams
            return (self.mgr.blocks_needed(p)
                    + k * (self.mgr.blocks_needed(
                        req.max_new_tokens + self.block_size) + 2))
        total = p + self._remaining(req)
        if self.window is None:
            return self.mgr.blocks_needed(total)
        live = self.mgr.blocks_needed(
            min(total, self.window + 2 * self.block_size))
        return max(self.mgr.blocks_needed(p), live)

    def _recycle_window(self, slots):
        """Free blocks entirely below cur - window for the given slots —
        live blocks per sequence stay O(window). Host-only: the paged
        decode kernel reads no position below lens - window, so the stale
        device-table entries that point at recycled (even reused) blocks
        are never read, and no scatter writes below the frontier."""
        for slot in slots:
            rid = int(self.slot_req[slot])
            dead = int(max(0, self.cur[slot] - self.window)
                       ) // self.block_size
            if dead > 0 and self.mgr.free_prefix(rid, dead):
                self.kv.update(rid)

    # ------------------------------------------------------- multi-LoRA
    def _multilora_on(self) -> bool:
        """PT_MULTILORA=0 kill switch (read per use, so it also disables a
        live engine): off — or no store — means every forward gets
        lora=None, the exact base path."""
        return (self.adapter_store is not None
                and os.environ.get("PT_MULTILORA", "1") != "0")

    def _release_adapter(self, rid: int):
        """Drop the pin the scheduler took at admission (idempotent —
        every detach/finish/preempt path calls it)."""
        aid = self._adapter_pins.pop(rid, None)
        if aid is not None and self.adapter_store is not None:
            self.adapter_store.release(aid)

    def _req_aidx(self, req) -> int:
        """Cache index of the request's pinned adapter (-1 = base path).
        Pinned entries are never evicted, so the index is stable for the
        request's whole slot tenure."""
        if req.req_id in self._adapter_pins and self._multilora_on():
            return self.adapter_store.index_of(req.adapter_id)
        return -1

    def _lora_arg(self, aidx, width: int):
        """The host description of a multi-LoRA batch (int32 numpy
        ``perm``, ``inv``, ``aidx`` [rows] and ``gs`` [capacity]; the
        executor adds the store's stacks and moves them to the device),
        or None when no row carries an adapter (the base path, bit for
        bit). ``aidx``: per-row cache index (-1 = base); ``width``: padded
        tokens a row in the forward — rows are contiguous token spans
        after the permutation, so group sizes are row counts times
        width."""
        if not self._multilora_on():
            return None
        aidx = np.asarray(aidx, np.int64)
        if not (aidx >= 0).any():
            return None
        cap = self.adapter_store.capacity
        order = np.argsort(np.where(aidx < 0, cap, aidx), kind="stable")
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        gs = np.bincount(aidx[aidx >= 0], minlength=cap) * width
        return {"perm": order.astype(np.int32), "inv": inv.astype(np.int32),
                "gs": gs.astype(np.int32), "aidx": aidx.astype(np.int32)}

    # ------------------------------------------------------------ grammar
    def _bind_grammar(self, slot: int, req):
        """(Re)bind a slot's grammar state at activation. The state is a
        pure function of the emitted tokens, so a resume replays
        ``req.tokens`` — preemption cannot drift the mask."""
        if req.grammar is None:
            self._grammar.pop(slot, None)
            return
        st = req.grammar.start_state
        for t in req.tokens:
            st = req.grammar.advance(st, int(t))
        self._grammar[slot] = [req.grammar, st]

    def _grammar_bias_rows(self, rows_slots, n_rows: int):
        """[n_rows, V] fp32 logit bias (0 / -1e30) for the listed (row,
        slot) pairs, exact zeros on every other row; None when no listed
        slot is grammar-bound — the sampler then runs its unbiased path
        (the unbiased graph on the card)."""
        bound = [(i, s) for i, s in rows_slots if s in self._grammar]
        if not bound:
            return None
        bias = np.zeros((n_rows, model_config(self.model).vocab_size),
                        np.float32)
        for i, s in bound:
            aut, st = self._grammar[s]
            bias[i] = aut.bias(st)
        return bias

    # ---------------------------------------------------------- admission
    def _activate(self, slot, req, temp, top_p):
        """Slot bookkeeping for a request whose prompt is now in cache."""
        p = self._pr(req)
        self.slot_req[slot] = req.req_id
        self.active[slot] = True
        self.cur[slot] = len(p)
        self.gen[slot] = 0
        self.max_gen[slot] = self._remaining(req)
        self._adm_counter += 1
        self.adm_order[slot] = self._adm_counter
        self.table_len[slot] = len(self.mgr.tables[req.req_id])
        self.temps[slot] = temp
        self.top_ps[slot] = top_p
        self.slot_aidx[slot] = self._req_aidx(req)
        self._bind_grammar(slot, req)
        # fresh draft state unless the resident draft cache covers a
        # radix-adopted prefix
        self._seed_draft(slot, req)
        self.slot_k[slot] = self.spec_k
        self._acc_ema[slot] = 1.0

    def _req_sampling(self, req):
        return (self.default_temp if req.temperature is None
                else req.temperature,
                self.default_top_p if req.top_p is None else req.top_p)

    def _prefill(self, admits, beam_admits=()):
        """ONE padded prefill forward for every prompt admitted this tick —
        greedy prompts in rows 0..n-1, each beam request's prompt as one
        more row (written into its beam-0 slot; the forks are installed
        after, in ``_beam_init``); samples each greedy request's first
        token."""
        if not admits and not beam_admits:
            return []
        a_cap = self.num_slots           # one admission shape
        ids = np.zeros((a_cap, self.max_prompt_len), np.int64)
        lens = np.zeros(a_cap, np.int32)
        slots = np.full(a_cap, self.num_slots, np.int32)   # sentinel = drop
        rows = np.full((a_cap, self.max_blocks_per_seq),
                       self.mgr.num_blocks, np.int32)
        row_t = np.zeros(a_cap, np.float32)
        row_p = np.ones(a_cap, np.float32)
        for i, (slot, req) in enumerate(admits):
            p = self._pr(req)
            ids[i, :len(p)] = p
            lens[i] = len(p)
            slots[i] = slot
            t = self.mgr.tables[req.req_id]
            rows[i, :len(t)] = t
            row_t[i], row_p[i] = self._req_sampling(req)
            self._activate(slot, req, row_t[i], row_p[i])
            REQUESTS.event(req, "prefill", replica=self.trace_name,
                           slot=slot, tokens=int(lens[i]))
        n = len(admits)
        beams = []
        self._staged_admits = frozenset(r.req_id for _, r in admits)
        for bi, (bslots, req) in enumerate(beam_admits):
            g, grows, csrc, cdst = self._beam_alloc(bslots, req)
            i = n + bi                   # every admit holds >= 1 slot, so
            ids[i, :g.s] = req.prompt    # greedy + beam rows fit in a_cap
            lens[i] = g.s
            slots[i] = bslots[0]
            rows[i] = grows[0]
            beams.append((g, grows, csrc, cdst))
        row_aidx = np.full(a_cap, -1, np.int64)
        for i, (slot, _) in enumerate(admits):
            row_aidx[i] = self.slot_aidx[slot]
        logits = self.exe.prefill(
            ids, lens, slots, rows,
            lora=self._lora_arg(row_aidx, self.max_prompt_len))
        self._staged_admits = frozenset()   # written: evictable again
        # roofline: one weight pass; prompts attend causally from 0
        self._acc_phase("prefill", int(lens.sum()), 1,
                        self._ctx_causal(lens, np.zeros_like(lens)))
        first = self.exe.sample(
            logits, row_t, row_p,
            bias=self._grammar_bias_rows(
                [(i, slot) for i, (slot, _) in enumerate(admits)], a_cap))
        if self.window is not None:
            # a long prompt's below-window blocks die the moment prefill
            # has scattered them — and from here on the sequence can never
            # hold more than the window live bound, so relax its
            # reservation too (the prompt-size floor only mattered DURING
            # prefill)
            self._recycle_window([slot for slot, _ in admits])
            live_bound = self.mgr.blocks_needed(
                self.window + 2 * self.block_size)
            for slot, req in admits:
                rid = req.req_id
                self.kv.need[rid] = min(self.kv.need[rid], live_bound)
                self.kv.update(rid)
        emitted = []
        for i, (slot, req) in enumerate(admits):
            emitted += self._emit(slot, int(first[i]))
        for bi, (g, grows, csrc, cdst) in enumerate(beams):
            emitted += self._beam_init(g, grows, csrc, cdst, logits[n + bi])
        return emitted

    # ------------------------------------------------------------ beams
    def _group_live_blocks(self, g: _BeamGroup) -> int:
        """Distinct pool blocks held by the whole group (shared prompt
        blocks appear in several beams' tables — counted once)."""
        return len({b for sid in g.sid.values()
                    for b in self.mgr.tables.get(sid, []) if b is not None})

    def _update_resv_group(self, rid: int):
        self.kv.update(rid, live=self._group_live_blocks(self.groups[rid]))

    def _new_sid(self, rid):
        self._sid_counter += 1
        return (rid, self._sid_counter)

    def _beam_alloc(self, slots, req: Request):
        """Host/manager phase of beam admission: allocate the prompt under
        beam 0's key and fork the other beams copy-on-write. Returns the
        group plus the fork data; the prompt itself rides as ONE row of
        the shared admission prefill."""
        k, s, rid = req.num_beams, len(req.prompt), req.req_id
        nb, max_b = self.mgr.num_blocks, self.max_blocks_per_seq
        g = _BeamGroup(req=req, slots=list(slots), s=s)
        g.sid = {j: self._new_sid(rid) for j in range(k)}
        # protect same-tick greedy admits: their prefill rows are staged
        # but not written yet (this runs inside _prefill)
        prot = self._staged_admits
        self._mgr_retry(self.mgr.allocate, g.sid[0], s, protect=prot)
        rows = np.full((k, max_b), nb, np.int32)
        copy_src = np.full(k, nb, np.int32)
        copy_dst = np.full(k, nb, np.int32)
        for j in range(1, k):
            pair = self._mgr_retry(self.mgr.fork, g.sid[0], g.sid[j], s,
                                   protect=prot)
            if pair is not None:
                copy_src[j], copy_dst[j] = pair
        for j in range(k):
            t = self.mgr.tables[g.sid[j]]
            rows[j, :len(t)] = t
        return g, rows, copy_src, copy_dst

    def _beam_init(self, g: _BeamGroup, rows, copy_src, copy_dst,
                   logits_row):
        """Device-state phase after the shared prefill: install the forked
        tables, init the selection state from the prompt's last logits,
        then run the group's FIRST select so its slots enter this tick's
        decode with real beam tokens."""
        req, s, rid, k = g.req, g.s, g.req.req_id, g.req.num_beams
        t0 = time.perf_counter()
        self.exe.beam_group_update(g.slots, rows, s, copy_src, copy_dst)
        self.stats["beam_update_s"] += time.perf_counter() - t0
        g.running_lp, g.seqs, g.fin_seqs, g.fin_scores, g.logp = (
            x[0] for x in beam_init(
                logits_row[None], torch.as_tensor(
                    np.asarray(req.prompt, np.int64)[None],
                    device=logits_row.device), k, req.max_new_tokens))
        for slot in g.slots:
            self.slot_req[slot] = rid
            self.active[slot] = True
            self.is_beam[slot] = True
            self.cur[slot] = s
            self.temps[slot] = 0.0       # beam tokens come from the select
            self.top_ps[slot] = 1.0
            self.slot_aidx[slot] = -1
            self._grammar.pop(slot, None)
        self.groups[rid] = g
        self._update_resv_group(rid)
        return self._beam_advance(rid, g)

    def _beam_advance(self, rid: int, g: _BeamGroup):
        """One beam select over the group's pending logp; fork the caches
        along the chosen parents (or finalize at the last select). The
        selection and fork math are ``paged_beam_search``'s."""
        k = g.req.num_beams
        t0 = time.perf_counter()
        (g.running_lp, g.seqs, g.fin_seqs, g.fin_scores, new_beam,
         new_tok) = _beam_select(
            g.running_lp, g.seqs, g.fin_seqs, g.fin_scores, g.logp, g.i,
            g.s, self.eos_token_id, float(g.req.length_penalty))
        self.stats["beam_selects"] += 1
        if g.i == g.req.max_new_tokens - 1:
            self.stats["beam_select_s"] += time.perf_counter() - t0
            return self._finalize_beam(rid, g)
        parents = new_beam.cpu().numpy()
        toks = new_tok.cpu().numpy()
        t1 = time.perf_counter()
        self.stats["beam_select_s"] += t1 - t0
        cur = g.s + g.i                       # tokens stored per beam
        nb, max_b = self.mgr.num_blocks, self.max_blocks_per_seq
        rows = np.full((k, max_b), nb, np.int32)
        copy_src = np.full(k, nb, np.int32)
        copy_dst = np.full(k, nb, np.int32)
        new_sids = {}
        for j in range(k):
            dst = self._new_sid(rid)
            pair = self._mgr_retry(self.mgr.fork,
                                   g.sid[int(parents[j])], dst, cur)
            if pair is not None:
                copy_src[j], copy_dst[j] = pair
            new_sids[j] = dst
        for j in range(k):
            self.mgr.free(g.sid[j])
        g.sid = new_sids
        for j in range(k):
            t = self._mgr_retry(                      # room for the write
                self.mgr.allocate, g.sid[j], cur + 1)
            rows[j, :len(t)] = t
        self.exe.beam_group_update(g.slots, rows, cur, copy_src, copy_dst)
        self.stats["beam_update_s"] += time.perf_counter() - t1
        self._update_resv_group(rid)
        for j, slot in enumerate(g.slots):
            self.last_tok[slot] = toks[j]
        g.i += 1
        return []

    def _finalize_beam(self, rid: int, g: _BeamGroup):
        req = g.req
        best_seq, best_score = _beam_finalize(
            g.running_lp, g.seqs, g.fin_seqs, g.fin_scores, g.s,
            req.max_new_tokens, self.eos_token_id,
            float(req.length_penalty))
        req.tokens = [int(t) for t in best_seq.cpu().numpy()[g.s:]]
        req.beam_score = float(best_score)
        req.done = True
        req.finish_reason = "beam"
        _FINISHED.inc(reason="beam")
        if req.tenant_id is not None:
            _TENANT_FINISHED.inc(tenant=tenant_label(req.tenant_id),
                                 reason="beam")
        _TOKENS.inc(len(req.tokens))
        GOODPUT.good(len(req.tokens), tenant=req.tenant_id)
        REQUESTS.tokens(req, len(req.tokens))
        REQUESTS.event(req, "kv_peak", replica=self.trace_name,
                       blocks=sum(self.kv.take_peak(s)
                                  for s in g.sid.values()))
        REQUESTS.finish(req, "beam", replica=self.trace_name)
        for sid in g.sid.values():
            self.mgr.free(sid)
        for slot in g.slots:
            self.active[slot] = False
            self.is_beam[slot] = False
            self.slot_req[slot] = -1
        self.kv.release(rid)
        del self.groups[rid]
        return [(rid, t) for t in req.tokens]

    def _prefill_chunks(self):
        """One chunk (<= max_prompt_len tokens) for every in-flight chunked
        prefill: long prompts stream in across ticks while other slots
        keep decoding. The final chunk samples the request's first token
        and activates its slot."""
        pairs = self.mgr.take_copy_plan() if hasattr(
            self.mgr, "take_copy_plan") else []
        if pairs:
            self.exe.apply_block_copies(pairs)
        if not self.prefilling:
            return []
        a_cap, cap = self.num_slots, self.max_prompt_len
        # ladder L2: shrink the per-tick chunk budget, not the staging
        # shapes — ids keeps its [a_cap, cap] shape (lens just come up
        # shorter), so no new shape reaches the chunk kernel
        budget = (cap if self.degrade is None
                  else min(cap, self.degrade.prefill_budget(cap)))
        nb, max_b = self.mgr.num_blocks, self.max_blocks_per_seq
        ids = np.zeros((a_cap, cap), np.int64)
        lens = np.zeros(a_cap, np.int32)
        offs = np.zeros(a_cap, np.int32)
        slots = np.full(a_cap, self.num_slots, np.int32)
        rows = np.full((a_cap, max_b), nb, np.int32)
        batch = list(self.prefilling.items())[:a_cap]
        row_aidx = np.full(a_cap, -1, np.int64)
        progressed = False
        staged = set()       # rows already in the batch: never evicted
        for i, (rid, (slot, consumed)) in enumerate(batch):
            if rid not in self.prefilling:   # evicted by a later row
                continue
            req = self.requests[rid]
            chunk = self._pr(req)[consumed: consumed + budget]
            t = self._allocate_or_preempt(rid, consumed + len(chunk),
                                          protect=staged)
            if t is None:
                continue         # no blocks this tick: row stays queued
            progressed = True
            staged.add(rid)
            self.kv.update(rid)
            REQUESTS.event(req, "prefill_chunk", replica=self.trace_name,
                           slot=slot, offset=consumed, tokens=len(chunk))
            ids[i, :len(chunk)] = chunk
            lens[i] = len(chunk)
            offs[i] = consumed
            slots[i] = slot
            rows[i, :len(t)] = t
            row_aidx[i] = self._req_aidx(req)
        if not progressed and not self.active.any() and not self.groups:
            # nothing decoded this tick and no prefill row got blocks even
            # though preemption could evict every OTHER prefill: the pool
            # cannot fit one chunk of the sole remaining request
            FLIGHT.record("serving.alloc_fail",
                          rids=[int(r) for r in self.prefilling],
                          **self.kv.ledger.flight_fields())
            FLIGHT.dump(reason="kv_alloc_fail")
            raise MemoryError(
                "paged pool cannot fit one prefill chunk of the remaining "
                "request(s) even after preemption — increase num_blocks or "
                "reduce max_prompt_len (chunk size)")
        if not progressed:
            return []
        logits = self.exe.prefill_chunk(ids, lens, offs, slots, rows,
                                        lora=self._lora_arg(row_aidx, cap))
        # padded sentinel rows burned device FLOPs on no request's behalf
        GOODPUT.waste("pad_rows", (a_cap - len(staged)) * cap)
        # roofline: one weight pass; each chunk attends its own tokens
        # plus everything already consumed (its offset)
        self._acc_phase("prefill", int(lens.sum()), 1,
                        self._ctx_causal(lens, offs))
        emitted = []
        done_rows = []
        for i, (rid, (slot, consumed)) in enumerate(batch):
            if rid not in self.prefilling:
                continue     # evicted mid-batch: must not re-add its row
            req = self.requests[rid]
            consumed += int(lens[i])
            if consumed < len(self._pr(req)):
                self.prefilling[rid] = (slot, consumed)
                continue
            done_rows.append((i, rid, slot))
        if done_rows:
            row_t = np.zeros(a_cap, np.float32)
            row_p = np.ones(a_cap, np.float32)
            for i, rid, slot in done_rows:
                row_t[i], row_p[i] = self._req_sampling(self.requests[rid])
                # bind grammar BEFORE the first-token sample so the mask
                # covers it (the state replays req.tokens for resumes)
                self._bind_grammar(slot, self.requests[rid])
            first = self.exe.sample(
                logits, row_t, row_p,
                bias=self._grammar_bias_rows(
                    [(i, s) for i, _, s in done_rows], a_cap))
            for i, rid, slot in done_rows:
                req = self.requests[rid]
                del self.prefilling[rid]
                if self.prefix_caching:
                    self.mgr.commit_prefix(rid, self._pr(req),
                                           adapter=req.adapter_id)
                self._activate(slot, req, row_t[i], row_p[i])
                emitted += self._emit(slot, int(first[i]))
        return emitted

    # --------------------------------------------------------- preemption
    def _preempt(self, protect_rid=None) -> bool:
        # preemption rewrites a victim's resume prompt from req.tokens —
        # tokens still in flight in the async window must land first or
        # the replayed stream would silently drop them
        self._drain_async("boundary")
        return self.sched.preempt(self, protect_rid)

    def _preempt_from(self, cand) -> bool:
        self._drain_async("boundary")
        return self.sched.preempt_from(self, cand)

    def _allocate_or_preempt(self, rid: int, n_tokens: int, protect=None):
        """mgr.allocate with out-of-blocks recovery: preempt (never
        ``rid`` itself, nor anything in ``protect`` — rows already staged
        into this tick's batch) until the allocation fits. Returns the
        table, or None when preemption is off / nothing could be freed.
        Respects OTHER requests' standing reservations."""
        protect = Scheduler._protect(protect) | {rid}
        while True:
            others = self.kv.reserved - self.kv.resv.get(rid, 0)
            need = (self.mgr.blocks_needed(n_tokens)
                    - len(self.mgr.tables.get(rid, [])))
            try:
                # chaos hook: an injected MemoryError exercises the same
                # preempt-and-retry recovery a genuinely dry pool would
                fault_point("serving.alloc", rid=rid, engine=self)
                if need > self.mgr.free_blocks - max(0, others):
                    raise MemoryError("allocation would dip into blocks "
                                      "reserved by other requests")
                return self.mgr.allocate(rid, n_tokens)
            except MemoryError:
                if not self.preemption or not self._preempt(
                        protect_rid=protect):
                    if self.preemption:
                        return None
                    # the hard failure escapes step(): leave the ledger's
                    # view of who holds the missing blocks in the ring
                    FLIGHT.record("serving.alloc_fail", rid=int(rid),
                                  **self.kv.ledger.flight_fields())
                    raise

    def _mgr_retry(self, fn, *a, protect=None):
        """Beam-group block growth with out-of-blocks recovery: route
        through greedy preemption instead of letting MemoryError escape
        ``step()`` mid-update. The group's worst-case reservation (+2
        transient fork blocks a beam) makes this unreachable while greedy
        growth respects reservations; this is the belt-and-braces path.
        ``protect``: req_ids whose prefill rows are staged but not yet
        written (evicting one would corrupt the KV writes about to
        land)."""
        while True:
            try:
                return fn(*a)
            except MemoryError:
                if not self.preemption or not self._preempt(
                        protect_rid=protect):
                    raise

    # ------------------------------------------------- speculative decode
    def _spec_probs(self, logits_row, temp, top_p):
        """Host mirror of ``decoding.filter_rows``' filtered target
        distribution for one row (temperature > 0): temperature scale →
        static top_k cut → nucleus (top_p) cut → renormalise. The accept
        rule must compare proposals against EXACTLY the distribution the
        non-spec tick samples from, or speculation would change the
        output law."""
        scaled = np.asarray(logits_row, np.float64) / temp
        if self.top_k is not None and self.top_k > 0:
            kth = np.sort(scaled)[-self.top_k]
            scaled = np.where(scaled < kth, -1e30, scaled)
        srt = np.sort(scaled)[::-1]
        e = np.exp(srt - srt[0])
        cum = np.cumsum(e / e.sum())
        cutoff = srt[int((cum < top_p).sum())]
        scaled = np.where(scaled < cutoff, -1e30, scaled)
        e = np.exp(scaled - scaled.max())
        return e / e.sum()

    def _committed_seq(self, slot: int) -> np.ndarray:
        """The slot's committed sequence: effective prompt + tokens
        generated SINCE activation (earlier generations are already baked
        into the resume prompt). Its last token is ``last_tok`` — sampled
        but not yet written to the target cache — so len == cur + 1."""
        req = self.requests[int(self.slot_req[slot])]
        g = int(self.gen[slot])
        toks = np.asarray(req.tokens[len(req.tokens) - g:], np.int32)
        return np.concatenate([self._pr(req), toks])

    def _seed_draft(self, slot: int, req):
        """Seed a freshly activated slot's draft frontier from the
        resident draft cache. The dense draft cache is per slot and
        nothing writes it while the slot is parked, so rows
        0..len(resident)-1 still hold the draft K/V of the previous
        session's committed prefix. When the new request radix-adopted a
        prefix that matches those ids, the adopted span's draft-side
        re-prefill is pure replay — skip it by advancing ``draft_cur``
        past the match (capped at the adopted span: the accept rule
        preserves the target law for ANY draft state, so a conservative
        cap costs nothing in correctness). ``PT_DRAFT_REUSE=0`` kills the
        seeding (a fresh re-feed)."""
        p = self._pr(req)
        adopted = int(req._adopted)
        self._adopted_span[slot] = min(adopted, len(p))
        reuse = 0
        if (adopted > 0 and self.draft_model is not None
                and os.environ.get("PT_DRAFT_REUSE", "1") != "0"):
            res = self._draft_resident.get(slot)
            if res is not None and len(res):
                # cap below len(p): the steady feed needs >= 1 pending
                # token so its last logit can seed the first proposal
                m = min(len(res), adopted, len(p) - 1)
                if m > 0:
                    eq = np.asarray(res[:m]) == np.asarray(p[:m])
                    reuse = int(m if eq.all() else np.argmin(eq))
        self.draft_cur[slot] = reuse
        if reuse:
            GOODPUT.saved(reuse, tenant=req.tenant_id)
            _SPEC_DRAFT_REUSE.inc(reuse)

    def _spec_draft(self, staged, seqs):
        """Draft phase: catch each staged slot's draft cache up to its
        committed frontier (chunked, for freshly admitted/replayed slots
        whose draft cache is empty), then autoregressively propose up to
        k_eff tokens a slot. Returns (props, qs) keyed by slot; qs[slot]
        is None for greedy rows, else the per-proposal draft
        distributions the accept rule needs. Re-embeds inside a slot's
        radix-adopted span bill ``replay_prefill`` waste, as the
        reference's do."""
        ns = self.num_slots
        kmax = max(k for _, _, k in staged)
        Cs = self.spec_k + 1

        # catch-up: wide chunks until every pending suffix fits the steady
        # feed (pending >= 1 always — last_tok is never in the cache)
        CH = max(self.max_prompt_len, Cs)
        while True:
            pend_len = {s: len(seqs[s]) - int(self.draft_cur[s])
                        for s, _, _ in staged}
            if max(pend_len.values()) <= Cs:
                break
            ids = np.zeros((ns, CH), np.int64)
            cl = np.zeros(ns, np.int32)
            rp = np.zeros(ns, np.int32)
            for s, rid, _ in staged:
                if pend_len[s] <= Cs:
                    continue               # already caught up: no writes
                n = min(pend_len[s] - 1, CH)   # keep >= 1 for the feed
                dc = int(self.draft_cur[s])
                ids[s, :n] = seqs[s][dc: dc + n]
                cl[s] = n
                rp[s] = dc
                # re-embedding inside the radix-adopted span is pure
                # replay (first-time prompt embedding is not waste)
                GOODPUT.waste("replay_prefill",
                              min(dc + n, int(self._adopted_span[s])) - dc,
                              tenant=self._tenant(rid))
            self.exe.draft_rows(ids, rp, cl)
            self._acc_phase("spec_draft", int(cl.sum()), 1,
                            self._ctx_causal(cl, rp))
            for s, _, _ in staged:
                self.draft_cur[s] += int(cl[s])

        # steady feed: the pending suffix (<= k+1 tokens) in one
        # fixed-width chunk; its last logit seeds the first proposal
        ids = np.zeros((ns, Cs), np.int64)
        cl = np.zeros(ns, np.int32)
        rp = np.zeros(ns, np.int32)
        for s, rid, _ in staged:
            dc = int(self.draft_cur[s])
            pend = seqs[s][dc:]
            ids[s, :len(pend)] = pend
            cl[s] = len(pend)
            rp[s] = dc
            GOODPUT.waste("replay_prefill",
                          min(dc + len(pend),
                              int(self._adopted_span[s])) - dc,
                          tenant=self._tenant(rid))
        dl = self.exe.draft_rows(ids, rp, cl)
        self._acc_phase("spec_draft", int(cl.sum()), 1,
                        self._ctx_causal(cl, rp))
        for s, _, _ in staged:
            self.draft_cur[s] += int(cl[s])      # == cur + 1 now
        last = torch.as_tensor(np.maximum(cl - 1, 0), device=dl.device)
        dlast = dl[torch.arange(ns, device=dl.device), last.long()]

        props = {s: [] for s, _, _ in staged}
        qs = {s: (None if float(self.temps[s]) == 0.0 else [])
              for s, _, _ in staged}

        def pick(slot, row):
            temp = float(self.temps[slot])
            z = np.asarray(row, np.float64) / temp
            e = np.exp(z - z.max())
            q = e / e.sum()
            qs[slot].append(q)
            return int(self._spec_rs.choice(q.size, p=q))

        def pick_all(logits_2d, rows_feeding):
            ng = [s for s in rows_feeding if float(self.temps[s]) != 0.0]
            greedy = [s for s in rows_feeding
                      if float(self.temps[s]) == 0.0]
            if greedy:           # fetch [ns] ints, never the [ns, V] block
                am = torch.argmax(logits_2d.float(), dim=-1).cpu().numpy()
                for s in greedy:
                    props[s].append(int(am[s]))
            if ng:
                # only the non-greedy rows cross to the host
                sub = logits_2d[torch.as_tensor(ng, device=logits_2d.device)]
                sub = sub.float().cpu().numpy()
                for i, s in enumerate(ng):
                    props[s].append(pick(s, sub[i]))

        pick_all(dlast, [s for s, _, _ in staged])
        # autoregressive proposal rounds (single-token feeds)
        for r in range(1, kmax):
            feeding = [s for s, _, k in staged if k > r]
            if not feeding:
                break
            ids1 = np.zeros((ns, 1), np.int64)
            cl1 = np.zeros(ns, np.int32)
            rp1 = np.zeros(ns, np.int32)
            for s in feeding:
                ids1[s, 0] = props[s][-1]
                cl1[s] = 1
                rp1[s] = int(self.draft_cur[s])
            dl1 = self.exe.draft_rows(ids1, rp1, cl1)
            self._acc_phase("spec_draft", int(cl1.sum()), 1,
                            self._ctx_causal(cl1, rp1))
            for s in feeding:
                self.draft_cur[s] += 1           # == cur + r + 1
            pick_all(dl1[:, 0], feeding)
        return props, qs

    def _spec_tick(self, elig):
        """One draft-and-verify round for the eligible slots. Returns
        (handled mask, emitted): handled slots advanced up to k_eff+1
        tokens and skip this tick's one-token path.

        Staging allocates verify coverage (cur + k_eff + 1 tokens) per
        slot BEFORE any device work, protecting already-staged rows from
        preemption — as ``_prefill_chunks`` does. The
        ``serving.spec_verify`` fault site fires before the verify
        forward, so an injected exception aborts with the cache, tables
        and ledger exactly as the staging left them (staged blocks live in
        request tables — the normal free path reclaims them) and the tick
        falls back to one-token decode for every slot."""
        handled = np.zeros(self.num_slots, bool)
        emitted: list = []
        ns = self.num_slots
        # stage: clamp k, allocate coverage for the worst case
        staged = []                        # (slot, rid, k_eff)
        staged_rids: set = set()
        for slot in np.nonzero(elig)[0]:
            slot = int(slot)
            if not self.active[slot]:
                continue                   # evicted by an earlier staging
            rid = int(self.slot_req[slot])
            k_cap = (int(self.slot_k[slot]) if self.spec_adaptive
                     else self.spec_k)
            k_eff = min(k_cap, int(self.max_gen[slot] - self.gen[slot]) - 1)
            if k_eff < 1:
                continue
            t = self._allocate_or_preempt(
                rid, int(self.cur[slot]) + k_eff + 1, protect=staged_rids)
            if t is None:
                continue                   # dry pool: one-token path
            self.kv.update(rid)
            self.table_len[slot] = len(t)
            staged.append((slot, rid, k_eff))
            staged_rids.add(rid)
        staged = [(s, r, k) for s, r, k in staged if self.active[s]]
        if not staged:
            return handled, emitted

        seqs = {s: self._committed_seq(s) for s, _, _ in staged}
        t0 = time.perf_counter()
        with self._tick_timer("draft"), \
                _span("serving.draft", slots=len(staged)):
            props, qs = self._spec_draft(staged, seqs)
        self.stats["spec_draft_s"] += time.perf_counter() - t0

        # verify: ONE batched target chunk over (slots, k_eff + 1)
        C = self.spec_k + 1
        ids = np.zeros((ns, C), np.int64)
        clens = np.zeros(ns, np.int32)
        offs = np.zeros(ns, np.int32)
        slot_ids = np.full(ns, ns, np.int32)
        rows = np.full((ns, self.max_blocks_per_seq), self.mgr.num_blocks,
                       np.int32)
        v_aidx = np.full(ns, -1, np.int64)
        for slot, rid, k_eff in staged:
            ids[slot, 0] = self.last_tok[slot]
            ids[slot, 1: 1 + k_eff] = props[slot][:k_eff]
            clens[slot] = k_eff + 1
            offs[slot] = self.cur[slot]
            slot_ids[slot] = slot
            t = self.mgr.tables[rid]
            rows[slot, :len(t)] = t
            v_aidx[slot] = self.slot_aidx[slot]
        try:
            # BEFORE the verify forward writes the pool: an exception
            # here leaves the cache as the staging left it
            fault_point("serving.spec_verify", engine=self,
                        slots=[s for s, _, _ in staged])
        except Exception as e:
            self.stats["spec_fallbacks"] += 1
            _SPEC_FALLBACKS.inc()
            FLIGHT.record("serving.spec_fallback",
                          error=f"{type(e).__name__}: {e}")
            # every drafted token of this round was burned unverified
            # (charged per slot, to the request whose draft burned)
            for _, rid, k_eff in staged:
                GOODPUT.waste("chaos_abort", k_eff, tenant=self._tenant(rid))
            for slot, _, _ in staged:
                # draft frontiers ran ahead of the commit that never
                # came; roll them back so the next round re-feeds
                self.draft_cur[slot] = min(int(self.draft_cur[slot]),
                                           int(self.cur[slot]) + 1)
                self._draft_resident[slot] = np.asarray(
                    seqs[slot][:int(self.draft_cur[slot])], np.int32)
                # staging extended the HOST table, but only the verify
                # would have installed those entries in the DEVICE row:
                # roll table_len back to what the device covers, so
                # _grow_tables re-emits the missing entries
                self.table_len[slot] = -(-int(self.cur[slot])
                                         // self.block_size)
            return np.zeros(self.num_slots, bool), []
        t0 = time.perf_counter()
        with self._tick_timer("verify"), \
                _span("serving.verify", slots=len(staged)):
            logits = self.exe.verify_chunk(
                ids, clens, offs, slot_ids, rows,
                lora=self._lora_arg(v_aidx, C)).float().cpu().numpy()
        self.stats["spec_verify_s"] += time.perf_counter() - t0
        # whole sentinel rows of the fixed-shape verify batch are waste
        GOODPUT.waste("pad_rows", (ns - len(staged)) * C)
        # roofline: one target weight pass; each verify row attends its
        # k_eff+1 chunk tokens plus the committed context at its offset
        self._acc_phase("spec_verify", int(clens.sum()), 1,
                        self._ctx_causal(clens, offs))

        # accept/commit per slot; ONE batched length rewind after
        rw_slots = np.full(ns, ns, np.int32)
        rw_lens = np.zeros(ns, np.int32)
        for slot, rid, k_eff in staged:
            temp = float(self.temps[slot])
            row = logits[slot]                        # [C, V]
            # grammar slots: reject mask-violating drafts BEFORE the
            # accept law ever sees them (k_use truncates at the first
            # illegal proposal), then bias each verify position with the
            # mask of the state reached by accepting the proposals ahead
            # of it — the accept rule compares against exactly the masked
            # distribution the non-speculative tick samples from
            g = self._grammar.get(slot)
            gb, k_use = None, k_eff
            if g is not None:
                aut, st = g[0], g[1]
                gb, k_use = [], 0
                for i in range(k_eff):
                    b = aut.bias(st)
                    gb.append(b)
                    t_i = int(props[slot][i])
                    if b[t_i] != 0.0:
                        _GRAMMAR_SPEC_REJECTS.inc(k_eff - i)
                        break
                    st = aut.advance(st, t_i)
                    k_use += 1
                if k_use == k_eff:
                    gb.append(aut.bias(st))   # the bonus position's mask
            if temp == 0.0:
                vrow = (row[: k_use + 1] if gb is None
                        else row[: k_use + 1] + np.asarray(gb, np.float32))
                vs = vrow.argmax(axis=-1)
                n_acc = int(greedy_accept_length(vs[:k_use],
                                                 props[slot][:k_use]))
                new = [int(x) for x in props[slot][:n_acc]] \
                    + [int(vs[n_acc])]
            else:
                ps = [self._spec_probs(
                          row[i] if gb is None else row[i] + gb[i],
                          temp, float(self.top_ps[slot]))
                      for i in range(k_use + 1)]
                new, n_acc = stochastic_accept_row(
                    props[slot][:k_use], qs[slot], ps, self._spec_rs)
            cur1 = int(self.cur[slot]) + n_acc + 1
            self.cur[slot] = cur1
            rw_slots[slot] = slot
            rw_lens[slot] = cur1
            # the draft frontier rolls back past rejected positions (stale
            # entries are overwritten by the next round's feed)
            self.draft_cur[slot] = min(int(self.draft_cur[slot]), cur1)
            # the token ids the draft cache now holds at 0..draft_cur-1:
            # the reuse seed for this slot's NEXT session
            self._draft_resident[slot] = np.asarray(
                np.concatenate([seqs[slot], np.asarray(new, np.int32)])
                [:int(self.draft_cur[slot])], np.int32)
            if self.spec_adaptive:
                self._acc_ema[slot] = (0.5 * self._acc_ema[slot]
                                       + 0.5 * (n_acc / k_eff))
                self.slot_k[slot] = int(np.clip(
                    round(self._acc_ema[slot] * self.spec_k), 1,
                    self.spec_k))
            self.stats["spec_proposed"] += k_eff
            self.stats["spec_accepted"] += n_acc
            _SPEC_PROPOSED.inc(k_eff)
            _SPEC_ACCEPTED.inc(n_acc)
            _SPEC_TOKENS.observe(len(new))
            GOODPUT.waste("spec_rejected", k_eff - n_acc,
                          tenant=self._tenant(rid))
            REQUESTS.spec(self.requests.get(rid), k_eff, n_acc)
            handled[slot] = True
            for tok in new:
                emitted += self._emit(slot, int(tok))
                if self.slot_req[slot] < 0:
                    break      # EOS/length finished the request mid-list
        if self.stats["spec_proposed"]:
            _SPEC_RATE.set(self.stats["spec_accepted"]
                           / self.stats["spec_proposed"])
        # one rewind for all staged rows, lengths only: the verify wrote
        # k_eff+1 positions, the commit kept n_acc+1 of them
        self.exe.rewind_lens(rw_slots, rw_lens)
        self.stats["spec_ticks"] += 1
        return handled, emitted

    def _tenant(self, rid):
        return getattr(self.requests.get(rid), "tenant_id", None)

    def _spec_on(self) -> bool:
        """The speculative gate: a draft model, ``PT_SPEC_DECODE`` not 0,
        and the ladder below L1."""
        return (self.draft_model is not None
                and os.environ.get("PT_SPEC_DECODE", "1") != "0"
                and (self.degrade is None or self.degrade.spec_enabled()))

    def _spec_would_run(self) -> bool:
        """Mirror of the synchronous tick's speculative gate: True when the
        next tick would draft and verify (host sampling every tick — the
        async window must drain for it)."""
        return self._spec_on() and bool(
            (self.active & ~self.is_beam
             & (self.max_gen - self.gen >= 2)).any())

    # ------------------------------------------------------------- decode
    def _grow_tables(self, mask):
        """At most one new block per slot per tick; returns the
        incremental (rows, cols, vals) update triple (sentinel-padded).
        ``mask``: the slots of this tick (speculation-handled slots skip
        the one-token tick; their tables grow in the verify staging)."""
        rows = np.full(self.num_slots, self.num_slots, np.int32)
        cols = np.zeros(self.num_slots, np.int32)
        vals = np.zeros(self.num_slots, np.int32)
        crossing = mask & (self.cur // self.block_size >= self.table_len)
        for slot in np.nonzero(crossing)[0]:     # <= once per bs ticks/slot
            if not self.active[slot]:
                continue                 # preempted earlier in this loop
            rid = int(self.slot_req[slot])
            t = self._allocate_or_preempt(rid, int(self.cur[slot]) + 1)
            if t is None:
                # nothing else to evict: preempt THIS slot (it re-queues
                # with its progress and resumes when blocks free up)
                if not self._preempt_from([int(slot)]):
                    raise MemoryError(
                        "paged cache out of blocks and the growing slot "
                        "is not preemptible (windowed/dynamic-rope resume "
                        "exceeds max_prompt_len)")
                continue
            self.kv.update(rid)
            # install the next entry the DEVICE row is missing — normally
            # the block just allocated, but after a spec-verify fallback
            # the host table can be ahead by more than one staged block
            idx = min(int(self.table_len[slot]), len(t) - 1)
            rows[slot] = slot
            cols[slot] = idx
            vals[slot] = t[idx]
            self.table_len[slot] = idx + 1
        if self.window is not None:
            self._recycle_window(np.nonzero(self.active & ~self.is_beam)[0])
        return rows, cols, vals

    def _emit(self, slot: int, token: int):
        """Record one sampled token for the request in ``slot``; finish on
        EOS or length. Returns [(req_id, token)]."""
        rid = int(self.slot_req[slot])
        if rid < 0:
            return []        # slot emptied mid-tick (stream-side cancel)
        req = self.requests[rid]
        req.tokens.append(token)
        _TOKENS.inc()
        GOODPUT.good(1, tenant=req.tenant_id)
        if req.tenant_id is not None:
            _TENANT_TOKENS.inc(tenant=tenant_label(req.tenant_id))
        g = self._grammar.get(slot)
        if g is not None:
            # advance the mask state past the committed token (EOS keeps
            # the state; an illegal token here would be a sampler bug and
            # raises loudly rather than derail the automaton silently)
            g[1] = g[0].advance(g[1], token)
            _GRAMMAR_TOKENS.inc()
        now = self._clock()
        if req._first_tok_t is None:
            req._first_tok_t = now
            if req._submit_t is not None:
                _TTFT.observe(max(0.0, now - req._submit_t))
                if req.tenant_id is not None:
                    _TENANT_TTFT.observe(
                        max(0.0, now - req._submit_t),
                        tenant=tenant_label(req.tenant_id))
            REQUESTS.event(req, "first_token", replica=self.trace_name,
                           slot=slot)
        elif req._last_tok_t is not None:
            _TOK_LAT.observe(max(0.0, now - req._last_tok_t))
            if req.tenant_id is not None:
                _TENANT_TOK_LAT.observe(
                    max(0.0, now - req._last_tok_t),
                    tenant=tenant_label(req.tenant_id))
        req._last_tok_t = now
        if req.stream is not None:
            req.stream(req, token)
        self.last_tok[slot] = token
        self.gen[slot] += 1
        REQUESTS.tokens(req)
        eos = self.eos_token_id is not None and token == self.eos_token_id
        if eos or self.gen[slot] >= self.max_gen[slot]:
            req.done = True
            req.finish_reason = "eos" if eos else "length"
            _FINISHED.inc(reason=req.finish_reason)
            if req.tenant_id is not None:
                _TENANT_FINISHED.inc(tenant=tenant_label(req.tenant_id),
                                     reason=req.finish_reason)
            if self.prefix_caching:
                # commit the GENERATED span too (up to the cache frontier
                # ``cur``: the token just sampled has no KV yet)
                seq = np.concatenate([req.prompt,
                                      np.asarray(req.tokens, np.int32)])
                self.mgr.commit_prefix(
                    rid, seq[:min(len(seq), int(self.cur[slot]))],
                    adapter=req.adapter_id)
            self.mgr.free(rid)
            self.kv.release(rid)
            self.active[slot] = False
            self.slot_req[slot] = -1
            self.slot_aidx[slot] = -1
            self._grammar.pop(slot, None)
            self._release_adapter(rid)
            REQUESTS.event(req, "kv_peak", replica=self.trace_name,
                           blocks=self.kv.take_peak(rid))
            REQUESTS.finish(req, req.finish_reason,
                            replica=self.trace_name)
        return [(rid, token)]

    # ------------------------------------------------------- KV handoff
    def _refuse_cp_handoff(self):
        if self.cp > 1:
            raise NotImplementedError(
                "KV handoff under context parallelism (cp>1) is not "
                "supported — a sequence's blocks are spread over the cp "
                "ranks' pools; ship from/to cp=1 replicas")

    def extract_sequence(self, rid: int) -> KVPayload:
        """Lift a prefilled or decoding greedy sequence OUT of this engine:
        gather its blocks (and an int8 pool's scale rows) into a sealed
        :class:`~paddle_tpu_torch.serving.transfer.KVPayload`, then free
        the slot, blocks and ledger entry. The request leaves with its
        tokens; the payload carries what a decode replica needs to go on
        bit-exactly (:meth:`install_sequence`). Only ACTIVE greedy slots
        are extractable: beam and mid-chunk requests raise, as do a
        multi-LoRA pin and window holes in the table."""
        self._refuse_cp_handoff()
        self._drain_async("boundary")
        slots = np.nonzero(self.slot_req == rid)[0]
        if not len(slots) or rid in self.prefilling or rid in self.groups:
            raise ValueError(f"req {rid} holds no active greedy slot")
        slot = int(slots[0])
        if self.is_beam[slot] or not self.active[slot]:
            raise ValueError(f"req {rid} holds no active greedy slot")
        if rid in self._adapter_pins:
            raise NotImplementedError(
                "cannot extract a multi-LoRA sequence — its KV was "
                "written under the adapter, and the receiving replica "
                "holds no pin on it")
        t = self.mgr.tables[rid]
        if any(b is None for b in t):
            raise NotImplementedError(
                "cannot extract a window-recycled sequence (holes in the "
                "block table)")
        cache = self.cache
        idx = torch.as_tensor(np.asarray(t, np.int64), device=cache.device)

        def gather(stores):
            return torch.stack([p.index_select(0, idx) for p in stores])
        ks = vs = None
        if cache.k_scale_store:
            # int8 pool: the codes mean nothing without their scales
            ks, vs = gather(cache.k_scale_store), gather(cache.v_scale_store)
        payload = KVPayload(
            req=self.requests[rid], cur=int(self.cur[slot]),
            gen=int(self.gen[slot]), last_tok=int(self.last_tok[slot]),
            n_blocks=len(t), block_size=self.block_size,
            k=gather(cache.k_store), v=gather(cache.v_store),
            k_scale=ks, v_scale=vs)
        # wire contract: geometry and checksums recorded while the blocks
        # are known-good, so the router can reject a partial transfer
        payload.seal()
        REQUESTS.event(payload.req, "kv_extract", replica=self.trace_name,
                       blocks=len(t), cur=int(self.cur[slot]))
        self.mgr.free(rid)
        REQUESTS.event(payload.req, "kv_peak", replica=self.trace_name,
                       blocks=self.kv.take_peak(rid))
        self.kv.release(rid)
        self.active[slot] = False
        self.slot_req[slot] = -1
        self.draft_cur[slot] = 0
        self.slot_aidx[slot] = -1
        self._grammar.pop(slot, None)
        self.sched.release(rid)
        return payload

    def snapshot_session(self, rid: int):
        """Host-side durability capture: prompt, generated ids, the
        sampling generator's state and the adapter/grammar refs of one
        in-flight request — what a surviving replica needs to resume the
        session by replaying prefill. Token ids only, never KV blocks.
        Returns None for an unknown or finished request; the
        ``serving.snapshot`` chaos site fires before the capture, so an
        injected fault skips it cleanly (the caller keeps its previous
        snapshot)."""
        req = self.requests.get(rid)
        if req is None or req.done:
            return None
        # the token list and the generator state must agree: land the
        # in-flight async ticks before capturing either
        self._drain_async("boundary")
        if req.done:
            return None
        fault_point("serving.snapshot", engine=self, rid=rid)
        snap = SessionSnapshot(
            req_id=rid, prompt=req.prompt, tokens=tuple(req.tokens),
            session_id=req.session_id, tenant_id=req.tenant_id,
            adapter_id=req.adapter_id, grammar=req.grammar,
            rng=self.exe.gen.get_state(), gen=len(req.tokens),
            captured_t=self.sched.clock())
        _SNAPSHOTS.inc()
        return snap

    def install_sequence(self, payload: KVPayload) -> bool:
        """Adopt a sequence extracted from another replica: write its
        blocks into this pool, its block-table row and length, and
        activate a slot mid-decode. Every write goes into the pool's
        tensors in place (``index_copy_``), never rebinding them, so the
        captured tick graphs stay valid. Returns False (payload
        untouched, no state changed) when no slot or not enough blocks
        are free — the router retries later."""
        self._refuse_cp_handoff()
        self._drain_async("boundary")
        if self._draining:
            raise EngineDrainingError(
                "engine is draining — finishing in-flight requests, "
                "admitting nothing new")
        req = payload.req
        if req.adapter_id is not None:
            raise NotImplementedError(
                "multi-LoRA sequences do not ride the KV handoff (the "
                "payload's KV depends on adapter weights this engine "
                "has not pinned)")
        if payload.block_size != self.block_size:
            raise ValueError(f"block_size mismatch: payload "
                             f"{payload.block_size} != {self.block_size}")
        cache = self.cache
        pool = cache.k_pools[0]
        if (payload.k.shape[0] != len(cache.k_store)
                or tuple(payload.k.shape[2:]) != tuple(pool.shape[1:])):
            raise ValueError("KV payload geometry does not match this "
                             "engine's pool (layers/heads/head_dim)")
        if (payload.k_scale is not None) != bool(cache.k_scale_store):
            raise ValueError("KV payload quantization does not match this "
                             "engine's pool — source and target replicas "
                             "must share kv_dtype")
        if payload.k.dtype != pool.dtype:
            raise ValueError(f"KV payload dtype {payload.k.dtype} does not "
                             f"match this engine's pool ({pool.dtype})")
        if payload.k.shape[1] * self.block_size < payload.cur:
            raise ValueError(f"KV payload holds {payload.k.shape[1]} blocks, "
                             f"too few for cur={payload.cur}")
        if payload.cur + self._remaining(req) > self.max_seq_len:
            raise ValueError("sequence + remaining tokens exceeds this "
                             "engine's max_seq_len")
        rid = req.req_id
        if rid in self.requests:
            raise ValueError(f"req_id {rid} already exists")
        free = np.nonzero(self.slot_req < 0)[0]
        wc = self.mgr.blocks_needed(payload.cur + self._remaining(req))
        if not len(free) or wc > self.mgr.free_blocks - self.kv.reserved:
            return False
        slot = int(free[0])
        self.sched.adopt(req)
        self.kv.begin(rid, wc)
        try:
            t = self.mgr.allocate(rid, payload.cur)
        except MemoryError:
            self.kv.release(rid)
            self.sched.release(rid)
            return False
        self.kv.update(rid)
        # the installed blocks are NOT committed to the prefix cache (the
        # admission path matches before allocating; committing here could
        # duplicate content already parked): sharing is lost, never
        # correctness
        n = len(t)
        dev = cache.device
        idx = torch.as_tensor(np.asarray(t, np.int64), device=dev)
        pairs = [(cache.k_store, payload.k), (cache.v_store, payload.v)]
        if payload.k_scale is not None:
            pairs += [(cache.k_scale_store, payload.k_scale),
                      (cache.v_scale_store, payload.v_scale)]
        for stores, blocks in pairs:
            for li, store in enumerate(stores):
                store.index_copy_(0, idx, blocks[li, :n].to(dev))
        row = np.full(self.max_blocks_per_seq, self.mgr.num_blocks, np.int32)
        row[:n] = t
        cache.block_tables[slot].copy_(torch.as_tensor(row, device=dev))
        cache.lens[slot] = payload.cur
        self.slot_req[slot] = rid
        self.active[slot] = True
        self.is_beam[slot] = False
        self.cur[slot] = payload.cur
        self.gen[slot] = payload.gen
        self.max_gen[slot] = payload.gen + self._remaining(req)
        self.table_len[slot] = n
        self.last_tok[slot] = payload.last_tok
        temp, top_p = self._req_sampling(req)
        self.temps[slot] = temp
        self.top_ps[slot] = top_p
        self._adm_counter += 1
        self.adm_order[slot] = self._adm_counter
        self.slot_aidx[slot] = -1
        # a grammar request resumes mid-stream: the mask state replays the
        # tokens it generated on the prefill replica
        self._bind_grammar(slot, req)
        # empty draft frontier: the speculative path re-feeds the whole
        # committed sequence through this engine's draft cache
        self.draft_cur[slot] = 0
        self.slot_k[slot] = self.spec_k
        self._acc_ema[slot] = 1.0
        REQUESTS.event(req, "kv_install", replica=self.trace_name,
                       blocks=payload.n_blocks, cur=payload.cur)
        return True

    # ------------------------------------------------- roofline anatomy
    @contextmanager
    def _tick_timer(self, name: str):
        """Accumulate a named slice of the CURRENT tick's wall time (the
        tick total's clock, so the breakdown reconciles)."""
        t = time.monotonic()
        try:
            yield
        finally:
            self._tick_phase[name] = (self._tick_phase.get(name, 0.0)
                                      + time.monotonic() - t)

    def _acc_phase(self, phase: str, tokens: int, passes: int, ctx: int):
        """Add one forward's roofline counts to a phase's cumulative
        [seconds, tokens, weight passes, KV-read positions] row (seconds
        arrive separately, from the tick timer in ``step``)."""
        row = self._phase_acc[phase]
        row[1] += tokens
        row[2] += passes
        row[3] += ctx

    def _ctx_blocks(self, mask) -> int:
        """Sum of the block-rounded attended context over masked slots:
        the paged decode kernel walks whole blocks of the table, so a
        single-query tick reads ceil(len/block)*block positions a slot."""
        lens = self.cur[mask] + 1
        bs = self.block_size
        return int((-(-lens // bs) * bs).sum())

    @staticmethod
    def _ctx_causal(lens, offs) -> int:
        """Sum of attended (query, position) pairs of a causal chunk
        batch: a chunk of L tokens at offset O attends L*O + L(L+1)/2."""
        ls = np.asarray(lens, np.int64)
        os_ = np.asarray(offs, np.int64)
        return int((ls * os_ + ls * (ls + 1) // 2).sum())

    def _push_roofline(self):
        """Fold the cumulative phase accumulators through the roofline
        choke point (lifetime-average MFU/MBU per phase)."""
        if self._geom is None:
            return
        for phase, (sec, tok, passes, ctx) in self._phase_acc.items():
            if sec <= 0.0 or tok <= 0:
                continue
            geom = self._draft_geom if phase == "spec_draft" else self._geom
            if geom is None:
                continue
            record_serving_throughput(
                phase, seconds=sec, tokens=tok, weight_passes=passes,
                kv_read_positions=ctx, geom=geom,
                peak_flops=self._peak_flops, peak_hbm_bps=self._peak_hbm)

    # --------------------------------------------------------------- tick
    def _refresh_gauges(self):
        if self.async_depth:
            _ASYNC_DEPTH.set(self.async_depth)
        _QUEUE_DEPTH.set(len(self.queue))
        _ACTIVE_SLOTS.set(int(self.active.sum()))
        used = self.mgr.num_blocks - self.mgr.free_blocks
        _KV_IN_USE.set(used)
        _KV_UTIL.set(used / self.mgr.num_blocks if self.mgr.num_blocks
                     else 0.0)
        self.kv.push_prefix_metrics()
        if self.cp > 1:
            # the axis and each rank's blocks under the contiguous split;
            # silent at cp = 1
            from paddle_tpu_torch.serving.cp import (_CP_AXIS,
                                                     _CP_SHARD_BLOCKS,
                                                     shard_occupancy)
            _CP_AXIS.set(self.cp)
            ids = (b for t in self.mgr.tables.values() for b in t)
            for sh, n in enumerate(shard_occupancy(
                    ids, self.mgr.num_blocks, self.cp)):
                _CP_SHARD_BLOCKS.set(n, shard=str(sh))
        led = self.kv.ledger
        if led.enabled:
            led.publish(bytes_per_block=cache_block_bytes(self.cache),
                        resident_tokens=int(self.cur[self.active].sum())
                        + sum(c for _, c in self.prefilling.values()))
        GOODPUT.refresh_gauge()
        # the control loops ride the gauge sweep's cadence; a controller
        # or tracker a router claimed is polled by the router only, so N
        # replicas sharing it don't multiply its clock by N
        if self.degrade is not None and self.degrade.owner in (None, self):
            self.degrade.poll()
        if self.slo is not None and self.slo.owner in (None, self):
            self.slo.poll()
        self._push_roofline()

    def step(self):
        """One engine tick (see :meth:`_step_impl`), wrapped so the tick
        lands in the trace timeline and the tick histograms even when a
        chaos rule or a dry pool raises out of the middle. The tick's
        anatomy (prefill/draft/verify/sample slices timed by
        :meth:`_tick_timer`, host = the remainder) goes to the breakdown
        histogram: all five phases observe every tick, so the five
        observations sum to the tick's total by construction."""
        t0 = time.monotonic()
        self._tick_phase = {}
        try:
            with _span("serving.step"), replicated_tokens():
                return self._step_impl()
        finally:
            total = time.monotonic() - t0
            ph = self._tick_phase
            timed = sum(ph.values())
            for name in ("prefill", "draft", "verify", "sample"):
                _TICK_BREAKDOWN.observe(ph.get(name, 0.0), phase=name)
            _TICK_BREAKDOWN.observe(max(0.0, total - timed), phase="host")
            _TICK.observe(total)
            # usage metering: bill this tick's device time and KV
            # occupancy to the tenants holding state — the same `total`
            # the histogram just observed, so the ledger's device-seconds
            # reconcile with serving_tick_seconds tick for tick
            if self.slo is not None:
                self.slo.charge_tick(self, total)
            acc = self._phase_acc
            acc["prefill"][0] += ph.get("prefill", 0.0)
            acc["spec_draft"][0] += ph.get("draft", 0.0)
            acc["spec_verify"][0] += ph.get("verify", 0.0)
            acc["decode"][0] += ph.get("sample", 0.0)
            # host work done under an in-flight async dispatch was folded
            # into the "sample" slice above (device-overlapped wall time);
            # it is surfaced here, so "host" reports only exposed host
            # time while the five-phase sum still equals the tick total
            if self.async_depth:
                _TICK_HIDDEN.observe(self._hidden_acc)
                self._hidden_acc = 0.0
            self._refresh_gauges()

    def _step_impl(self):
        """Exception-atomicity shim around :meth:`_step_inner` for the
        async pipeline: a fault raised mid-step while dispatched ticks are
        in flight must not strand their tokens — drain the window (its
        emissions are exactly the tokens the synchronous engine produced
        in the preceding steps), then re-raise. With an empty window this
        adds nothing to the synchronous path."""
        try:
            return self._step_inner()
        except BaseException:
            if self._async_win:
                self._drain_async("exception")
            raise

    # -------------------------------------------- async pipelined decode
    def _async_block_reason(self):
        """Why the NEXT tick cannot cruise in the async pipeline — None
        means pure decode (dispatch without fetching). Any other reason
        drains the window first, then the step runs the synchronous path,
        so table mutations, host sampling and the ledger stay tick-exact:

        admit    requests waiting for admission (the scheduler runs)
        prefill  chunked prefill in flight
        beam     beam groups need the host's select and fork every tick
        finish   no plain active slot (the drain emits the tail; run()
                 ends)
        grammar  constrained slots need the host automaton per token
        adapter  multi-LoRA rows compose per-slot corrections host-side
        window   sliding-window recycling mutates tables every tick
        spec     draft-and-verify samples on the host this tick
        growth   a slot would cross a block boundary within the window

        ``mode`` is a prefill-only replica or a cp > 1 engine."""
        if self.prefill_only or self.cp > 1:
            return "mode"
        if self.queue:
            return "admit"
        if self.prefilling:
            return "prefill"
        if self.groups or self.is_beam.any():
            return "beam"
        act = self.active & ~self.is_beam
        if not act.any():
            return "finish"
        if self._grammar:
            return "grammar"
        if self._adapter_pins:
            return "adapter"
        if self.window is not None:
            return "window"
        if self._spec_would_run():
            return "spec"
        # the host ``cur`` mirror lags by the window length: the tick
        # about to be dispatched writes position cur + len(win), which
        # must already have a table entry (cruise never mutates tables)
        d = len(self._async_win)
        if (((self.cur[act] + d) // self.block_size)
                >= self.table_len[act]).any():
            return "growth"
        return None

    def _async_step(self):
        """One cruise tick of the depth-K pipeline: dispatch the next
        decode tick with the PREVIOUS tick's tokens still on the device,
        then — once the window exceeds ``async_depth`` — fetch and emit
        the OLDEST tick's tokens while the newer ones run. The EOS /
        max-gen stop is evaluated on the device, so a slot that finished
        at tick N is masked out of tick N+1 before the host sees its
        token."""
        act = self.active & ~self.is_beam
        # chaos parity with the synchronous tick: these sites fire BEFORE
        # the dispatch, so an injected exception aborts with the cache,
        # tables and ledger untouched (the shim drains the window)
        if self._is_moe:
            fault_point("serving.moe_dispatch", engine=self,
                        slots=np.nonzero(act)[0])
        if self.cache.k_scale_store:
            fault_point("serving.kv_quant", engine=self,
                        slots=np.nonzero(act)[0])
        if not self._async_live:
            # window start: seed the device loop state from the host
            # mirrors (exact — the window was just drained)
            self.exe.async_begin(
                self.last_tok, self.gen, self.max_gen,
                -1 if self.eos_token_id is None else int(self.eos_token_id))
        rng_before = self.exe.gen.get_state()
        with self._tick_timer("sample"):
            tick = self.exe.decode_tick_async(act, self.temps, self.top_ps)
        self._async_live = True
        self._async_rewound = False
        self._async_win.append({"tick": tick, "rng_before": rng_before})
        self.stats["ticks"] += 1
        emitted = []
        if len(self._async_win) > self.async_depth:
            # steady state: drain exactly the oldest tick. The guard keeps
            # a stream-callback cancel() from draining the window out from
            # under us (it detaches at once; the dead slot's rows still in
            # flight count as async_overrun)
            self._async_draining = True
            try:
                emitted += self._drain_one()
            finally:
                self._async_draining = False
        return emitted

    def _drain_one(self):
        """Fetch and emit the oldest dispatched tick. The host mirrors
        (``cur``/``gen``/``last_tok``) advance HERE, so at every drain
        boundary they hold exactly the synchronous engine's values. A
        fully masked tick (every slot stopped on the card before the host
        noticed) emits nothing and rewinds the generator to its state
        before that tick: the synchronous engine never ran it, so never
        drew its noise."""
        e = self._async_win.pop(0)
        t0 = time.monotonic()
        nxt, ran = e["tick"].fetch()
        t1 = time.monotonic()
        # the fetch waits until that tick's device work completes:
        # device-overlapped wall time, billed to the "sample" slice
        self._tick_phase["sample"] = (self._tick_phase.get("sample", 0.0)
                                      + t1 - t0)
        if not ran.any():
            if not self._async_rewound:
                self.exe.gen.set_state(e["rng_before"])
                self._async_rewound = True
            return []
        # roofline billed at drain, where cur is tick-exact: one weight
        # pass, each ran slot read its block-rounded context
        self._acc_phase("decode", int(ran.sum()), 1, self._ctx_blocks(ran))
        live = ran & (self.slot_req >= 0)
        over = int(ran.sum() - live.sum())
        if over:
            # rows that ran on the card for a slot the host has since
            # torn down (a stream-callback cancel mid-window): the
            # synchronous engine never computed these tokens
            self.stats["async_overrun"] += over
            GOODPUT.waste("async_overrun", over)
        self.cur += live
        t2 = time.monotonic()
        emitted = []
        for slot in np.nonzero(live)[0]:
            emitted += self._emit(int(slot), int(nxt[slot]))
        t3 = time.monotonic()
        if self._async_win:
            # successors are still in flight: this host work is hidden
            # under device work. Fold it into the "sample" slice and the
            # hidden-host histogram; the final entry's emit is exposed
            # host time and falls through to the "host" remainder
            self._hidden_acc += t3 - t2
            self._tick_phase["sample"] = (
                self._tick_phase.get("sample", 0.0) + t3 - t2)
        return emitted

    def _drain_async(self, why: str):
        """Drain the whole window (fetch and emit every dispatched tick),
        leaving the host mirrors tick-exact and the device loop state
        discarded (the next cruise re-seeds it). A no-op when the window
        is empty or a drain is already on the stack (a stream callback's
        re-entry)."""
        if not self._async_win or self._async_draining:
            return []
        self._async_draining = True
        try:
            emitted = []
            while self._async_win:
                emitted += self._drain_one()
            self._async_live = False
            _ASYNC_DRAINS.inc(why=why)
            return emitted
        finally:
            self._async_draining = False

    def _step_inner(self):
        # chaos hooks: serving.tick may raise or stall; serving.preempt
        # rules receive the engine and typically call engine._preempt() to
        # induce a preemption the pool never asked for. Both fire before
        # any mutation of the step
        fault_point("serving.tick", engine=self)
        fault_point("serving.preempt", engine=self)
        self.sched.expire(self.cancel)
        emitted = []
        if self.async_depth:
            why = self._async_block_reason()
            if why is None:
                return self._async_step()
            if self._async_win:
                # boundary: land every in-flight tick before the host
                # mutates tables or slots — the drained emissions belong
                # to this step's return
                emitted += self._drain_async(why)
        for rid in list(self.groups):
            emitted += self._beam_advance(rid, self.groups[rid])
        admits, beam_admits = self.sched.select_admissions(self)
        with self._tick_timer("prefill"):
            emitted += self._prefill(admits, beam_admits)
            emitted += self._prefill_chunks()
        if self.prefill_only:
            # prefill-role replica: newly activated slots carry their
            # first token; the router extracts them — never decode here
            return emitted
        if not self.active.any():
            return emitted
        # speculative draft-and-verify for eligible slots; the one-token
        # tick then covers only what speculation did not handle (beam
        # slots, final-token slots, a fallback after an injected verify
        # fault)
        spec_handled = np.zeros(self.num_slots, bool)
        if self._spec_on():
            elig = (self.active & ~self.is_beam
                    & (self.max_gen - self.gen >= 2))
            if elig.any():
                spec_handled, spec_emitted = self._spec_tick(elig)
                emitted += spec_emitted
        run_mask = self.active & ~spec_handled
        if not run_mask.any():
            return emitted
        if self._is_moe:
            # chaos: fires BEFORE table growth and the tick's in-place
            # cache writes, so an injected exception aborts the tick with
            # the cache, tables and table_len untouched — cancel/free
            # reclaims every block and assert_quiescent stays clean
            fault_point("serving.moe_dispatch", engine=self,
                        slots=np.nonzero(run_mask)[0])
        if self.cache.k_scale_store:
            # chaos: the tick's quantize-on-write is about to run (int8
            # pools only). Fires before table growth and the in-place
            # writes, so an injected exception leaves pools, scale pools,
            # tables and the ledger untouched (exception-atomic)
            fault_point("serving.kv_quant", engine=self,
                        slots=np.nonzero(run_mask)[0])
        if self.cp > 1:
            # chaos: the tick is about to run the cross-rank partial
            # merge. Fires before table growth and the in-place writes,
            # so an injected exception leaves the cache, tables,
            # table_len and the ledger untouched (exception-atomic)
            fault_point("serving.cp_gather", engine=self,
                        slots=np.nonzero(run_mask)[0])
        rows, cols, vals = self._grow_tables(run_mask & ~self.is_beam)
        # growth may have preempted slots — recompute the mask after it
        run_mask = self.active & ~spec_handled
        # roofline: one weight pass over the batch; every running slot
        # reads its whole block-rounded context and writes one position
        self._acc_phase("decode", int(run_mask.sum()), 1,
                        self._ctx_blocks(run_mask))
        d_aidx = np.where(run_mask, self.slot_aidx, -1)
        lora = self._lora_arg(d_aidx, 1)
        t1 = time.perf_counter()
        bias = self._grammar_bias_rows(
            [(int(s), int(s)) for s in np.nonzero(run_mask)[0]],
            self.num_slots)
        self.stats["bias_s"] += time.perf_counter() - t1
        if bias is not None:
            self.stats["grammar_ticks"] += 1
            if lora is not None:
                self.stats["lora_grammar_ticks"] += 1
        t_tick = time.perf_counter()
        with self._tick_timer("sample"):
            nxt, logp = self.exe.decode_tick(
                self.last_tok, run_mask, rows, cols, vals, self.temps,
                self.top_ps, bool(self.groups), lora=lora, bias=bias)
        if self.cp > 1:
            from paddle_tpu_torch.serving.cp import _CP_GATHER_S
            _CP_GATHER_S.observe(time.perf_counter() - t_tick)
        for g in self.groups.values():        # on the device, lazily
            g.logp = logp[torch.as_tensor(g.slots, device=logp.device)]
        self.cur += run_mask
        for slot in np.nonzero(run_mask & ~self.is_beam)[0]:
            emitted += self._emit(int(slot), int(nxt[slot]))
        self.stats["ticks"] += 1
        return emitted

    def run(self) -> dict:
        """Drain queue + slots; returns {req_id: generated token list}."""
        while self.has_work():
            self.step()
        return {rid: r.tokens for rid, r in self.requests.items()}
