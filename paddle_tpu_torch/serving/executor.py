"""ModelExecutor: the device half of the engine — counterpart of
``paddle_tpu/serving/executor.py`` (single device).

Owns the paged KV cache, the draft model's dense cache and the sampling
generator, and runs the forwards the tick needs: slot-aware prefill,
chunked prefill, the speculative verify chunk and length rewind, the
draft model's row forward, the fused decode tick (and its pipelined
twin), the radix prefix cache's block copies, and row sampling. Callers
hand in fixed-shape numpy staging arrays; the forwards update the caches
in place (see ``models/paged.py``). ``lora`` arguments are the engine's
host description of a multi-LoRA batch (``{"perm", "inv", "gs",
"aidx"}`` int32 numpy arrays, see ``models/paged.py`` ``_lora_delta``);
the executor adds the adapter store's stacks and moves the indices to
the device.

On a CUDA device the decode tick is the port's counterpart of the
reference's jitted tick: a :class:`TickGraph`, the tick's device work
(``models/paged.py`` ``decode_tick_rows``) captured once per executor in
a ``torch.cuda.CUDAGraph`` at its fixed shape and replayed every tick.
Its inputs go through one pinned host buffer and one non-blocking copy
into a static device buffer; the sampled tokens come back through one
pinned buffer, and waiting for them is the tick's only synchronisation.
The async tick is a second graph whose loop state (tokens, stop mask,
tokens generated, their limit, EOS) stays on the device between
replays. With an adapter store, a third graph is the tick with the
multi-LoRA correction: it reads the store's stacks (uploads write into
them in place) and static index buffers that each such tick fills
before the replay; a tick with no adapter row replays the base graph.
The biased graph is the synchronous tick plus a static [num_slots, V]
fp32 logit bias (grammar masks: 0 where legal, -1e30 elsewhere, exact
zeros on free rows), filled through one pinned buffer and replayed only
for a tick with a grammar-bound row; a tick without one replays the
unbiased graph. A tick with both adapter rows and grammar rows runs the
eager tick on the card (the same kernels, launched one by one; the
engine's ``stats["lora_grammar_ticks"]`` counts them). Beam groups
reorder the cache with :meth:`ModelExecutor.beam_group_update`, which
writes the tables, lengths and forked blocks IN PLACE, and read their
fp32 logits from the replayed graph's output
(:attr:`ModelExecutor.tick_logits`); their log-softmax runs outside the
graph. All graphs are captured when the executor is built, so their cost
is the engine's start-up and a capture that fails raises from the
constructor: there is no eager fallback for a tick a graph serves. On
the CPU the same functions run eagerly.

``cp > 1`` (context parallelism): one process a rank of the first ``cp``
ranks of the world (``torch.distributed`` initialised; the executor's
``mesh`` is ``HybridMesh(cp=cp)`` over them). Each rank holds ``num_blocks
/ cp`` blocks of every pool (rank s the global ids [s*per, (s+1)*per),
its scale pools alike) and the whole model; the block tables, lengths and
activations are replicated with global ids, and every forward runs with
``cp_axis="cp"`` inside the mesh (``models/paged.py``: local writes, K3
and K4 in their partials mode, the merges over cp), so every rank samples
the same tokens from the same seeded generator. The cp tick runs eagerly
on the card: no graph is captured (its merges are collectives).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

import contextlib

from paddle_tpu_torch.core.device import CAPTURE_LOCK
from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.models.decoding import KVCache, _sample_rows
from paddle_tpu_torch.models.paged import (PagedKVCache,
                                           _beam_group_update,
                                           decode_tick_rows,
                                           llama_decode_tick,
                                           llama_decode_tick_async,
                                           llama_prefill_chunk_paged,
                                           llama_prefill_paged,
                                           llama_verify_chunk_paged,
                                           model_config, prefix_cow_update,
                                           spec_rewind_lens)
from paddle_tpu_torch.models.speculative import _forward_rows

_LORA_KEYS = ("perm", "inv", "aidx", "gs")


def _cache_ptrs(cache) -> tuple:
    """Where the cache's tensors stand: the pools, scale pools, tables and
    lengths a captured tick reads and writes in place."""
    return tuple(t.data_ptr() for t in (
        *cache.k_store, *cache.v_store, *cache.k_scale_store,
        *cache.v_scale_store, cache.block_tables, cache.lens))


class TickGraph:
    """``fn`` captured in a CUDA graph. ``fn`` reads only tensors that
    exist before the capture (static inputs, the model, the cache) and
    returns its outputs, which live in the graph's private pool
    (``pool_bytes``: the device memory reserved during the capture).

    Before the capture ``fn`` runs once eagerly on a side stream (library
    handles, kernel loads); the caller arranges for that run to change
    nothing (every row inactive), and the generator ``gen`` is put back
    to its state before it. ``gen`` is registered with the graph, so each
    replay draws new noise from its current state and advances it as an
    eager call would. The kernel wrappers count their launches in Python,
    which runs at capture only: the capture's counts are taken back and
    added again at every replay, so the counters count device launches.
    The warm-up and the capture hold ``core.device.CAPTURE_LOCK``, and
    Python's cyclic garbage collector is run before the capture and held
    off during it: a collection inside the capture could free an earlier
    engine's graph, and destroying a graph while a stream captures
    invalidates the capture."""

    def __init__(self, fn, cache, gen):
        # no other thread's CUDA call (a /memory scrape, a /profile
        # capture, the metrics shipper) may land inside the capture
        with CAPTURE_LOCK:
            self._capture(fn, cache, gen)

    def _capture(self, fn, cache, gen):
        from paddle_tpu_torch.ops import cuda as K
        self._ptrs = _cache_ptrs(cache)
        state = gen.get_state()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        gen.set_state(state)
        counts, routes = K.launches(), K.route_launches()
        gc.collect()
        # the capture empties the allocator's cache first: do it before
        # reading what is reserved, so the difference is the graph's pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing: take back what it counted
            self.launches = {k: v - counts[k] for k, v in
                             K.launches().items() if v != counts[k]}
            self.route_launches = {
                k: {r: n - routes[k][r] for r, n in per.items()}
                for k, per in K.route_launches().items()}
            K.add_launches(self.launches, self.route_launches, -1)
            gen.set_state(state)
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def replay(self, cache):
        if _cache_ptrs(cache) != self._ptrs:
            raise RuntimeError(
                "the KV cache's tensors moved since the decode tick was "
                "captured: the pools, tables and lengths must be written "
                "in place")
        from paddle_tpu_torch.ops import cuda as K
        self.graph.replay()
        K.add_launches(self.launches, self.route_launches)


class AsyncTick:
    """One dispatched async tick: ``fetch()`` gives its (sampled tokens
    [B] int64, ran mask [B] bool) as numpy, waiting on the card only for
    this tick."""

    def __init__(self, values=None, host=None, event=None):
        self._values, self._host, self._event = values, host, event

    def fetch(self):
        if self._values is None:
            self._event.synchronize()
            self._values = (self._host[0].copy(),
                            self._host[1].astype(bool))
        return self._values


class ModelExecutor:
    """Prefill/decode programs over one paged KV pool on ``device``
    (``kv_dtype="int8"``: an int8 pool with fp32 scale pools).
    ``async_depth``: the most async ticks the engine keeps in flight.
    ``tick_log``: None, or a list that each decode tick on the card
    appends (kind, wall seconds of the call, start event, end event) to,
    the events around its replay. ``adapter_store``: the engine's
    ``AdapterStore`` (multi-LoRA ticks); ``draft_model``: the
    speculative draft, decoding into a dense cache of ``max_seq_len +
    spec_k + 2`` positions a slot. ``cp``: the context-parallel degree
    (module docstring)."""

    def __init__(self, model, *, num_slots, num_blocks, block_size,
                 max_blocks_per_seq, top_k=None, seed=0, kv_dtype=None,
                 async_depth=0, adapter_store=None, draft_model=None,
                 spec_k=4, max_seq_len=None, device, cp=1):
        cfg = model_config(model)
        self.model = model
        self.top_k = top_k
        self.device = torch.device(device)
        self.gen = generator(seed, self.device)
        self.cp = int(cp)
        self.mesh = self._cp_mesh(num_blocks) if self.cp > 1 else None
        self._cp_axis = "cp" if self.cp > 1 else None
        self.cache = PagedKVCache.init(
            cfg.num_hidden_layers, num_blocks // self.cp, block_size,
            cfg.num_key_value_heads,
            cfg.hidden_size // cfg.num_attention_heads,
            num_slots, max_blocks_per_seq, cfg.dtype, kv_dtype=kv_dtype,
            device=self.device)
        # the tables hold GLOBAL ids: unused entries the global sentinel
        self.cache.block_tables.fill_(num_blocks)
        self.num_slots = num_slots
        self.async_depth = int(async_depth)
        self.adapter_store = adapter_store
        self.draft_model = draft_model
        self.draft_cache = None
        if draft_model is not None:
            dcfg = model_config(draft_model)
            self.draft_cache = KVCache.init(
                dcfg.num_hidden_layers, num_slots, max_seq_len + spec_k + 2,
                dcfg.num_key_value_heads,
                dcfg.hidden_size // dcfg.num_attention_heads, dcfg.dtype,
                device=self.device)
        self.tick_log = None
        self.vocab_size = cfg.vocab_size
        # the captured graphs: the synchronous tick, the async tick, the
        # multi-LoRA tick, the biased tick; _last: the graph of the last
        # synchronous tick (None after an eager one)
        self._tick = self._atick = self._ltick = self._btick = None
        self._last = None
        self._async = None          # the eager async loop state
        # graphs on the card; eager on the CPU and under cp
        self._graphs = self.device.type == "cuda" and self.cp == 1
        if self._graphs:
            self._capture_tick()
            self._capture_biased()
            if self.async_depth:
                self._capture_async()
            if adapter_store is not None:
                self._capture_lora()

    # ------------------------------------------- context parallelism
    def _cp_mesh(self, num_blocks):
        """The cp mesh over the world's first ``cp`` ranks."""
        from paddle_tpu_torch.distributed.mesh import HybridMesh, world
        rank, size = world()
        if size < self.cp:
            raise ValueError(
                f"cp={self.cp} needs a process group of {self.cp} ranks "
                f"(one process a rank, torch.distributed initialised); the "
                f"world has {size}")
        if rank >= self.cp:
            raise ValueError(f"rank {rank} is outside the cp group (ranks "
                             f"0-{self.cp - 1})")
        if num_blocks % self.cp:
            raise ValueError(f"num_blocks={num_blocks} must divide by "
                             f"cp={self.cp} (equal pools on every rank)")
        return HybridMesh(cp=self.cp, ranks=range(self.cp),
                          device=self.device)

    def _scope(self):
        """The cp mesh entered around a forward (nothing without cp)."""
        return self.mesh if self.mesh is not None else \
            contextlib.nullcontext()

    # ------------------------------------------------------------ prefill
    def _lora(self, lora):
        """The forwards' multi-LoRA dict from the engine's host index
        arrays: the store's stacks plus the indices on the device."""
        if lora is None:
            return None
        dev = {k: torch.as_tensor(np.asarray(lora[k], np.int32),
                                  device=self.device) for k in _LORA_KEYS}
        return {**self.adapter_store.stacks(), **dev}

    def prefill(self, ids, lens, slots, rows, lora=None):
        """Slot-aware padded prefill: admitted prompts written into their
        cache slots while other slots keep their decode state."""
        with self._scope():
            logits, self.cache = llama_prefill_paged(
                self.model, torch.as_tensor(ids, device=self.device), lens,
                self.cache, slots, rows, lora=self._lora(lora),
                cp_axis=self._cp_axis)
        return logits

    def prefill_chunk(self, ids, lens, offs, slots, rows, lora=None):
        """One chunk per row, written from an arbitrary offset over the
        slot's pool prefix (chunked prefill / prefix-cache resume)."""
        with self._scope():
            logits, self.cache = llama_prefill_chunk_paged(
                self.model, torch.as_tensor(ids, device=self.device), lens,
                offs, self.cache, slots, rows, lora=self._lora(lora),
                cp_axis=self._cp_axis)
        return logits

    def verify_chunk(self, ids, clens, offs, slot_ids, rows, lora=None):
        """Target forward over each slot's proposal window (speculative
        verify): the chunk program with every position's logits [A, C,
        V]."""
        with self._scope():
            logits, self.cache = llama_verify_chunk_paged(
                self.model, torch.as_tensor(ids, device=self.device), clens,
                offs, self.cache, slot_ids, rows, lora=self._lora(lora),
                cp_axis=self._cp_axis)
        return logits

    def rewind_lens(self, slots, lens):
        """Length-only rewind after a partial speculative accept."""
        self.cache = spec_rewind_lens(self.cache, slots, lens)

    def draft_rows(self, ids, rp, cl):
        """One draft-model forward over per-row chunks of the dense draft
        cache (the speculative proposal feeds); logits [B, C, V]."""
        return _forward_rows(self.draft_model, ids, self.draft_cache, rp,
                             cl)

    # ------------------------------------------------------------- decode
    @property
    def graph_pool_bytes(self) -> int:
        """Device memory the captured ticks' private pools reserved."""
        return sum(g.pool_bytes for g in (self._tick, self._atick,
                                          self._ltick, self._btick)
                   if g is not None)

    def decode_tick(self, last_tok, run_mask, rows, cols, vals, temps,
                    top_ps, need_logp=False, lora=None, bias=None):
        """The fused one-token tick: incremental table update + paged
        attention (+ the multi-LoRA correction when ``lora`` is given) +
        on-device sampling (+ the [num_slots, V] logit ``bias`` numpy
        array, grammar masks, added before it). Returns (the sampled
        [num_slots] tokens as numpy — the one per-tick device-to-host
        fetch —, the [num_slots, V] fp32 log-probs as a device tensor
        when ``need_logp``, for beam groups, else None)."""
        if not self._graphs:
            if need_logp and self.cp > 1:
                raise NotImplementedError(
                    "beam search (want_logp) under cp > 1 is not supported")
            with self._scope():
                nxt, logp, self.cache = llama_decode_tick(
                    self.model, last_tok, self.cache, run_mask, rows, cols,
                    vals, self.gen, temps, top_ps, self.top_k, need_logp,
                    lora=self._lora(lora), logit_bias=bias,
                    cp_axis=self._cp_axis)
            return nxt.cpu().numpy(), logp
        t0 = time.perf_counter()
        if lora is not None and bias is not None:
            return self._eager_tick(last_tok, run_mask, rows, cols, vals,
                                    temps, top_ps, need_logp, lora, bias, t0)
        self._update_tables(rows, cols, vals)
        st = self._stage_np
        st[0], st[1], st[2], st[3] = last_tok, run_mask, temps, top_ps
        self._inp.copy_(self._stage, non_blocking=True)
        g, kind = self._tick, "sync"
        if lora is not None:
            g, kind = self._ltick, "lora"
            li = self._l_stage_np
            for i, k in enumerate(_LORA_KEYS):
                li[self._l_at[i]:self._l_at[i + 1]] = lora[k]
            self._l_idx.copy_(self._l_stage, non_blocking=True)
        elif bias is not None:
            g, kind = self._btick, "biased"
            self._bias_stage_np[...] = bias
            self._bias.copy_(self._bias_stage, non_blocking=True)
        ev = self._replay(g)
        self._last = g
        self._out_host.copy_(g.out[0], non_blocking=True)
        self._done.record()
        self._done.synchronize()
        self._log(kind, t0, ev)
        return self._out_host.numpy().copy(), (
            torch.log_softmax(g.out[1], dim=-1) if need_logp else None)

    def _eager_tick(self, last_tok, run_mask, rows, cols, vals, temps,
                    top_ps, need_logp, lora, bias, t0):
        """The synchronous tick launched eagerly on the card (no graph
        holds adapter rows and a bias together): the same functions and
        kernels as the captured ticks, over the same cache tensors."""
        ev = None
        if self.tick_log is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        nxt, logp, self.cache = llama_decode_tick(
            self.model, last_tok, self.cache, run_mask, rows, cols, vals,
            self.gen, temps, top_ps, self.top_k, need_logp,
            lora=self._lora(lora), logit_bias=bias)
        if ev is not None:
            ev[1].record()
        self._last = None
        out = nxt.cpu().numpy()
        self._log("eager", t0, ev)
        return out, logp

    @property
    def tick_logits(self):
        """The fp32 logits [num_slots, V] of the last replayed synchronous
        tick on the card (that graph's output buffer)."""
        return self._last.out[1]

    def _capture_tick(self):
        """Static buffers and the synchronous tick's graph. ``_inp`` [4, B]
        float64 holds the tokens, the active mask, temperatures and top-p
        (all exact in float64); zeros while capturing, so the warm-up run
        has no active row and writes only the pool's sink block (the
        cache's lengths and tables stay as they are)."""
        b, dev = self.num_slots, self.device
        self._inp = torch.zeros(4, b, dtype=torch.float64, device=dev)
        self._stage = torch.zeros(4, b, dtype=torch.float64,
                                  pin_memory=True)
        self._stage_np = self._stage.numpy()
        self._upd = torch.zeros(3, b, dtype=torch.int64, pin_memory=True)
        self._upd_np = self._upd.numpy()
        self._upd_dev = torch.zeros(3, b, dtype=torch.int64, device=dev)
        self._out_host = torch.zeros(b, dtype=torch.int64, pin_memory=True)
        self._done = torch.cuda.Event()

        def tick():
            inp = self._inp
            return decode_tick_rows(self.model, inp[0].long(), self.cache,
                                    inp[1] > 0.5, self.gen, inp[2].float(),
                                    inp[3].float(), self.top_k)
        self._tick = TickGraph(tick, self.cache, self.gen)
        self._last = self._tick

    def _capture_biased(self):
        """The biased tick's graph: the synchronous tick's inputs plus
        ``_bias``, a static [num_slots, V] fp32 logit bias (filled through
        one pinned buffer before each replay) added to the logits before
        sampling. Captured with a zero bias and no active row."""
        b, v = self.num_slots, self.vocab_size
        self._bias = torch.zeros(b, v, dtype=torch.float32,
                                 device=self.device)
        self._bias_stage = torch.zeros(b, v, dtype=torch.float32,
                                       pin_memory=True)
        self._bias_stage_np = self._bias_stage.numpy()

        def tick():
            inp = self._inp
            return decode_tick_rows(self.model, inp[0].long(), self.cache,
                                    inp[1] > 0.5, self.gen, inp[2].float(),
                                    inp[3].float(), self.top_k,
                                    logit_bias=self._bias)
        self._btick = TickGraph(tick, self.cache, self.gen)

    def _capture_lora(self):
        """The multi-LoRA tick's graph: the synchronous tick's inputs plus
        ``_l_idx``, one int32 device buffer holding perm, inv, aidx [B]
        and gs [cap] (filled through one pinned buffer before each
        replay), over the store's stacks. Captured with no adapter row
        (every group empty), so the warm-up runs no product."""
        b, cap = self.num_slots, self.adapter_store.capacity
        self._l_at = (0, b, 2 * b, 3 * b, 3 * b + cap)
        self._l_stage = torch.zeros(3 * b + cap, dtype=torch.int32,
                                    pin_memory=True)
        self._l_stage_np = self._l_stage.numpy()
        self._l_idx = torch.zeros(3 * b + cap, dtype=torch.int32,
                                  device=self.device)
        at = self._l_at
        idx = {k: self._l_idx[at[i]:at[i + 1]]
               for i, k in enumerate(_LORA_KEYS)}
        idx["aidx"].fill_(-1)

        def tick():
            inp = self._inp
            return decode_tick_rows(self.model, inp[0].long(), self.cache,
                                    inp[1] > 0.5, self.gen, inp[2].float(),
                                    inp[3].float(), self.top_k,
                                    lora={**self.adapter_store.stacks(),
                                          **idx})
        self._ltick = TickGraph(tick, self.cache, self.gen)

    def _update_tables(self, rows, cols, vals):
        """``_grow_tables``' sparse update (sentinel rows dropped) applied
        to ``block_tables`` in place before the replay, through a pinned
        buffer: at most once per ``block_size`` ticks a slot."""
        rows = np.asarray(rows)
        keep = (rows >= 0) & (rows < self.num_slots)
        n = int(keep.sum())
        if not n:
            return
        u = self._upd_np
        u[0, :n] = rows[keep]
        u[1, :n] = np.asarray(cols)[keep]
        u[2, :n] = np.asarray(vals)[keep]
        d = self._upd_dev[:, :n]
        d.copy_(self._upd[:, :n], non_blocking=True)
        self.cache.block_tables[d[0], d[1]] = d[2].to(torch.int32)

    def _replay(self, g):
        """Replay ``g``; with a ``tick_log``, between two CUDA events."""
        if self.tick_log is None:
            g.replay(self.cache)
            return None
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay(self.cache)
        e1.record()
        return e0, e1

    def _log(self, kind, t0, ev):
        if ev is not None:
            self.tick_log.append((kind, time.perf_counter() - t0, *ev))

    # --------------------------------------------------------- async tick
    def async_begin(self, tokens, gen, max_gen, eos_id):
        """Seed the async loop state from the engine's host mirrors at the
        start of a window: last tokens, tokens generated and their limit
        per slot, the EOS id (-1: none); the stop mask starts clear."""
        if not self._graphs:
            dev = self.device
            self._async = dict(
                tokens=torch.as_tensor(np.asarray(tokens, np.int64),
                                       device=dev),
                stop=torch.zeros(self.num_slots, dtype=torch.bool,
                                 device=dev),
                gen=torch.as_tensor(np.asarray(gen, np.int64), device=dev),
                max_gen=torch.as_tensor(np.asarray(max_gen, np.int64),
                                        device=dev),
                eos=int(eos_id))
            return
        s = self._seed_np
        s[0], s[1], s[2], s[3], s[4] = tokens, gen, max_gen, 0, eos_id
        self._state.copy_(self._seed, non_blocking=True)

    def decode_tick_async(self, active, temps, top_ps):
        """Dispatch one pipelined tick over the device loop state (see
        :func:`~paddle_tpu_torch.models.paged.llama_decode_tick_async`):
        the tokens it samples feed the next call on the device, and the
        stop mask, counts and tokens advance there. Returns an
        :class:`AsyncTick`; on the card the call returns once the replay
        is queued."""
        if not self._graphs:
            a, dev = self._async, self.device
            with self._scope():
                nxt, ran, a["stop"], a["gen"], self.cache = \
                    llama_decode_tick_async(
                        self.model, a["tokens"], self.cache,
                        torch.as_tensor(np.asarray(active, bool),
                                        device=dev),
                        a["stop"], a["gen"], a["max_gen"], self.gen,
                        torch.as_tensor(np.asarray(temps, np.float32),
                                        device=dev),
                        torch.as_tensor(np.asarray(top_ps, np.float32),
                                        device=dev),
                        a["eos"], self.top_k, cp_axis=self._cp_axis)
            a["tokens"] = nxt
            return AsyncTick((nxt.cpu().numpy(), ran.cpu().numpy()))
        t0 = time.perf_counter()
        i = self._ring_at % len(self._ring_ev)
        self._ring_at += 1
        ev = self._ring_ev[i]
        ev.synchronize()         # the slot's last tick was drained long ago
        st = self._a_stage_np[i]
        st[0], st[1], st[2] = active, temps, top_ps
        self._a_inp.copy_(self._a_stage[i], non_blocking=True)
        tev = self._replay(self._atick)
        self._a_host[i].copy_(self._atick.out, non_blocking=True)
        ev.record()
        self._log("async", t0, tev)
        return AsyncTick(host=self._a_host_np[i], event=ev)

    def _capture_async(self):
        """The async tick's graph. ``_state`` [5, B] int64: tokens, tokens
        generated, their limit, the stop mask and the EOS id (in every
        column), updated in place by each replay; ``_a_inp`` [3, B]
        float64: the active mask, temperatures and top-p. The sampled
        tokens and the ran mask leave through a ring of pinned buffers,
        one per tick in flight (``async_depth`` + 2), each with an
        event."""
        b, dev = self.num_slots, self.device
        ring = self.async_depth + 2
        self._state = torch.zeros(5, b, dtype=torch.int64, device=dev)
        self._seed = torch.zeros(5, b, dtype=torch.int64, pin_memory=True)
        self._seed_np = self._seed.numpy()
        self._a_inp = torch.zeros(3, b, dtype=torch.float64, device=dev)
        self._a_stage = torch.zeros(ring, 3, b, dtype=torch.float64,
                                    pin_memory=True)
        self._a_stage_np = self._a_stage.numpy()
        self._a_host = torch.zeros(ring, 2, b, dtype=torch.int64,
                                   pin_memory=True)
        self._a_host_np = self._a_host.numpy()
        self._ring_ev = [torch.cuda.Event() for _ in range(ring)]
        self._ring_at = 0

        def tick():
            s, inp = self._state, self._a_inp
            nxt, ran, stop, gen, _ = llama_decode_tick_async(
                self.model, s[0], self.cache, inp[0] > 0.5, s[3].bool(),
                s[1], s[2], self.gen, inp[1].float(), inp[2].float(), s[4],
                self.top_k)
            s[0].copy_(nxt)
            s[1].copy_(gen)
            s[3].copy_(stop)
            return torch.stack([nxt, ran.long()])
        self._atick = TickGraph(tick, self.cache, self.gen)

    # ------------------------------------------------------------- misc
    def apply_block_copies(self, pairs):
        """Radix prefix cache COW plan: copy each (src, dst) pool block
        before this tick's forwards write the pool (under cp a block's src
        and dst may live on different ranks)."""
        with self._scope():
            self.cache = prefix_cow_update(self.cache, pairs,
                                           cp_axis=self._cp_axis)

    def beam_group_update(self, slots, rows, lens_val, copy_src, copy_dst):
        """Install a beam group's forked table rows and lengths at its
        slots and copy the private partial blocks (``models/paged.py``
        ``_beam_group_update``), writing into the cache's tensors in
        place — the captured ticks read them."""
        if self.cp > 1:
            raise NotImplementedError(
                "beam search under context parallelism (cp > 1) is not "
                "supported yet")
        self.cache = _beam_group_update(self.cache, slots, rows, lens_val,
                                        copy_src, copy_dst)

    def sample(self, logits, temps, top_ps, bias=None):
        """Per-row temperature/top-k/top-p sampling (host fetch).
        ``bias`` ([rows, V] numpy, 0 / -1e30) is the grammar-mask addend."""
        dev = logits.device
        return _sample_rows(
            logits.float(), self.gen,
            torch.as_tensor(np.asarray(temps, np.float32), device=dev),
            torch.as_tensor(np.asarray(top_ps, np.float32), device=dev),
            self.top_k,
            None if bias is None else torch.as_tensor(bias, device=dev)
            ).cpu().numpy()
