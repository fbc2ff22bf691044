"""ModelExecutor: the device half of the engine — counterpart of
``paddle_tpu/serving/executor.py`` (single device).

Owns the paged KV cache and the sampling generator, and runs the
forwards the tick needs: slot-aware prefill, chunked prefill, the fused
decode tick, the radix prefix cache's block copies, and row sampling.
Callers hand in fixed-shape numpy staging arrays; the forwards update the
cache in place (see ``models/paged.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.random import generator
from paddle_tpu_torch.models.decoding import _sample_rows
from paddle_tpu_torch.models.paged import (PagedKVCache, llama_decode_tick,
                                           llama_prefill_chunk_paged,
                                           llama_prefill_paged, model_config,
                                           prefix_cow_update)


class ModelExecutor:
    """Prefill/decode programs over one paged KV pool on ``device``
    (``kv_dtype="int8"``: an int8 pool with fp32 scale pools)."""

    def __init__(self, model, *, num_slots, num_blocks, block_size,
                 max_blocks_per_seq, top_k=None, seed=0, kv_dtype=None,
                 device):
        cfg = model_config(model)
        self.model = model
        self.top_k = top_k
        self.device = torch.device(device)
        self.gen = generator(seed, self.device)
        self.cache = PagedKVCache.init(
            cfg.num_hidden_layers, num_blocks, block_size,
            cfg.num_key_value_heads,
            cfg.hidden_size // cfg.num_attention_heads,
            num_slots, max_blocks_per_seq, cfg.dtype, kv_dtype=kv_dtype,
            device=self.device)

    def prefill(self, ids, lens, slots, rows):
        """Slot-aware padded prefill: admitted prompts written into their
        cache slots while other slots keep their decode state."""
        logits, self.cache = llama_prefill_paged(
            self.model, torch.as_tensor(ids, device=self.device), lens,
            self.cache, slots, rows)
        return logits

    def prefill_chunk(self, ids, lens, offs, slots, rows):
        """One chunk per row, written from an arbitrary offset over the
        slot's pool prefix (chunked prefill / prefix-cache resume)."""
        logits, self.cache = llama_prefill_chunk_paged(
            self.model, torch.as_tensor(ids, device=self.device), lens, offs,
            self.cache, slots, rows)
        return logits

    def decode_tick(self, last_tok, run_mask, rows, cols, vals, temps,
                    top_ps):
        """The fused one-token tick: incremental table update + paged
        attention + on-device sampling. Returns the sampled [num_slots]
        tokens as numpy (the one per-tick device-to-host fetch)."""
        nxt, _, self.cache = llama_decode_tick(
            self.model, last_tok, self.cache, run_mask, rows, cols, vals,
            self.gen, temps, top_ps, self.top_k)
        return nxt.cpu().numpy()

    def apply_block_copies(self, pairs):
        """Radix prefix cache COW plan: copy each (src, dst) pool block
        before this tick's forwards write the pool."""
        self.cache = prefix_cow_update(self.cache, pairs)

    def sample(self, logits, temps, top_ps):
        """Per-row temperature/top-k/top-p sampling (host fetch)."""
        dev = logits.device
        return _sample_rows(
            logits.float(), self.gen,
            torch.as_tensor(np.asarray(temps, np.float32), device=dev),
            torch.as_tensor(np.asarray(top_ps, np.float32), device=dev),
            self.top_k).cpu().numpy()
