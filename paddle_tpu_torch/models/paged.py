"""Paged KV cache + continuous batched decode — counterpart of
``paddle_tpu/models/paged.py`` (the single-device serving slice).

  * DEVICE: ``llama_prefill_paged`` (padded ragged prompts through the
    flash kernel, K2, K/V written into the block pool),
    ``llama_prefill_chunk_paged`` (chunked prefill / prefix-hit resume
    through the paged chunk kernel, K3) and ``llama_decode_step_paged`` /
    ``llama_decode_tick`` (one token per sequence through the paged decode
    kernel, K4, sampled on the device). Every rope of the three goes
    through K7 (``ops.cuda.rope``); the decode step's, over a pool of the
    model's type, through K7 folded with the pool write
    (``rope_kv_write``). A ``lora`` argument adds the batched
    multi-LoRA correction of each row's adapter to the attention
    projections (``_lora_add``: K6a's two LoRA kernels, the rank-r shrink
    and the expand that adds into the projection's output). The
    speculative verify is the chunk forward with every position's
    logits (``llama_verify_chunk_paged``), its rollback a length rewind
    (``spec_rewind_lens``).
  * HOST: the block managers — free lists, refcounts, the prefix caches
    and the radix trie — copied from the reference (pure host logic).

Where JAX returned a new cache (the jitted programs donated it), the
forwards here update ``cache`` IN PLACE (``index_put_`` into the pools,
the tables and the lengths) and return the same object. Each pool holds
one block more than ``num_blocks``: block ``num_blocks`` is the write
sink for rows the reference drops (``mode="drop"`` scatters with the
sentinel ``num_blocks``), so no scatter needs a device-to-host sync to
filter its rows. The sink is never read: attention gets the ``[:N]``
views (``cache.k_pools``), where table sentinels are clamped and masked.

Context parallelism (``cp_axis``, see the section of that name below):
each rank of a cp group holds its share of the blocks, the tables stay
global, K3 and K4 run in their partials mode over the rank's blocks and
the partials are merged over cp.

An int8 pool (``kv_dtype="int8"``) quantizes on write (``_quantize_kv``:
per-(position, KV head) absmax scales in parallel fp32 scale pools, with
the same sink block) and the paged kernels dequantize on read; the
whole-prompt prefill attends over its own pre-quantization K/V. The
pool positions a forward writes are computed once and serve every
layer's K, V and scale writes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.observability.memledger import MemLedger
from paddle_tpu_torch.ops import attention as A
from paddle_tpu_torch.ops.cuda import grouped_matmul as _gm
from paddle_tpu_torch.ops.cuda import paged_attention as _paged
from paddle_tpu_torch.ops.cuda import rope as _rope
from paddle_tpu_torch.quantization import wo_matmul as _wo
from paddle_tpu_torch.utils.faults import fault_point


@dataclass
class PagedKVCache:
    """Per-layer block pools + per-slot block tables and lengths.

    ``k_store``/``v_store``: [L] of [N + 1, block_size, H_kv, D] (block N
    is the write sink); ``block_tables`` [B, max_blocks] int32 (unused
    slots hold the sentinel N); ``lens`` [B] int32 (tokens in cache).
    An int8 pool (``init(..., kv_dtype="int8")``) adds
    ``k_scale_store``/``v_scale_store``: [L] of [N + 1, block_size, H_kv]
    fp32, element (n, o, h) the absmax/127 scale of pool row (n, o, h, :),
    with the same sink block; they are empty for a pool of the model's
    type."""
    k_store: list
    v_store: list
    block_tables: torch.Tensor
    lens: torch.Tensor
    k_scale_store: list = field(default_factory=list)
    v_scale_store: list = field(default_factory=list)

    @property
    def block_size(self):
        return self.k_store[0].shape[1]

    @property
    def num_blocks(self):
        return self.k_store[0].shape[0] - 1

    @property
    def k_pools(self):
        """[L] of [N, block_size, H_kv, D] views (the readable pool)."""
        return [p[:-1] for p in self.k_store]

    @property
    def v_pools(self):
        return [p[:-1] for p in self.v_store]

    @property
    def k_scales(self):
        """[L] of [N, block_size, H_kv] views of the scale pools (empty
        for a pool of the model's type)."""
        return [p[:-1] for p in self.k_scale_store]

    @property
    def v_scales(self):
        return [p[:-1] for p in self.v_scale_store]

    @property
    def device(self):
        return self.k_store[0].device

    @staticmethod
    def init(num_layers, num_blocks, block_size, num_kv_heads, head_dim,
             batch, max_blocks_per_seq, dtype, kv_dtype=None, device=None):
        """Zeroed pools on ``device`` (None: the card)."""
        device = resolve_device(device)
        pool_dtype, scales = dtype, 0
        if kv_dtype is not None:
            if kv_dtype not in ("int8", torch.int8):
                raise ValueError(
                    f"unsupported kv_dtype {kv_dtype!r}: only 'int8' "
                    "(per-position absmax scales) or None (model dtype)")
            pool_dtype, scales = torch.int8, num_layers

        def z(*tail, dt=pool_dtype):
            return torch.zeros((num_blocks + 1, block_size, num_kv_heads,
                                *tail), dtype=dt, device=device)
        return PagedKVCache(
            [z(head_dim) for _ in range(num_layers)],
            [z(head_dim) for _ in range(num_layers)],
            torch.full((batch, max_blocks_per_seq), num_blocks,
                       dtype=torch.int32, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            [z(dt=torch.float32) for _ in range(scales)],
            [z(dt=torch.float32) for _ in range(scales)])


# ------------------------------------------------ int8 KV quantization
def kv_quant_enabled() -> bool:
    """The ``PT_QUANT_KV`` kill switch: ``LLMEngine(kv_dtype="int8")``
    reads it at construction and keeps a pool of the model's type when it
    is 0/off."""
    return os.environ.get("PT_QUANT_KV", "1").strip().lower() \
        not in ("0", "off")


def _quantize_kv(vals):
    """Per-(position, head) symmetric int8: vals [..., H, D] -> (int8
    [..., H, D], fp32 scales [..., H]). absmax over D / 127, floored at
    1e-8 so all-zero rows (padding) have no 0/0; a division, not a
    product by the reciprocal, so the codes are the reference's bits."""
    f = vals.float()
    scale = torch.clamp(f.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _scatter_kv(cache, li, k, v, dest):
    """Write layer ``li``'s new K/V at the flat pool positions ``dest``.
    An int8 pool quantizes on write: the codes land in the pools and the
    scales in the scale pools through the SAME destinations, so codes and
    scales never desync."""
    if cache.k_scale_store:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        _scatter(cache.k_scale_store[li], ks, dest)
        _scatter(cache.v_scale_store[li], vs, dest)
    _scatter(cache.k_store[li], k, dest)
    _scatter(cache.v_store[li], v, dest)


def _pools(cache, li):
    """Layer ``li``'s readable K/V pools and scale pools (the scales None
    for a pool of the model's type), as the paged kernels take them."""
    nb = cache.num_blocks
    ks = vs = None
    if cache.k_scale_store:
        ks = cache.k_scale_store[li][:nb]
        vs = cache.v_scale_store[li][:nb]
    return cache.k_store[li][:nb], cache.v_store[li][:nb], ks, vs


class BlockManager:
    """Host-side free-list allocator for the shared block pool."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}
        self._prefix_done: dict[int, int] = {}  # free_prefix resume index
        # per-pool memory ledger: every mutation choke point below
        # notifies it (test_lint enforces the list), so the five-state
        # block classification reconciles by construction
        self.ledger = MemLedger(num_blocks, block_size)

    @property
    def free_blocks(self):
        return len(self._free)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def allocate(self, seq_id: int, n_tokens: int):
        """Ensure seq_id owns enough blocks for n_tokens; grow as needed."""
        table = self.tables.setdefault(seq_id, [])
        need = self.blocks_needed(n_tokens) - len(table)
        if need > self.free_blocks:
            raise MemoryError(
                f"paged cache out of blocks: need {need}, "
                f"free {self.free_blocks} (of {self.num_blocks})")
        for _ in range(max(need, 0)):
            blk = self._pop_free()
            table.append(blk)
            self.ledger.table_enter(seq_id, blk)
        return table

    def _pop_free(self) -> int:
        """Take one block off the free list (prefix-cache eviction hook)."""
        if not self._free:
            raise MemoryError("paged cache out of blocks")
        return self._free.pop()

    def free(self, seq_id: int):
        for b in reversed(self.tables.pop(seq_id, [])):
            if b is None:
                continue
            self.ledger.table_exit(seq_id, b)
            self._free.append(b)
        self.ledger.table_drop(seq_id)
        self._prefix_done.pop(seq_id, None)

    def free_prefix(self, seq_id: int, n_blocks: int):
        """Release the first ``n_blocks`` table entries (sliding-window
        recycling: positions below ``cur - window`` are never attended
        again — ref block-attention's window cache bound). Table POSITIONS
        are kept as ``None`` placeholders so later block indices stay
        aligned; returns the freed (position, block) pairs. Scans resume
        from the last freed index, so each block is visited once over the
        sequence's whole lifetime (not O(length^2) re-walks)."""
        table = self.tables.get(seq_id, [])
        upto = min(n_blocks, len(table))
        start = self._prefix_done.get(seq_id, 0)
        freed = []
        for idx in range(start, upto):
            if table[idx] is not None:
                freed.append((idx, table[idx]))
                self.ledger.table_exit(seq_id, table[idx], hole=True)
                self._release(table[idx])
                table[idx] = None
        if upto > start:
            self._prefix_done[seq_id] = upto
        return freed

    def _release(self, blk: int):
        """Return one block to the free list (refcount hook point)."""
        self._free.append(blk)

    def table_array(self, seq_ids, max_blocks):
        """[B, max_blocks] int32; unused slots = num_blocks (OOB sentinel,
        dropped by scatter, clamped-masked by the kernel contract)."""
        out = np.full((len(seq_ids), max_blocks), self.num_blocks, np.int32)
        for row, sid in enumerate(seq_ids):
            t = self.tables.get(sid, [])
            if self._prefix_done.get(sid, 0) == 0:   # no None placeholders
                out[row, :len(t)] = t
            else:
                for idx, b in enumerate(t):
                    if b is not None:
                        out[row, idx] = b
        return torch.from_numpy(out)


class RefBlockManager(BlockManager):
    """BlockManager + refcounts: beams FORK a sequence by sharing its full
    (immutable — the pool is append-only) blocks and privately copying only
    the partial last block. The reference's block-attention serving keeps
    the same share/copy split for beams (vLLM-style copy-on-write, but
    append-only KV means ONLY the tail block can ever need the copy)."""

    def __init__(self, num_blocks: int, block_size: int):
        super().__init__(num_blocks, block_size)
        self._rc: dict[int, int] = {}

    def allocate(self, seq_id, n_tokens):
        before = set(self.tables.get(seq_id, []))
        table = super().allocate(seq_id, n_tokens)
        for blk in table:
            if blk not in before:
                self._rc[blk] = 1
        return table

    def fork(self, src_id, dst_id, n_tokens: int):
        """dst shares src's blocks; if the last block is partial (n_tokens
        not block-aligned) dst gets a PRIVATE fresh block for it. Returns
        (src_blk, dst_blk) to copy on device, or None."""
        src = self.tables[src_id]
        table = list(src)
        copy = None
        partial = (n_tokens % self.block_size != 0 and table
                   and table[-1] is not None)
        if partial and not self.free_blocks:
            # capacity check BEFORE the retain loop: a failed fork must
            # leave refcounts untouched (callers retry after preempting —
            # a leaked retain would permanently shrink the pool)
            raise MemoryError("paged cache out of blocks for beam fork")
        for blk in (table[:-1] if partial else table):
            if blk is None:   # window-recycled placeholder: nothing shared
                continue
            self._retain(blk)
        # the fork inherits the recycled-prefix marker: table_array's fast
        # path and future free_prefix scans key on it
        if src_id in self._prefix_done:
            self._prefix_done[dst_id] = self._prefix_done[src_id]
        if partial:
            fresh = self._pop_free()
            self._rc[fresh] = 1
            copy = (table[-1], fresh)
            table[-1] = fresh
        self.tables[dst_id] = table
        for blk in table:
            if blk is not None:
                self.ledger.table_enter(dst_id, blk)
        return copy

    def free(self, seq_id):
        for blk in self.tables.pop(seq_id, []):
            if blk is None:
                continue
            self.ledger.table_exit(seq_id, blk)
            self._release(blk)
        self.ledger.table_drop(seq_id)
        self._prefix_done.pop(seq_id, None)

    def _release(self, blk):
        """Refcounted release: the block returns to the free list only at
        rc == 0 (free_prefix routes through here too, so windowed
        recycling can never double-free a beam-shared block)."""
        self._rc[blk] -= 1
        if self._rc[blk] == 0:
            del self._rc[blk]
            self._free.append(blk)

    def _retain(self, blk):
        """Take one more reference on a live block (beam fork sharing)."""
        self._rc[blk] = self._rc.get(blk, 0) + 1


class PrefixCachingBlockManager(RefBlockManager):
    """RefBlockManager + cross-request prefix reuse (ref capability:
    PaddleNLP ``llm/predict`` block-attention serving; vLLM-style
    hash-block caching).

    Every FULL block of a committed prompt gets a content chain hash
    ``sha1(parent_digest || block token bytes)`` — the digest identifies
    the whole prefix up to and including the block, so equal digests mean
    equal KV contents (the pool is append-only and KV is a deterministic
    function of the token prefix). Blocks whose refcount drops to zero
    but that carry a digest are PARKED in an LRU ``evictable`` pool (still
    resident in HBM) instead of the free list; a later request whose
    prompt chain-hashes onto them re-shares the blocks (rc+1, zero
    recompute) and prefills only the uncached suffix. When the free list
    runs dry, allocation evicts parked blocks LRU-first — so caching
    never reduces usable capacity."""

    def __init__(self, num_blocks: int, block_size: int):
        super().__init__(num_blocks, block_size)
        import collections
        self._hash_to_block: dict[bytes, int] = {}
        self._block_hash: dict[int, bytes] = {}
        self._evictable = collections.OrderedDict()   # blk -> None, LRU order
        # hit_blocks / evictions / lookup_blocks are CUMULATIVE — the
        # engine exports them as serving_prefix_* metrics (deltas pushed
        # at each gauge refresh); lookup_blocks counts the full prompt
        # blocks every match_prefix probe COULD have hit, the hit-rate
        # denominator
        self.cache_stats = {"hit_blocks": 0, "evictions": 0,
                            "lookup_blocks": 0}
        # bumped whenever the set of matchable blocks changes (eviction
        # or a new commit) — the scheduler's per-request match memo keys
        # on it, so a queued prompt is re-hashed only when a probe could
        # actually return something different
        self.cache_epoch = 0

    # ---- capacity: parked blocks are reclaimable, so they count as free
    @property
    def free_blocks(self):
        return len(self._free) + len(self._evictable)

    def _pop_free(self):
        if self._free:
            return self._free.pop()
        if self._evictable:
            blk, _ = self._evictable.popitem(last=False)     # LRU eviction
            h = self._block_hash.pop(blk, None)
            if h is not None and self._hash_to_block.get(h) == blk:
                del self._hash_to_block[h]
            self.cache_stats["evictions"] += 1
            self.cache_epoch += 1
            self.ledger.unpark(blk)
            return blk
        raise MemoryError("paged cache out of blocks")

    def _release(self, blk):
        self._rc[blk] -= 1
        if self._rc[blk] == 0:
            del self._rc[blk]
            if blk in self._block_hash:       # park, MRU end
                self._evictable[blk] = None
                self._evictable.move_to_end(blk)
                self.ledger.park(blk)
            else:
                self._free.append(blk)

    def _retain(self, blk):
        if blk in self._evictable:            # revive a parked block
            del self._evictable[blk]
            self.ledger.unpark(blk)
        super()._retain(blk)

    # ------------------------------------------------------------ hashing
    def _chain_digests(self, tokens, n_full, adapter=None):
        import hashlib
        toks = np.asarray(tokens, np.int32)
        # adapter identity seeds the chain: KV computed under one LoRA
        # adapter differs numerically from another tenant's, so two
        # tenants' identical prompts must never share blocks. None keeps
        # the empty seed.
        digest = (b"" if adapter is None
                  else hashlib.sha1(repr(adapter).encode()).digest())
        out = []
        for i in range(n_full):
            digest = hashlib.sha1(
                digest + toks[i * self.block_size:
                              (i + 1) * self.block_size].tobytes()).digest()
            out.append(digest)
        return out

    def match_prefix(self, tokens, adapter=None) -> list[int]:
        """Longest run of resident full-block prefix matches for this
        prompt. Capped at (len-1)//block_size so at least the last prompt
        token is always prefilled — its logits seed the first sample."""
        n_full = (len(tokens) - 1) // self.block_size
        self.cache_stats["lookup_blocks"] += n_full
        blocks = []
        for d in self._chain_digests(tokens, n_full, adapter):
            blk = self._hash_to_block.get(d)
            if blk is None:
                break
            blocks.append(blk)
        return blocks

    def adopt_prefix(self, seq_id, blocks):
        """Install shared cached blocks as seq_id's table prefix (rc+1
        each; parked blocks are revived). The caller prefills from
        ``len(blocks) * block_size`` onward."""
        assert seq_id not in self.tables
        for blk in blocks:
            self._retain(blk)
        self.tables[seq_id] = list(blocks)
        for blk in self.tables[seq_id]:
            self.ledger.table_enter(seq_id, blk)
        self.cache_stats["hit_blocks"] += len(blocks)
        return self.tables[seq_id]

    def commit_prefix(self, seq_id, tokens, adapter=None):
        """Register chain digests for seq_id's full prompt blocks so later
        requests can share them. First-writer-wins per digest; safe to call
        before the prefill has executed on device — any matching request's
        program consumes the pool AFTER this one's writes (both run in
        order on the same CUDA stream)."""
        table = self.tables.get(seq_id, [])
        n_full = min(len(tokens) // self.block_size, len(table))
        for i, d in enumerate(self._chain_digests(tokens, n_full, adapter)):
            blk = table[i]
            if blk is None:
                break                          # window-recycled: stop
            if d not in self._hash_to_block and blk not in self._block_hash:
                self._hash_to_block[d] = blk
                self._block_hash[blk] = d
                self.cache_epoch += 1


class PrefixMatch:
    """Longest shared TOKEN span found by
    :meth:`RadixPrefixBlockManager.match_prefix`.

    ``blocks`` are fully-shared blocks (adopted rc+1, zero copies);
    ``cow`` is the optional partial boundary share — ``(src_block,
    hit_tokens)`` with ``0 < hit_tokens < block_size`` — the adopter gets
    a private copy of ``src_block`` and prefills from token ``hit``
    inside it. ``len()`` is the number of fully-shared blocks so the
    scheduler's block-denominated reservation math stays
    manager-agnostic; truthiness is any token hit at all."""

    __slots__ = ("blocks", "token_count", "cow")

    def __init__(self, blocks, token_count, cow=None):
        self.blocks = blocks
        self.token_count = token_count
        self.cow = cow

    def __len__(self):
        return len(self.blocks)

    def __bool__(self):
        return self.token_count > 0

    def __iter__(self):
        return iter(self.blocks)

    def __repr__(self):
        return (f"PrefixMatch(blocks={self.blocks}, "
                f"token_count={self.token_count}, cow={self.cow})")


class _RadixNode:
    """One radix-trie edge: a token span owning the physical blocks that
    hold its KV. Spans start block-aligned; only a childless tail may be
    partial (len(tokens) % block_size != 0)."""

    __slots__ = ("tokens", "blocks", "children", "parent", "touch")

    def __init__(self, tokens, blocks, parent):
        self.tokens = tokens          # np.int32 span
        self.blocks = blocks          # list[int], ceil(len(tokens)/bs)
        self.children = []            # children start block-aligned
        self.parent = parent
        self.touch = 0


class _PendingCopy:
    """One host-side COW order: copy pool block ``src`` into ``dst``
    before the adopter's prefill chunk. ``dead`` marks orders whose dst
    was freed (adopter cancelled/preempted) before the engine drained
    the plan — the copy must not run into a reallocated block."""

    __slots__ = ("src", "dst", "dead")

    def __init__(self, src, dst):
        self.src = src
        self.dst = dst
        self.dead = False


def _common_len(a, b):
    """Length of the common prefix of two int32 token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class RadixPrefixBlockManager(RefBlockManager):
    """RefBlockManager + a token-level radix trie over the block pool
    (SGLang RadixAttention on vLLM-style paging).

    Where :class:`PrefixCachingBlockManager` matches whole aligned
    blocks by chain hash, this trie matches the longest shared TOKEN
    span: edges own ref-counted physical blocks, a partially-filled
    boundary block is shared read-only and copied-on-write at first
    divergence (one fresh block; the engine applies the device copy via
    ``take_copy_plan`` before the adopter's prefill chunk), and
    ``commit_prefix`` inserts partial tails too — so divergence inside a
    block forfeits only the divergent suffix, not the whole tail.

    Blocks whose refcount drops to zero but that live in the trie are
    PARKED (still resident, counted as free); when the free list runs
    dry, eviction walks unreferenced trie leaves LRU-by-touch, one tail
    block at a time — so caching never reduces usable capacity.
    ``cache_epoch`` bumps on every eviction and commit; the scheduler's
    per-request match memo keys on it."""

    def __init__(self, num_blocks: int, block_size: int):
        super().__init__(num_blocks, block_size)
        self._root = _RadixNode(np.empty(0, np.int32), [], None)
        # one trie PER ADAPTER IDENTITY: KV computed under a LoRA adapter
        # is numerically that adapter's — tenants must never adopt each
        # other's blocks. The base-model (None) trie is ``_root``.
        self._roots: dict[object, _RadixNode] = {None: self._root}
        self._in_trie: dict[int, _RadixNode] = {}   # blk -> owning node
        self._parked: set[int] = set()              # trie blocks, rc == 0
        self._touch = 0
        self.cache_epoch = 0
        self._pending: list[_PendingCopy] = []
        self._copy_dst: dict[int, _PendingCopy] = {}
        self.cache_stats = {"hit_blocks": 0, "evictions": 0,
                            "lookup_blocks": 0, "token_hits": 0,
                            "partial_hits": 0, "lookup_tokens": 0}

    # ---- capacity: parked trie blocks are reclaimable, so count as free
    @property
    def free_blocks(self):
        return len(self._free) + len(self._parked)

    def _pop_free(self):
        if self._free:
            return self._free.pop()
        if self._parked:
            return self._evict_one()
        raise MemoryError("paged cache out of blocks")

    def _evict_one(self) -> int:
        """Reclaim ONE parked block: the tail block of the least-recently
        touched childless leaf whose tail is unreferenced. Because
        adoption always takes the full matched path and release frees a
        table all at once, a parked block's whole suffix (deeper blocks
        of its node + every descendant) is parked too — so such a leaf
        always exists while ``_parked`` is non-empty."""
        victim = None
        stack = [ch for root in self._roots.values()
                 for ch in root.children]
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children)
            elif node.blocks and node.blocks[-1] in self._parked:
                if victim is None or node.touch < victim.touch:
                    victim = node
        if victim is None:       # unreachable by the suffix invariant
            raise MemoryError("paged cache out of blocks")
        # chaos site: fires BEFORE any mutation, so an injected exception
        # leaves the trie, refcounts and free list exactly as they were
        fault_point("serving.prefix_evict", manager=self,
                    blk=victim.blocks[-1], touch=victim.touch)
        blk = victim.blocks.pop()
        self._parked.discard(blk)
        self.ledger.unpark(blk)
        del self._in_trie[blk]
        victim.tokens = victim.tokens[:len(victim.blocks)
                                      * self.block_size]
        if not victim.blocks and victim.parent is not None:
            victim.parent.children.remove(victim)
        self.cache_stats["evictions"] += 1
        self.cache_epoch += 1
        return blk

    def _release(self, blk):
        self._rc[blk] -= 1
        if self._rc[blk] == 0:
            del self._rc[blk]
            pend = self._copy_dst.pop(blk, None)
            if pend is not None:
                # the adopter died before its COW executed: cancel the
                # order and drop the pin on the source block
                pend.dead = True
                self.ledger.unpin(pend.src)
                self._release(pend.src)
            if blk in self._in_trie:
                self._parked.add(blk)
                self.ledger.park(blk)
            else:
                self._free.append(blk)

    def _retain(self, blk):
        self._parked.discard(blk)
        self.ledger.unpark(blk)
        super()._retain(blk)

    # --------------------------------------------------------- matching
    def _best_child(self, node, rem):
        """Child with the longest common token prefix with ``rem``.
        Siblings may overlap (first-writer-wins keeps physically distinct
        blocks for the same tokens), so this is argmax, not a dict hop."""
        best, bl = None, 0
        for ch in node.children:
            n = _common_len(ch.tokens, rem)
            if n > bl:
                best, bl = ch, n
        return best, bl

    def _root_for(self, adapter) -> _RadixNode:
        root = self._roots.get(adapter)
        if root is None:
            root = self._roots[adapter] = _RadixNode(
                np.empty(0, np.int32), [], None)
        return root

    def match_prefix(self, tokens, adapter=None) -> PrefixMatch:
        """Longest shared token span for this prompt, capped at len-1 so
        the last prompt token always prefills (its logits seed the first
        sample). Fully-matched aligned blocks are shared outright; the
        boundary block (divergence or span end mid-block) is offered as a
        copy-on-write partial hit. Matching walks ONLY the trie of the
        request's adapter identity — cross-tenant spans never match."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        cap = len(toks) - 1
        bs = self.block_size
        self.cache_stats["lookup_blocks"] += max(cap, 0) // bs
        self.cache_stats["lookup_tokens"] += max(cap, 0)
        self._touch += 1
        node, depth = self._root_for(adapter), 0
        blocks, cow = [], None
        while depth < cap:
            best, bl = self._best_child(node, toks[depth:cap])
            if best is None or bl == 0:
                break
            best.touch = self._touch
            if bl == len(best.tokens) and bl % bs == 0:
                blocks.extend(best.blocks)
                depth += bl
                node = best
                continue
            # boundary inside ``best``: share its full sub-blocks, offer
            # the partial one copy-on-write
            n_full = bl // bs
            blocks.extend(best.blocks[:n_full])
            hit = bl % bs
            if hit:
                cow = (best.blocks[n_full], hit)
            depth += bl
            break
        return PrefixMatch(blocks, depth, cow)

    # --------------------------------------------------------- adoption
    def adopt_prefix(self, seq_id, match) -> list:
        """Install a match as seq_id's table prefix: retain the shared
        blocks, and for a partial hit allocate one private block and
        queue the (src, dst) device copy. Exception-atomic: a failed
        allocation rolls every retain back."""
        assert seq_id not in self.tables
        blocks = list(match.blocks) if isinstance(match, PrefixMatch) \
            else list(match)
        cow = getattr(match, "cow", None)
        retained = []
        try:
            for blk in blocks:
                self._retain(blk)
                retained.append(blk)
            table = list(blocks)
            if cow is not None:
                src, hit = cow
                # pin src until the plan drains: a parked source must not
                # be evicted/reallocated before the copy program is issued
                self._retain(src)
                retained.append(src)
                dst = self._pop_free()
                self._rc[dst] = 1
                entry = _PendingCopy(src, dst)
                self._pending.append(entry)
                self._copy_dst[dst] = entry
                table.append(dst)
        except BaseException:
            for blk in reversed(retained):
                self._release(blk)
            raise
        self.tables[seq_id] = table
        # ledger transitions only on the success path: the rollback above
        # re-parks/frees via _release, whose own hooks keep it consistent
        for blk in table:
            self.ledger.table_enter(seq_id, blk)
        if cow is not None:
            self.ledger.pin(cow[0])
        self.cache_stats["hit_blocks"] += len(blocks)
        self.cache_stats["token_hits"] += getattr(
            match, "token_count", len(blocks) * self.block_size)
        if cow is not None:
            self.cache_stats["partial_hits"] += 1
        return table

    def take_copy_plan(self) -> list:
        """Drain the pending COW orders as (src, dst) pairs and drop the
        source pins. The engine applies them in ONE device copy before
        any other program of the tick writes the pool — the CUDA stream
        then orders the copy before the adopters' prefill chunks and
        before any reallocation of a source block."""
        pairs = []
        pending, self._pending = self._pending, []
        for e in pending:
            if e.dead:
                continue
            pairs.append((e.src, e.dst))
            self._copy_dst.pop(e.dst, None)
            self.ledger.unpin(e.src)
            self._release(e.src)
        return pairs

    # ------------------------------------------------------- insertion
    def commit_prefix(self, seq_id, tokens, adapter=None):
        """Insert seq_id's token span — INCLUDING the partial tail block
        — so later requests can share it. Safe before the writes have
        executed on device (the stream orders consumers after).
        Callers must pass only tokens whose KV is resident (the engine
        passes the cache frontier, not the just-sampled token). The span
        lands in the trie of ``adapter``'s identity only."""
        table = self.tables.get(seq_id, [])
        toks = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        n_tok = min(len(toks), len(table) * bs)
        for i, b in enumerate(table):     # window-recycled holes: stop
            if b is None:
                n_tok = min(n_tok, i * bs)
                break
        if n_tok <= 0:
            return
        self._insert(toks[:n_tok], table, self._root_for(adapter))
        self.cache_epoch += 1

    def _insert(self, toks, table, root=None):
        bs = self.block_size
        node, depth = (root if root is not None else self._root), 0
        while depth < len(toks):
            rem = toks[depth:]
            best, bl = self._best_child(node, rem)
            if best is None or bl == 0:
                self._attach(node, toks, depth, table)
                return
            if bl == len(best.tokens):
                if bl % bs == 0:
                    node = best
                    depth += bl
                    continue
                # fully matched a partial-tail leaf
                if len(rem) <= bl:
                    return                     # nothing new to insert
                own = table[(depth + bl) // bs]
                if (best.blocks[-1] == own
                        and best.blocks == table[depth // bs:
                                                 depth // bs
                                                 + len(best.blocks)]):
                    # same physical tail block: the original writer
                    # appended — extend the span in place
                    self._extend(best, toks, depth, table)
                else:
                    # same tokens, different block (a COW fork that grew
                    # past the shared span): overlapping sibling; match
                    # picks whichever overlaps a query longest
                    self._attach(node, toks, depth, table)
                return
            # divergence inside ``best``: split at the enclosing block
            # boundary, then attach the new branch (a committer that is
            # merely a PREFIX of ``best`` adds nothing — skip)
            sp = (bl // bs) * bs
            if 0 < sp < len(best.tokens):
                node = self._split(best, sp)
            if len(rem) > bl:
                self._attach(node, toks, depth + sp, table)
            return

    def _attach(self, parent, toks, depth, table):
        """New child of ``parent`` owning the committer's blocks from
        token ``depth`` on (block-aligned by construction)."""
        bs = self.block_size
        span = toks[depth:]
        start = depth // bs
        blocks = []
        for j in range(start, min(len(table),
                                  start + -(-len(span) // bs))):
            b = table[j]
            if b is None or b in self._in_trie:
                break                      # one trie home per block
            blocks.append(b)
        if not blocks:
            return
        span = span[:min(len(span), len(blocks) * bs)]
        self._touch += 1
        node = _RadixNode(span, blocks, parent)
        node.touch = self._touch
        parent.children.append(node)
        for b in blocks:
            self._in_trie[b] = node

    def _extend(self, node, toks, depth, table):
        """Grow a partial-tail node in place: same physical tail block,
        the committer wrote more tokens into it (and possibly beyond)."""
        bs = self.block_size
        span = toks[depth:]
        start = depth // bs
        blocks = list(node.blocks)
        for j in range(start + len(blocks),
                       min(len(table), start + -(-len(span) // bs))):
            b = table[j]
            if b is None or b in self._in_trie:
                break
            blocks.append(b)
        span = span[:min(len(span), len(blocks) * bs)]
        if len(span) <= len(node.tokens):
            return
        for b in blocks[len(node.blocks):]:
            self._in_trie[b] = node
        node.tokens = span
        node.blocks = blocks
        self._touch += 1
        node.touch = self._touch

    def _split(self, node, sp):
        """Split a node at block-aligned token offset ``sp``: the upper
        half keeps the shared prefix, the original node becomes its child
        with the remainder."""
        bs = self.block_size
        upper = _RadixNode(node.tokens[:sp], node.blocks[:sp // bs],
                           node.parent)
        upper.touch = node.touch
        parent = node.parent
        parent.children[parent.children.index(node)] = upper
        node.tokens = node.tokens[sp:]
        node.blocks = node.blocks[sp // bs:]
        node.parent = upper
        upper.children.append(node)
        for b in upper.blocks:
            self._in_trie[b] = upper
        return upper


# ------------------------------------------------------------- helpers
def _host(x) -> np.ndarray:
    """Host copy of small index arrays (numpy in, numpy out; a tensor is
    fetched)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dev_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32)


def _install_rows(cache: PagedKVCache, slot_ids, table_rows, new_lens):
    """cache.block_tables[slot] = row and cache.lens[slot] = len for every
    row whose slot id is a real slot; sentinel slots (>= num_slots) are
    dropped on the host, as the reference's ``mode="drop"`` does."""
    slots = _host(slot_ids).astype(np.int64)
    keep = (slots >= 0) & (slots < cache.block_tables.shape[0])
    if not keep.any():
        return
    dev = cache.device
    sel = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    idx = torch.as_tensor(slots[keep], device=dev)
    cache.block_tables[idx] = _dev_i32(table_rows, dev)[sel]
    cache.lens[idx] = _dev_i32(new_lens, dev)[sel]


def _rope_rows(positions, head_dim, base, scaling=None, max_pos=None):
    """cos/sin tables for PER-ROW positions: [B] -> [B, D/2] (ragged
    decode: every sequence sits at a different position). Dynamic-NTK
    scales each row by its own current length (positions + 1)."""
    base, pos_div = A.resolve_rope_scaling(
        base, head_dim, scaling, allow_dynamic=False,
        max_position_embeddings=max_pos,
        cur_len=(positions + 1 if (scaling or {}).get("type") == "dynamic"
                 else None))
    dev = positions.device
    if isinstance(base, torch.Tensor):              # dynamic NTK: per row
        base = base.to(device=dev, dtype=torch.float32).reshape(-1, 1)
    else:
        # a fill, not a host-to-device copy: a CUDA graph captures it
        base = torch.full((1, 1), float(base), dtype=torch.float32,
                          device=dev)                           # [B|1, 1]
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=dev)[None, :] / head_dim))
    f = (positions.float() / pos_div)[:, None] * inv
    return torch.cos(f), torch.sin(f)


def _apply_rope_rows(x, cos, sin):
    """x: [B, 1, H, D] (or [A, C, H, D]); cos/sin one table row per token,
    [B, D/2] (or [A, C, D/2]). Rotate-half (NeoX) through K7
    (``ops.cuda.rope``), which reads the strided q/k view in place."""
    return _rope.fused_rope(x, cos, sin)


def _rope_write_decode(cache, li, q, k, v, cos, sin, dest):
    """The decode step's rope and pool write of layer ``li``; returns q
    rotated. A pool of the activations' type takes K7 folded with the
    write (``ops.cuda.rope.rope_kv_write``: one launch); an int8 pool,
    which quantizes on write, takes K7 on q and k and ``_scatter_kv``. The
    route is the pool's dtype: both give the same bits."""
    if cache.k_store[li].dtype != q.dtype:
        q = _apply_rope_rows(q, cos, sin)
        _scatter_kv(cache, li, _apply_rope_rows(k, cos, sin), v, dest)
        return q
    return _rope.rope_kv_write(q, k, v, cos, sin, cache.k_store[li],
                               cache.v_store[li], dest)


def _scatter(store, vals, dest):
    """Write rows ``vals`` [..., H(, D)] at flat pool positions ``dest``
    of ``store`` [N + 1, bs, H(, D)] (sink positions for dropped rows)."""
    flat = store.view(-1, *store.shape[2:])
    flat.index_put_((dest.reshape(-1),),
                    vals.reshape(-1, *store.shape[2:]).to(store.dtype))


def _dest_prefill(tables, lens, s, num_blocks, block_size):
    """Flat pool positions of [B, S] prompt tokens: token (b, i) ->
    (tables[b, i // bs], i % bs), the sink where i >= lens[b] (or the
    table slot holds the sentinel)."""
    i = torch.arange(s, device=tables.device)
    col = torch.clamp(i // block_size, max=tables.shape[1] - 1)
    blk = tables[:, col].long()                                # [B, S]
    ok = (i[None, :] < lens[:, None]) & (blk < num_blocks)
    return torch.where(ok, blk * block_size + (i % block_size)[None, :],
                       num_blocks * block_size)


def _dest_decode(tables, lens, active, num_blocks, block_size):
    """Flat pool position of ONE token per sequence at position lens[b];
    inactive rows go to the sink (their blocks may already be
    recycled)."""
    col = torch.clamp(lens.long() // block_size, max=tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, col[:, None])[:, 0]
    ok = active & (blk < num_blocks)
    return torch.where(ok, blk * block_size + lens.long() % block_size,
                       num_blocks * block_size)


def _dest_chunk(tables, offsets, chunk_lens, c, num_blocks, block_size):
    """Flat pool positions of [A, C] chunk tokens at offset..offset+len-1
    through each row's table; padding (i >= chunk_lens) goes to the
    sink."""
    ar = torch.arange(c, device=tables.device)
    pos = offsets.long()[:, None] + ar[None, :]                # [A, C]
    col = torch.clamp(pos // block_size, max=tables.shape[1] - 1)
    blk = torch.gather(tables.long(), 1, col)
    ok = (ar[None, :] < chunk_lens[:, None]) & (blk < num_blocks)
    return torch.where(ok, blk * block_size + pos % block_size,
                       num_blocks * block_size)


# --------------------------------------------- context parallelism (cp)
# Under LLMEngine(cp=N) every rank of the cp group (one process a rank)
# holds ``per = num_blocks / cp`` blocks of every pool — rank s the GLOBAL
# block ids [s*per, (s+1)*per) — while the weights, block tables, lengths
# and activations are replicated with global ids. The forwards take
# ``cp_axis``, the name of the cp axis of the active mesh (the executor
# enters its mesh around every call), translate the tables to LOCAL ids at
# their use sites (writes to other ranks' blocks go to the local sink, K3
# and K4 skip their entries in partials mode) and merge the ranks'
# online-softmax partials, so the host's block managers, radix trie and
# ledger never learn of the sharding. ``cp_axis=None`` is the single-rank
# path, unchanged.

def _cp(cp_axis):
    """(mesh, size, this rank's index) of the cp axis, or None."""
    if cp_axis is None:
        return None
    from paddle_tpu_torch.distributed import collective as C
    mesh, _, n, my = C._axis(cp_axis)
    return mesh, n, my


def _cp_local_tables(tables, cp, per):
    """GLOBAL block-table entries -> this rank's LOCAL pool ids: ids in
    [s*per, (s+1)*per) become [0, per); every other id (other ranks'
    blocks, the global sentinel) becomes the local sentinel ``per`` —
    written to the sink block, skipped by the partials kernels."""
    if cp is None:
        return tables
    loc = tables - cp[2] * per
    return torch.where((loc >= 0) & (loc < per), loc,
                       torch.full_like(loc, per))


def _cp_merge_chunk(o, m, l, cp_axis, cp, dtype):
    """Merge K3's partials over cp: the ring rotation (default) or, with
    ``PT_CP_IMPL=ulysses`` (read at each call), the Ulysses all_to_all;
    both give every rank the same bits. Then normalise."""
    from paddle_tpu_torch.distributed.ring_attention import (
        finalize_partials, ring_merge_partials)
    impl = os.environ.get("PT_CP_IMPL", "ring").strip().lower()
    if impl == "ulysses":
        from paddle_tpu_torch.distributed.ulysses import \
            ulysses_merge_partials
        o, m, l = ulysses_merge_partials(o, m, l, axis_name=cp_axis,
                                         mesh=cp[0])
    else:
        o, m, l = ring_merge_partials(o, m, l, axis_name=cp_axis, mesh=cp[0])
    return finalize_partials(o, l, dtype)


def _cp_merge_decode(o, m, l, cp_axis, cp, dtype):
    """Merge K4's partials over cp with the flat symmetric reductions (one
    max, one sum: the same bits on every rank), then normalise."""
    from paddle_tpu_torch.distributed.ring_attention import (
        finalize_partials, psum_merge_partials)
    o, m, l = psum_merge_partials(o, m, l, axis_name=cp_axis, mesh=cp[0])
    return finalize_partials(o, l, dtype)


def _lora_delta(x, lora, kind, li):
    """Batched multi-LoRA correction for ONE projection of ONE layer:
    ``delta[b] = (x[b] @ A_{aidx[b]}) @ B_{aidx[b]}`` in fp32 with the
    alpha/r scale pre-folded into the B stack, zero for null-adapter rows,
    cast back to ``x.dtype``. ``lora`` is the engine-built dict of device
    tensors (``serving/engine.py`` ``_lora_arg``):

      qkv_a/qkv_b/o_a/o_b  [L, cap, ...]  the store's stacked adapters
      perm / inv           [B]  rows sorted by cache index (null last) /
                                the inverse permutation
      gs                   [cap] TOKEN count per cache index (row count
                                times the per-row width, in sorted order)
      aidx                 [B]  original-order cache index, -1 = null

    The grouped path (the default) runs the sorted rows, flattened to
    [B*S, k], through two grouped products (K6a on the card, its plain
    version on the CPU), so a batch of mixed adapters is ragged
    per-adapter segments through one kernel; rows past ``sum(gs)`` (the
    null-adapter tail) are unspecified by K6a's contract and masked to
    zero here. ``PT_MULTILORA_IMPL=gather`` selects the dense per-row
    baseline the grouped path is timed against (read at each call; a
    captured tick keeps what it read when it was captured). Every index
    and the mask stay on the device: a CUDA graph captures this function
    (``serving/executor.py``). The paged forwards call :func:`_lora_add`,
    which fuses this composition and its add on the card."""
    a_stack = lora[kind + "_a"][li]          # [cap, k, r]
    b_stack = lora[kind + "_b"][li]          # [cap, r, n]
    bsz, s, kdim = x.shape
    xf = x.float()
    if os.environ.get("PT_MULTILORA_IMPL", "grouped") == "gather":
        sel = torch.clamp(lora["aidx"].long(), min=0)
        t = torch.einsum("bsk,bkr->bsr", xf, a_stack[sel])
        d = torch.einsum("bsr,brn->bsn", t, b_stack[sel])
        return torch.where((lora["aidx"] >= 0)[:, None, None], d,
                           0.0).to(x.dtype)
    xp = xf[lora["perm"].long()].reshape(bsz * s, kdim)
    t = _gm.grouped_matmul(xp, a_stack, lora["gs"])
    d = _gm.grouped_matmul(t, b_stack, lora["gs"])
    live = (torch.arange(bsz * s, device=x.device)[:, None]
            < lora["gs"].sum())
    d = torch.where(live, d, 0.0)
    return d.reshape(bsz, s, -1)[lora["inv"].long()].to(x.dtype)


def _lora_add(y, x, lora, kind, li):
    """``y + _lora_delta(x, lora, kind, li)`` for ONE projection of ONE
    layer, ``y`` being that projection's fresh output (updated in place
    and returned). The grouped path runs K6a's two LoRA kernels on CUDA
    tensors (``ops/cuda/grouped_matmul.py`` :func:`lora_shrink`, ``t =
    x_sorted @ A[g]`` read through ``perm`` in x's own type, and
    :func:`lora_expand_add`, which adds ``cast(t @ B[g])`` into y's live
    rows), and their plain versions on CPU tensors: the arithmetic of
    ``_lora_delta`` plus the add, step by step. Rows of the null-adapter
    tail are left untouched on the card, where the plain versions add a
    masked 0 (a -0.0 there becomes +0.0; the values compare equal).
    ``PT_MULTILORA_IMPL=gather`` keeps the dense baseline,
    ``y + _lora_delta(...)``. Device-only, as ``_lora_delta``: a CUDA
    graph captures it."""
    if os.environ.get("PT_MULTILORA_IMPL", "grouped") == "gather":
        return y + _lora_delta(x, lora, kind, li)
    if y.dtype != x.dtype:
        raise TypeError(f"_lora_add: the projection's output {y.dtype} and "
                        f"its input {x.dtype} differ")
    t = _gm.lora_shrink(x.contiguous(), lora["perm"], lora[kind + "_a"][li],
                        lora["gs"])
    return _gm.lora_expand_add(y, t, lora[kind + "_b"][li], lora["gs"],
                               lora["perm"])


def _qkv(att, h, shape_q, shape_kv, lora=None, li=0):
    qkv = _wo(h, att.qkv_proj)
    if lora is not None:
        qkv = _lora_add(qkv, h, lora, "qkv", li)
    if att.qkv_bias is not None:
        qkv = qkv + att.qkv_bias
    nh, nkv, hd = att.num_heads, att.num_kv_heads, att.head_dim
    q, k, v = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    return (q.reshape(*shape_q, nh, hd), k.reshape(*shape_kv, nkv, hd),
            v.reshape(*shape_kv, nkv, hd))


def _backbone(model):
    """Decoder backbone holding embed_tokens/layers/norm. Llama-family
    models wrap it in ``.model``; the MoE families (Mixtral, Qwen2-MoE,
    MoEForCausalLM) hang the parts directly off the LM. Every caller walks
    its ``layers``: a ``scan_layers=True`` model (layers stacked, the list
    empty) raises by name."""
    bb = getattr(model, "model", model)
    if getattr(bb, "layers_stacked", None) is not None:
        from paddle_tpu_torch.models.llama import refuse_scanned
        refuse_scanned(model, "the serving and decoding forwards")
    return bb


def model_config(model):
    """The config that carries the Llama fields (widths, heads, rope):
    ``model.cfg``, or its ``base`` for ``MoEForCausalLM``."""
    return getattr(model.cfg, "base", model.cfg)


def _model_logits(model, x):
    """LM head: ``model.logits`` where it exists, the plain ``lm_head``
    matmul otherwise (MoE families)."""
    fn = getattr(model, "logits", None)
    if callable(fn):
        return fn(x)
    return _wo(x, model.lm_head)


def _mlp_out(lyr, h):
    """Per-layer MLP adapter: Mixtral-style layers carry an ``.moe``
    MoELayer, Qwen2-MoE puts a sparse block (or a dense LlamaMLP) at
    ``.mlp``. MoE blocks return ``(y, aux_loss)`` — the aux loss is a
    training regulariser, dropped at inference."""
    blk = lyr.moe if hasattr(lyr, "moe") else lyr.mlp
    out = blk(h)
    return out[0] if isinstance(out, (tuple, list)) else out


def is_moe_model(model) -> bool:
    """True when any decoder layer routes through an MoE block (drives
    the ``serving.moe_dispatch`` chaos site in LLMEngine)."""
    return any(hasattr(lyr, "moe") or getattr(lyr, "sparse", False)
               for lyr in getattr(_backbone(model), "layers", ()))


def _layer_tail(lyr, x, out, shape, lora=None, li=0):
    att = lyr.self_attn
    attn_out = out.reshape(*shape, att.num_heads * att.head_dim)
    proj = _wo(attn_out, att.o_proj)
    if lora is not None:
        proj = _lora_add(proj, attn_out, lora, "o", li)
    x = x + proj
    return x + _mlp_out(lyr, lyr.post_attention_layernorm(x))


# ------------------------------------------------------------- forwards
@torch.no_grad()
def llama_prefill_paged(model, input_ids, prompt_lens, cache: PagedKVCache,
                        slot_ids=None, table_rows=None, lora=None,
                        cp_axis=None):
    """Prefill padded ragged prompts [B, S]; returns (last_logits, cache).

    Attention runs the padded-varlen path (``kv_lens``) — the flash kernel
    on the card; K/V of every valid position is written into the block
    pool. ``last_logits`` [B, V] are taken at each row's LAST VALID
    position.

    MID-FLIGHT ADMISSION: with ``slot_ids`` [A] + ``table_rows`` [A,
    max_blocks], the prompt rows go into cache SLOTS ``slot_ids`` (their
    table rows and lengths installed) while every other slot stays
    untouched. Padding rows use slot_id >= num_slots and prompt_len 0 and
    write nothing. ``lora``: the per-row multi-LoRA dict
    (:func:`_lora_delta`). The cache is updated in place. ``cp_axis``:
    the rank writes only its own blocks; the prompt's attention is dense
    over its own K/V, so nothing is merged."""
    cp = _cp(cp_axis)
    cfg = model_config(model)
    dev = cache.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = input_ids.shape
    nb, bs = cache.num_blocks, cache.block_size
    lens_np = _host(prompt_lens).astype(np.int32)
    lens = torch.as_tensor(lens_np, device=dev)
    if slot_ids is None:
        tables = cache.block_tables                # row i == slot i
        cache.lens[:b] = lens
    else:
        tables = _dev_i32(table_rows, dev)
        _install_rows(cache, slot_ids, tables, lens)
    x = _backbone(model).embed_tokens[input_ids]
    d = cfg.hidden_size // cfg.num_attention_heads
    scaling = cfg.rope_scaling
    cos, sin = A.rope_cos_sin(
        s, d, base=cfg.rope_theta, scaling=scaling,
        max_position_embeddings=cfg.max_position_embeddings,
        cur_len=(lens_np if (scaling or {}).get("type") == "dynamic"
                 else None),
        allow_dynamic=False, device=dev)
    dest = _dest_prefill(_cp_local_tables(tables, cp, nb), lens, s, nb, bs)
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        q, k, v = _qkv(lyr.self_attn, h, (b, s), (b, s), lora, li)
        q = A.apply_rope(q, cos, sin)
        k = A.apply_rope(k, cos, sin)
        # the prompt attends over its own pre-quantization K/V; only the
        # pool writes quantize (an int8 pool costs prefill nothing)
        out = A.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             kv_lens=lens,
                                             window=cfg.sliding_window)
        _scatter_kv(cache, li, k, v, dest)
        x = _layer_tail(lyr, x, out, (b, s), lora, li)
    x = _backbone(model).norm(x)
    logits = _model_logits(model, x)
    last = logits[torch.arange(b, device=dev),
                  torch.clamp(lens.long() - 1, min=0)]
    return last, cache


@torch.no_grad()
def llama_decode_step_paged(model, tokens, cache: PagedKVCache, active,
                            lora=None, cp_axis=None):
    """One decode token per sequence. tokens: [B]; active: [B] bool
    (inactive rows neither write KV nor advance). Returns (logits [B, V],
    cache), the cache updated in place. ``lora``: see
    :func:`_lora_delta`. ``cp_axis``: K4 in its partials mode over the
    rank's blocks, merged over cp."""
    cp = _cp(cp_axis)
    cfg = model_config(model)
    dev = cache.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev).bool()
    b = tokens.shape[0]
    nb, bs = cache.num_blocks, cache.block_size
    x = _backbone(model).embed_tokens[tokens][:, None]               # [B,1,E]
    d = cfg.hidden_size // cfg.num_attention_heads
    old_lens = cache.lens.clone()
    cos, sin = _rope_rows(old_lens, d, cfg.rope_theta, cfg.rope_scaling,
                          cfg.max_position_embeddings)
    new_lens = torch.where(active, old_lens + 1, old_lens)
    tables = _cp_local_tables(cache.block_tables, cp, nb)
    dest = _dest_decode(tables, old_lens, active, nb, bs)
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        q, k, v = _qkv(lyr.self_attn, h, (b, 1), (b, 1), lora, li)
        q = _rope_write_decode(cache, li, q, k, v, cos, sin, dest)
        kp, vp, ks, vs = _pools(cache, li)
        if cp is None:
            out = _paged.paged_decode_attention(
                q[:, 0], kp, vp, tables, new_lens,
                window=cfg.sliding_window, k_scale=ks, v_scale=vs)
        else:
            out = _cp_merge_decode(*_paged.paged_decode_attention(
                q[:, 0], kp, vp, tables, new_lens,
                window=cfg.sliding_window, k_scale=ks, v_scale=vs,
                partials=True), cp_axis, cp, q.dtype)
        x = _layer_tail(lyr, x, out, (b, 1), lora, li)
    x = _backbone(model).norm(x)
    logits = _model_logits(model, x)[:, 0]
    cache.lens.copy_(new_lens)
    return logits, cache


@torch.no_grad()
def decode_tick_rows(model, tokens, cache: PagedKVCache, active, gen, temps,
                     top_ps, top_k=None, logit_bias=None, lora=None,
                     cp_axis=None):
    """The device half of a decode tick, on device tensors only: the decode
    step (with the multi-LoRA correction when ``lora`` is given), then one
    token per row sampled with the generator ``gen`` (``temps``/``top_ps``
    [B] fp32, temperature 0 = greedy for that row); inactive rows keep
    their token. Returns (next tokens [B] int64, fp32 logits [B, V]). No
    host read and no host-to-device copy: the executor captures it in a
    CUDA graph (``serving/executor.py``; a cp tick runs eagerly)."""
    from paddle_tpu_torch.models.decoding import _sample_rows
    logits, cache = llama_decode_step_paged(model, tokens, cache, active,
                                            lora=lora, cp_axis=cp_axis)
    lf = logits.float()
    nxt = _sample_rows(lf, gen, temps, top_ps, top_k, logit_bias)
    return torch.where(active, nxt, tokens), lf


@torch.no_grad()
def llama_decode_tick(model, tokens, cache: PagedKVCache, active,
                      upd_rows, upd_cols, upd_vals, gen, temps, top_ps,
                      top_k=None, want_logp=False, lora=None,
                      logit_bias=None, cp_axis=None):
    """ONE serving tick: apply incremental block-table updates
    (``tables[upd_rows[i], upd_cols[i]] = upd_vals[i]``, sentinel rows >=
    num_slots dropped), run the decode step, and sample the next token ON
    THE DEVICE with the generator ``gen``. ``temps``/``top_ps`` [B]
    per-slot sampling params (temperature 0 = greedy for that row).
    Returns (next tokens [B], logp [B, V] or None, cache). The eager form
    of the tick the executor replays from a CUDA graph on the card.
    ``lora``: see :func:`_lora_delta`. ``cp_axis``: the decode step's
    partials merged over cp (:func:`llama_decode_step_paged`); the tables
    stay global."""
    dev = cache.device
    rows = _host(upd_rows).astype(np.int64)
    keep = (rows >= 0) & (rows < cache.block_tables.shape[0])
    if keep.any():
        cache.block_tables[torch.as_tensor(rows[keep], device=dev),
                           torch.as_tensor(_host(upd_cols)[keep],
                                           device=dev).long()] = \
            torch.as_tensor(_host(upd_vals)[keep], device=dev).to(torch.int32)
    tokens = torch.as_tensor(tokens, device=dev).long()
    active = torch.as_tensor(active, device=dev).bool()
    nxt, lf = decode_tick_rows(
        model, tokens, cache, active, gen,
        torch.as_tensor(temps, device=dev).float(),
        torch.as_tensor(top_ps, device=dev).float(), top_k,
        None if logit_bias is None
        else torch.as_tensor(logit_bias, device=dev), lora, cp_axis)
    logp = torch.log_softmax(lf, dim=-1) if want_logp else None
    return nxt, logp, cache


@torch.no_grad()
def llama_decode_tick_async(model, tokens, cache: PagedKVCache, active,
                            stop, gen, max_gen, rng, temps, top_ps, eos_id,
                            top_k=None, cp_axis=None):
    """The pipelined twin of :func:`llama_decode_tick`: the token array it
    returns stays on the device and feeds the next call's ``tokens``, so
    the engine dispatches up to ``async_depth`` of these back to back and
    fetches each one tick late.

    The host has not seen tick N's token when tick N+1 runs, so the stop
    on EOS or ``max_gen`` is evaluated here: ``stop`` [B] bool is the
    accumulated device-side stop mask, and a row that sampled EOS (or
    reached ``max_gen``) at tick N is masked out of tick N+1 (``ran =
    active & ~stop``). ``eos_id`` is -1 when the engine has no EOS (token
    ids are non-negative, so the compare never fires); ``gen`` /
    ``max_gen`` [B] int64 count the tokens each row generated / may
    generate; ``rng`` is the sampling generator. No table updates, LoRA,
    beam logp or bias: the engine takes the synchronous tick for any tick
    that needs them. Returns (nxt, ran, stop', gen', cache): ``ran`` is
    the mask of the rows that computed this tick, which are exactly the
    rows the synchronous loop would have run. ``cp_axis``: as the
    synchronous tick's."""
    ran = active & ~stop
    nxt, _ = decode_tick_rows(model, tokens, cache, ran, rng, temps, top_ps,
                              top_k, cp_axis=cp_axis)
    new_gen = gen + ran.to(gen.dtype)
    stopped = ran & ((nxt == eos_id) | (new_gen >= max_gen))
    return nxt, ran, stop | stopped, new_gen, cache


@torch.no_grad()
def llama_prefill_chunk_paged(model, input_ids, chunk_lens, offsets,
                              cache: PagedKVCache, slot_ids, table_rows,
                              full_logits=False, lora=None, cp_axis=None):
    """CONTINUE a prefill: write chunk tokens at positions ``offsets[a] ..
    offsets[a]+chunk_lens[a]-1`` of their slots and attend each chunk
    query over the slot's WHOLE pool prefix through the paged chunk
    kernel (K3) — chunked prefill, and the resume after a prefix-cache
    hit. Returns (last_logits [A, V] at each row's final chunk position,
    cache); ``full_logits=True`` returns [A, C, V].

    input_ids [A, C] (zero-padded), chunk_lens [A], offsets [A] (tokens
    already in the pool), slot_ids [A] (sentinel >= num_slots drops the
    row), table_rows [A, max_blocks] CURRENT tables covering
    offset+chunk. Dynamic-NTK rope is refused (chunk-end bases would
    desync across chunks). The cache is updated in place.

    ``full_logits=True`` returns every chunk position's logits — the
    speculative VERIFY forward: logit i of a row judges the proposal at
    position offset+i+1. ``lora``: see :func:`_lora_delta`. ``cp_axis``:
    the rank writes only its own blocks and K3 in its partials mode reads
    only them; the partials are merged over cp
    (:func:`_cp_merge_chunk`)."""
    cp = _cp(cp_axis)
    cfg = model_config(model)
    if (cfg.rope_scaling or {}).get("type") == "dynamic":
        raise NotImplementedError(
            "chunked prefill with dynamic-NTK rope is not supported "
            "(per-chunk bases would desync from the one-shot prefill)")
    dev = cache.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    a, c = input_ids.shape
    nb, bs = cache.num_blocks, cache.block_size
    cl_np = _host(chunk_lens).astype(np.int32)
    off_np = _host(offsets).astype(np.int32)
    chunk_lens = torch.as_tensor(cl_np, device=dev)
    offsets = torch.as_tensor(off_np, device=dev)
    tables = _dev_i32(table_rows, dev)
    _install_rows(cache, slot_ids, tables, off_np + cl_np)
    tables = _cp_local_tables(tables, cp, nb)
    window = cfg.sliding_window

    x = _backbone(model).embed_tokens[input_ids]
    d = cfg.hidden_size // cfg.num_attention_heads
    positions = offsets.long()[:, None] + torch.arange(c, device=dev)
    base, pos_div = A.resolve_rope_scaling(
        cfg.rope_theta, d, cfg.rope_scaling, allow_dynamic=False,
        max_position_embeddings=cfg.max_position_embeddings)
    inv = 1.0 / (torch.as_tensor(base, dtype=torch.float32, device=dev)
                 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                  device=dev) / d))
    f = (positions.float() / pos_div)[:, :, None] * inv
    cos, sin = torch.cos(f), torch.sin(f)                      # [A, C, D/2]
    dest = _dest_chunk(tables, offsets, chunk_lens, c, nb, bs)
    for li, lyr in enumerate(_backbone(model).layers):
        h = lyr.input_layernorm(x)
        q, k, v = _qkv(lyr.self_attn, h, (a, c), (a, c), lora, li)
        q = _apply_rope_rows(q, cos, sin)
        k = _apply_rope_rows(k, cos, sin)
        # write the chunk FIRST so the pool holds prefix + chunk
        _scatter_kv(cache, li, k, v, dest)
        kp, vp, ks, vs = _pools(cache, li)
        if cp is None:
            out = _paged.paged_chunk_attention(
                q, kp, vp, tables, offsets, chunk_lens, window=window,
                k_scale=ks, v_scale=vs)
        else:
            out = _cp_merge_chunk(*_paged.paged_chunk_attention(
                q, kp, vp, tables, offsets, chunk_lens, window=window,
                k_scale=ks, v_scale=vs, partials=True), cp_axis, cp,
                q.dtype)
        x = _layer_tail(lyr, x, out, (a, c), lora, li)
    x = _backbone(model).norm(x)
    logits = _model_logits(model, x)
    if full_logits:
        return logits, cache
    last = logits[torch.arange(a, device=dev),
                  torch.clamp(chunk_lens.long() - 1, min=0)]
    return last, cache


@torch.no_grad()
def prefix_cow_update(cache: PagedKVCache, pairs, cp_axis=None):
    """Radix prefix cache: copy each adopted partial boundary block ``src``
    into the adopter's private block ``dst`` (copy-on-write at first
    divergence), in every layer's K and V pool and, for an int8 pool, its
    scale pools (the codes mean nothing without their scales). Tables and
    lengths are untouched. ``cp_axis``: global ids, whose src and dst
    may live on different ranks (:func:`_cp_copy_blocks`)."""
    if not pairs:
        return cache
    dev = cache.device
    src = torch.as_tensor([p[0] for p in pairs], device=dev)
    dst = torch.as_tensor([p[1] for p in pairs], device=dev)
    stores = (*cache.k_store, *cache.v_store, *cache.k_scale_store,
              *cache.v_scale_store)
    if cp_axis is not None:
        _cp_copy_blocks(stores, src, dst, cache.num_blocks, cp_axis)
        return cache
    for store in stores:
        store[dst] = store[src]
    return cache


def _cp_copy_blocks(stores, src, dst, per, cp_axis):
    """The cross-rank block copy: every rank contributes the src rows it
    owns (zeros elsewhere); exactly one rank owns each id, so one sum over
    cp gives every rank all the src blocks, and the local dst write keeps
    only the rank's own (the others go to the sink). Integer pools sum in
    int32."""
    from paddle_tpu_torch.distributed import collective as C
    _, _, my = _cp(cp_axis)
    loc_src = src - my * per
    own = (loc_src >= 0) & (loc_src < per)
    src_c = torch.clamp(loc_src, 0, per - 1)
    loc_dst = dst - my * per
    loc_dst = torch.where((loc_dst >= 0) & (loc_dst < per), loc_dst,
                          torch.full_like(loc_dst, per))
    for store in stores:
        rows = store[src_c]
        rows = torch.where(own.view(-1, *(1,) * (rows.dim() - 1)), rows,
                           torch.zeros_like(rows))
        wide = rows.to(torch.int32) if not rows.is_floating_point() else rows
        rows = C.all_reduce(wide, axis_name=cp_axis).to(store.dtype)
        store[loc_dst] = rows


# ---------------------------------------------------------- paged beams
def _cow_pairs(copy_src, copy_dst, num_blocks):
    """The (src, dst) block copies of a fork, sentinel pairs (dst ==
    ``num_blocks``: no copy) dropped."""
    return [(int(a), int(b)) for a, b in zip(_host(copy_src), _host(copy_dst))
            if int(b) < num_blocks]


@torch.no_grad()
def _beam_cache_update(cache: PagedKVCache, new_tables, copy_src, copy_dst):
    """Apply a beam reorder to the paged cache, in place: install the
    forked block tables (row j = beam j = slot j) and copy the (at most
    one a beam) private partial blocks — codes and, for an int8 pool,
    their scales (:func:`prefix_cow_update` copies all four stores)."""
    cache.block_tables.copy_(_dev_i32(new_tables, cache.device))
    return prefix_cow_update(
        cache, _cow_pairs(copy_src, copy_dst, cache.num_blocks))


def _beam_select(running_lp, seqs, fin_seqs, fin_scores, logp, i,
                 prompt_len, eos_token_id, length_penalty):
    """The b = 1 adapter over ``decoding.beam_select`` — ONE shared
    implementation, so paged beams equal the dense-cache beams by
    construction. Shapes drop the batch axis: running_lp [K], seqs [K,
    L], logp [K, V]."""
    from paddle_tpu_torch.models.decoding import beam_select
    out = beam_select(running_lp[None], seqs[None], fin_seqs[None],
                      fin_scores[None], logp[None], i, prompt_len,
                      eos_token_id, length_penalty)
    return tuple(x[0] for x in out)


@torch.no_grad()
def _beam_group_update(cache: PagedKVCache, slot_ids, rows, lens_val,
                       copy_src, copy_dst):
    """The engine's beam reorder, IN PLACE: the K forked table rows go to
    the group's cache slots (``block_tables[slot_ids] = rows``), their
    lengths are pinned to ``lens_val``, and the private partial blocks
    are copied (all four stores). Writing into the tensors — never
    rebinding them — is what keeps a captured decode tick valid.
    slot_ids [K]; rows [K, max_blocks]; copy_src/copy_dst [K] (sentinel
    ``num_blocks`` = no copy)."""
    dev = cache.device
    idx = torch.as_tensor(np.asarray(slot_ids, np.int64), device=dev)
    cache.block_tables[idx] = _dev_i32(rows, dev)
    cache.lens[idx] = int(lens_val)
    return prefix_cow_update(
        cache, _cow_pairs(copy_src, copy_dst, cache.num_blocks))


def _beam_finalize(running_lp, seqs, fin_seqs, fin_scores, prompt_len,
                   max_new_tokens, eos_token_id, length_penalty):
    """The best hypothesis among the finished and still-running beams,
    EOS-filled past its first EOS — shared by :func:`paged_beam_search`
    and the serving engine's beam groups. Returns (best_seq [L],
    best_score)."""
    from paddle_tpu_torch.models.decoding import beam_finalize
    seq, score = beam_finalize(running_lp[None], seqs[None], fin_seqs[None],
                               fin_scores[None], prompt_len, max_new_tokens,
                               eos_token_id, length_penalty)
    return seq[0], score[0]


@torch.no_grad()
def paged_beam_search(model, prompt, max_new_tokens=32, num_beams=4,
                      length_penalty=1.0, eos_token_id=None, block_size=16,
                      num_blocks=None):
    """Beam search IN THE PAGED PATH (one prompt, K beams as cache slots),
    on the model's device. Prompt blocks are SHARED across beams through
    refcounts (:class:`RefBlockManager`); each reorder forks the parents'
    tables and copies only the private partial tail block — the
    append-only pool's copy-on-write. The prefill runs K2, every step K4
    (and K7, K1). The selection math is ``decoding.beam_select``, so the
    result equals the dense-cache beam search. Returns (best sequence
    [prompt + max_new_tokens], best score)."""
    from paddle_tpu_torch.models.decoding import beam_init
    prompt = np.asarray(_host(prompt), np.int64).reshape(-1)
    s = len(prompt)
    cfg = model_config(model)
    dev = next(model.parameters()).device
    k = num_beams
    max_blocks = -(-(s + max_new_tokens) // block_size)
    if num_blocks is None:
        num_blocks = k * max_blocks
    mgr = RefBlockManager(num_blocks, block_size)
    cache = PagedKVCache.init(cfg.num_hidden_layers, num_blocks, block_size,
                              cfg.num_key_value_heads,
                              cfg.hidden_size // cfg.num_attention_heads,
                              k, max_blocks, cfg.dtype, device=dev)

    # prefill once into beam 0's blocks, then fork the other beams
    sid = {j: j for j in range(k)}          # beam j -> manager sequence id
    next_sid = k
    mgr.allocate(0, s)
    rows = np.full((k, max_blocks), num_blocks, np.int32)
    copy_src = np.full(k, num_blocks, np.int32)
    copy_dst = np.full(k, num_blocks, np.int32)
    for j in range(1, k):
        pair = mgr.fork(0, j, s)
        if pair is not None:
            copy_src[j], copy_dst[j] = pair
    for j in range(k):
        t = mgr.tables[j]
        rows[j, :len(t)] = t
    logits, cache = llama_prefill_paged(
        model, prompt[None, :], np.asarray([s], np.int32), cache,
        np.asarray([0], np.int32), rows[:1])
    cache.lens.fill_(s)
    cache = _beam_cache_update(cache, rows, copy_src, copy_dst)
    running_lp, seqs, fin_seqs, fin_scores, logp = (
        x[0] for x in beam_init(logits[:1], torch.as_tensor(
            prompt[None], device=dev), k, max_new_tokens))
    for i in range(max_new_tokens):
        running_lp, seqs, fin_seqs, fin_scores, new_beam, new_tok = \
            _beam_select(running_lp, seqs, fin_seqs, fin_scores, logp, i, s,
                         eos_token_id, length_penalty)
        if i == max_new_tokens - 1:
            break                      # the last token: selection only
        parents = new_beam.cpu().numpy()
        cur = s + i                    # tokens stored a beam so far
        # fork: new beam j adopts parent p's blocks; room for the write
        # at position cur, privately per beam
        new_rows = np.full((k, max_blocks), num_blocks, np.int32)
        copy_src = np.full(k, num_blocks, np.int32)
        copy_dst = np.full(k, num_blocks, np.int32)
        new_sid = {}
        for j in range(k):
            pair = mgr.fork(sid[int(parents[j])], next_sid, cur)
            if pair is not None:
                copy_src[j], copy_dst[j] = pair
            new_sid[j] = next_sid
            next_sid += 1
        for j in range(k):
            mgr.free(sid[j])
        sid = new_sid
        for j in range(k):
            t = mgr.allocate(sid[j], cur + 1)
            new_rows[j, :len(t)] = t
        cache = _beam_cache_update(cache, new_rows, copy_src, copy_dst)
        logits, cache = llama_decode_step_paged(
            model, new_tok, cache, torch.ones(k, dtype=torch.bool,
                                              device=dev))
        logp = torch.log_softmax(logits.float(), dim=-1)
    return _beam_finalize(running_lp, seqs, fin_seqs, fin_scores, s,
                          max_new_tokens, eos_token_id, length_penalty)


@torch.no_grad()
def paged_generate(model, input_ids, prompt_lens, max_new_tokens=32,
                   block_size=16, num_blocks=None, eos_token_id=None,
                   temperature=0.0, top_k=None, top_p=None, generator=None):
    """Continuous-batch decode over a paged cache, on the model's device.

    ``input_ids``: [B, S] right-padded ragged prompts with ``prompt_lens``
    [B]. The pool holds ``num_blocks`` blocks (default: exactly enough for
    the ragged bound, the sum over rows of ceil((prompt_len +
    max_new_tokens) / block_size), not B x max_len); a row's table grows
    at its block boundaries and a finished row's blocks return to the
    manager. The prefill runs the whole-prompt forward (K1, K2, K7), every
    step the decode forward (K1, K4, K7's fold with the pool write).
    ``temperature``/``top_k``/``top_p`` sample through
    ``decoding._sample`` from ``generator`` (a ``torch.Generator`` on the
    model's device; default: seed 0); temperature 0 is greedy. Returns
    ([B, S + max_new_tokens] int64 tokens on the model's device, the
    cache): finished rows are tail-padded with ``eos_token_id``."""
    from paddle_tpu_torch.models.decoding import _sample
    cfg = model_config(model)
    dev = next(model.parameters()).device
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))

    def pick(logits):
        return _sample(logits.float(), gen, temperature, top_k,
                       top_p).cpu().numpy()

    ids = np.asarray(_host(input_ids), np.int64)
    b, s = ids.shape
    lens_np = np.asarray(_host(prompt_lens), np.int64)
    max_total = lens_np + max_new_tokens
    max_blocks = -(-int(max_total.max()) // block_size)
    if num_blocks is None:
        num_blocks = int(sum(-(-int(t) // block_size) for t in max_total))
    mgr = BlockManager(num_blocks, block_size)
    for sid in range(b):
        mgr.allocate(sid, int(lens_np[sid]))
    cache = PagedKVCache.init(cfg.num_hidden_layers, num_blocks, block_size,
                              cfg.num_key_value_heads,
                              cfg.hidden_size // cfg.num_attention_heads,
                              b, max_blocks, cfg.dtype, device=dev)
    cache.block_tables = mgr.table_array(range(b), max_blocks).to(dev)
    logits, cache = llama_prefill_paged(model, ids, lens_np.astype(np.int32),
                                        cache)
    tokens = np.concatenate([ids, np.zeros((b, max_new_tokens), np.int64)],
                            axis=1)
    next_tok = pick(logits)
    active = np.ones((b,), bool)
    cur = lens_np.copy()
    tokens[np.arange(b), cur] = next_tok

    def finish(newly):
        for sid in np.nonzero(newly)[0]:
            active[sid] = False
            mgr.free(int(sid))

    if eos_token_id is not None:
        finish(next_tok == eos_token_id)
    for _ in range(max_new_tokens - 1):
        if not active.any():
            break
        for sid in np.nonzero(active)[0]:    # grow at a block boundary
            mgr.allocate(int(sid), int(cur[sid]) + 1)
        cache.block_tables = mgr.table_array(range(b), max_blocks).to(dev)
        logits, cache = llama_decode_step_paged(
            model, torch.as_tensor(next_tok, device=dev), cache,
            torch.as_tensor(active, device=dev))
        next_tok = np.where(active, pick(logits), next_tok)
        cur = cur + active
        rows = np.nonzero(active)[0]
        tokens[rows, cur[rows]] = next_tok[rows]
        if eos_token_id is not None:
            finish(active & (next_tok == eos_token_id))
    if eos_token_id is not None:
        # finished rows: the tail padded with EOS (HF/PaddleNLP convention)
        for sid in np.nonzero(~active)[0]:
            tokens[sid, int(cur[sid]) + 1:] = eos_token_id
    return torch.from_numpy(tokens).to(dev), cache


# ------------------------------------------------ speculative helpers
# The multi-append/rewind primitives the engine's speculative decoding
# needs: the target VERIFY forward is the chunk prefill with full logits
# (a multi-token append through the block tables, K3 on the card), and
# the rollback past rejected positions is a pure LENGTH rewind — block
# tables untouched, because stale KV beyond a row's length is masked by
# attention and positionally overwritten by the next append.

def llama_verify_chunk_paged(model, input_ids, chunk_lens, offsets,
                             cache: PagedKVCache, slot_ids, table_rows,
                             lora=None, cp_axis=None):
    """Speculative verify: one chunk forward returning [A, C, V] logits
    (see :func:`llama_prefill_chunk_paged` — the same append semantics,
    every chunk position's logits kept for accept/reject)."""
    return llama_prefill_chunk_paged(model, input_ids, chunk_lens, offsets,
                                     cache, slot_ids, table_rows,
                                     full_logits=True, lora=lora,
                                     cp_axis=cp_axis)


@torch.no_grad()
def spec_rewind_lens(cache: PagedKVCache, slot_ids, new_lens):
    """Roll the given slots' lengths back past rejected speculative
    positions, in place. Block tables are NOT touched: the blocks holding
    rejected KV stay owned by their sequences, their stale contents
    unreachable (attention masks ``pos >= lens``) until the next append
    overwrites them. Sentinel slot ids (>= num_slots) are dropped."""
    slots = _host(slot_ids).astype(np.int64)
    keep = (slots >= 0) & (slots < cache.lens.shape[0])
    if keep.any():
        dev = cache.device
        cache.lens[torch.as_tensor(slots[keep], device=dev)] = _dev_i32(
            _host(new_lens)[keep], dev)
    return cache


def spec_advance_frontiers(pos, draft_pos, n_new):
    """Commit one speculative round: the target frontier advances by the
    ``n_new`` committed tokens (accepted prefix + correction/bonus) and
    the draft frontier rolls back past everything it proposed beyond the
    new frontier — its stale cache entries get positionally overwritten
    by the next round's feed. Works on scalars or per-row arrays."""
    new_pos = pos + n_new
    return new_pos, np.minimum(draft_pos, new_pos)


def greedy_accept_length(verify_tokens, proposals):
    """Longest matching prefix between the target's argmax tokens and the
    draft's proposals — the greedy accept rule. ``verify_tokens`` may be
    longer than ``proposals`` (it usually carries the bonus position);
    works on [gamma] rows or [B, gamma] batches, returning a scalar or
    [B] counts."""
    v = np.asarray(verify_tokens)
    p = np.asarray(proposals)
    match = np.cumprod(v[..., : p.shape[-1]] == p, axis=-1)
    return match.sum(axis=-1)


def stochastic_accept_row(props, qs, ps, rng):
    """The Leviathan/Chen accept-reject rule over ONE row: accept
    proposal x_i with probability min(1, p_i(x_i)/q_i(x_i)); the first
    rejection resamples from the residual norm(max(0, p_i - q_i)); a
    fully accepted row draws the bonus token from p_gamma. ``ps`` holds
    len(props)+1 distributions (the extra one is the bonus position).
    Returns (committed tokens, n_accepted); the emitted stream is
    distributed exactly as sampling from ``ps`` alone, for ANY proposal
    distribution ``qs``."""
    new: list[int] = []
    n_acc = 0
    for i, x in enumerate(props):
        x = int(x)
        if rng.uniform() < min(1.0, float(ps[i][x])
                               / max(float(qs[i][x]), 1e-20)):
            new.append(x)
            n_acc += 1
        else:
            resid = np.maximum(ps[i] - qs[i], 0.0)
            z = resid.sum()
            resid = resid / z if z > 0 else ps[i]
            new.append(int(rng.choice(resid.size, p=resid)))
            break
    else:
        new.append(int(rng.choice(ps[len(props)].size, p=ps[len(props)])))
    return new, n_acc


# The forwards above are structure-agnostic via _backbone/_model_logits/
# _mlp_out, so they are ALSO the paged entry points for the MoE families
# (Mixtral, Qwen2-MoE, MoEForCausalLM): expert routing runs inside the
# same prefill/decode forwards.
moe_prefill_paged = llama_prefill_paged
moe_decode_step_paged = llama_decode_step_paged
moe_decode_tick = llama_decode_tick
