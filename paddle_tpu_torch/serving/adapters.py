"""AdapterStore: the multi-tenant LoRA registry + device cache —
counterpart of ``paddle_tpu/serving/adapters.py``.

A fleet serves many fine-tuned variants of ONE base model. The
S-LoRA/Punica pattern this store feeds: every tenant's adapter is a
rank-r pair (A, B) per targeted projection; the batch runs the shared
base forward once, and a grouped rank-r correction ``y += scale * (x @
A) @ B`` is added per row according to that row's adapter
(``models/paged.py`` ``_lora_delta``, two products on K6a). For that to
be one program, the resident adapters live as STACKED fp32 device
tensors — ``[L, capacity, in, r_max]`` and ``[L, capacity, r_max, out]``
per projection — indexed by a per-row cache index.

This module owns the lifecycle around that:

* ``register(adapter_id, state_dict)`` — host-resident adapter sets,
  validated STRICTLY via :func:`~paddle_tpu_torch.peft.lora_load_state_dict`
  (missing/unexpected keys raise ``ValueError``), rank-padded to
  ``max_rank`` with the ``alpha/r`` scale folded into B (zero-padding
  keeps the folded product exact).
* ``acquire(adapter_id)`` — LRU device cache of ``capacity`` stacked
  slots with host→device hot-swap; returns the cache index and takes a
  REF-COUNT pin so an adapter in use by a scheduled slot is never
  evicted. ``release`` drops the pin. When every resident entry is
  pinned and a new adapter needs a slot, ``acquire`` raises — the
  scheduler defers that admission rather than corrupt a live batch.
* the ``serving.adapter_swap`` fault site fires BEFORE the upload
  mutates anything, so an injected fault leaves the cache, the pins and
  the free list exactly as they were (the scheduler turns it into a
  deferred admission).

Where the reference rebinds its stacks (``.at[:, idx].set``), the upload
here writes the entry IN PLACE into stacks allocated once on the model's
device: :meth:`stacks` returns the same tensors for the store's whole
life, so the engine's captured LoRA tick (``serving/executor.py``) reads
every later upload at its next replay.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from paddle_tpu_torch.peft import lora_load_state_dict, lora_targets
from paddle_tpu_torch.serving.telemetry import (_ADAPTER_EVICTIONS,
                                                _ADAPTER_HITS,
                                                _ADAPTER_MISSES,
                                                _ADAPTER_RESIDENT,
                                                _ADAPTER_UPLOADS)
from paddle_tpu_torch.utils.faults import fault_point

# serving targets the attention projections (the fused qkv and the
# output proj) — the pair the paged forwards thread the correction into
SERVING_TARGETS = ("qkv_proj", "o_proj")
_KIND_OF = {"qkv_proj": "qkv", "o_proj": "o"}


class AdapterStore:
    """Registered LoRA adapter sets + a device-resident stacked cache on
    the model's device."""

    def __init__(self, model, *, capacity: int = 4, max_rank: int = 8,
                 target_modules=SERVING_TARGETS):
        self.capacity = int(capacity)
        self.max_rank = int(max_rank)
        if self.capacity < 1:
            raise ValueError("adapter cache capacity must be >= 1")
        paths = lora_targets(model, target_modules)
        params = dict(model.named_parameters())
        # path -> (layer, kind); layers must tile 0..L-1 for each kind
        self._slot_of: dict[str, tuple[int, str]] = {}
        dims: dict[str, tuple[int, int]] = {}
        layers = set()
        for p in paths:
            m = re.search(r"layers\.(\d+)\.", p)
            leaf = p.split(".")[-2] if p.endswith(".weight") else \
                p.split(".")[-1]
            if m is None or leaf not in _KIND_OF:
                raise ValueError(f"cannot place LoRA target {p!r}")
            li, kind = int(m.group(1)), _KIND_OF[leaf]
            self._slot_of[p] = (li, kind)
            layers.add(li)
            d = tuple(params[p].shape)
            if dims.setdefault(kind, d) != d:
                raise ValueError(f"inconsistent {kind} shapes across layers")
        self.num_layers = max(layers) + 1
        self.device = params[paths[0]].device
        self._paths = paths
        self._dims = dims                       # kind -> (fan_in, fan_out)
        self._host: dict[object, dict[str, tuple[np.ndarray, np.ndarray]]] \
            = {}
        self._resident: OrderedDict[object, int] = OrderedDict()  # MRU last
        self._pins: dict[object, int] = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        self._stacks = {}
        for kind, (k, n) in dims.items():
            self._stacks[kind + "_a"] = torch.zeros(
                (self.num_layers, self.capacity, k, self.max_rank),
                dtype=torch.float32, device=self.device)
            self._stacks[kind + "_b"] = torch.zeros(
                (self.num_layers, self.capacity, self.max_rank, n),
                dtype=torch.float32, device=self.device)

    # ----------------------------------------------------------- registry
    def register(self, adapter_id, state_dict: dict):
        """Validate and install a tenant's adapter set (host-resident).
        Re-registering an UNPINNED id replaces it (and drops any stale
        device residency); a pinned id is in use and refuses."""
        if adapter_id is None:
            raise ValueError("adapter_id None is reserved for the base model")
        if self._pins.get(adapter_id):
            raise ValueError(f"adapter {adapter_id!r} is pinned by "
                             "scheduled requests; cannot re-register")
        template = {p: {"a": torch.zeros((shape[0], 1)),
                        "b": torch.zeros((1, shape[1]))}
                    for p, shape in ((p, self._dims[self._slot_of[p][1]])
                                     for p in self._paths)}
        template["_scale"] = torch.zeros(())
        tree = lora_load_state_dict(template, state_dict)   # strict keys
        scale = float(tree["_scale"])
        per_kind: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for kind, (k, n) in self._dims.items():
            per_kind[kind] = (
                np.zeros((self.num_layers, k, self.max_rank), np.float32),
                np.zeros((self.num_layers, self.max_rank, n), np.float32))
        for p in self._paths:
            li, kind = self._slot_of[p]
            k, n = self._dims[kind]
            a = tree[p]["a"].numpy()
            b = tree[p]["b"].numpy()
            r = a.shape[1] if a.ndim == 2 else -1
            if a.shape != (k, r) or b.shape != (r, n) or r < 1:
                raise ValueError(
                    f"adapter {adapter_id!r}: {p} has A{a.shape}/B{b.shape}"
                    f", expected A({k}, r)/B(r, {n})")
            if r > self.max_rank:
                raise ValueError(
                    f"adapter {adapter_id!r}: rank {r} exceeds the store's "
                    f"max_rank {self.max_rank}")
            # zero-padding to max_rank keeps scale*(x@A)@B exact
            per_kind[kind][0][li, :, :r] = a
            per_kind[kind][1][li, :r, :] = b * scale   # fold the scale in
        self._host[adapter_id] = per_kind
        idx = self._resident.pop(adapter_id, None)
        if idx is not None:                    # stale device copy: drop it
            self._free.append(idx)
            _ADAPTER_RESIDENT.set(len(self._resident))

    def known(self, adapter_id) -> bool:
        return adapter_id in self._host

    # ------------------------------------------------------- device cache
    def ensure(self, adapter_id) -> int:
        """Make ``adapter_id`` device-resident; returns its cache index.
        Exception-atomic: the ``serving.adapter_swap`` site fires before
        any mutation, and a failed victim search mutates nothing."""
        idx = self._resident.get(adapter_id)
        if idx is not None:
            self._resident.move_to_end(adapter_id)
            _ADAPTER_HITS.inc()
            return idx
        host = self._host.get(adapter_id)
        if host is None:
            raise KeyError(f"adapter {adapter_id!r} is not registered")
        _ADAPTER_MISSES.inc()
        victim = None
        if not self._free:
            for aid in self._resident:         # LRU first
                if not self._pins.get(aid):
                    victim = aid
                    break
            if victim is None:
                raise RuntimeError(
                    "adapter cache exhausted: all "
                    f"{self.capacity} resident adapters are pinned")
        fault_point("serving.adapter_swap", store=self, adapter=adapter_id,
                    victim=victim)
        if victim is None:
            idx = self._free.pop()
        else:
            idx = self._resident.pop(victim)
            _ADAPTER_EVICTIONS.inc()
        with torch.no_grad():
            for kind, (a, b) in host.items():
                # in place: a captured tick keeps reading these tensors
                self._stacks[kind + "_a"][:, idx].copy_(torch.from_numpy(a))
                self._stacks[kind + "_b"][:, idx].copy_(torch.from_numpy(b))
        self._resident[adapter_id] = idx
        _ADAPTER_UPLOADS.inc()
        _ADAPTER_RESIDENT.set(len(self._resident))
        return idx

    def acquire(self, adapter_id) -> int:
        """``ensure`` + pin: the index stays valid until ``release``."""
        idx = self.ensure(adapter_id)
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
        return idx

    def release(self, adapter_id):
        n = self._pins.get(adapter_id, 0) - 1
        if n > 0:
            self._pins[adapter_id] = n
        else:
            self._pins.pop(adapter_id, None)

    def index_of(self, adapter_id) -> int:
        """Cache index of a RESIDENT adapter (stable while pinned)."""
        return self._resident[adapter_id]

    def stacks(self) -> dict:
        """The stacked device tensors the forwards index: ``{qkv_a, qkv_b,
        o_a, o_b}``, each ``[L, capacity, ...]`` fp32 — the same tensors
        at every call (uploads write into them)."""
        return dict(self._stacks)

    def assert_quiescent(self):
        """No pins outstanding (every scheduled slot released its hold)."""
        assert not self._pins, f"adapter pin leak: {self._pins}"
