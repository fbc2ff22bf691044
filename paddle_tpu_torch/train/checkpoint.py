"""Checkpoint save/load — counterpart of ``paddle_tpu/train/checkpoint.py``
(ref ``paddle.save`` / ``paddle.load`` and Fleet checkpoints).

The file format is the reference's: one ``.npz`` holding every array
leaf under ``a<i>`` and a ``__meta__`` JSON that lists each leaf's
dotted path, kind (``array`` / ``py`` / ``none``), dtype and CRC32. A
JAX-package checkpoint therefore reads here, and a port checkpoint reads
there where its dtypes allow (:func:`paddle_tpu_torch.models.convert.
load_jax_checkpoint` carries a reference model's leaves into the port's).

Leaves come from walking the state: a ``TrainState`` gives ``model``,
``opt_state`` and ``rng``; a module its ``state_dict()`` (parameters and
buffers under their dotted names); dicts and sequences their keys; a
``torch.Generator`` its state bytes. numpy has no bfloat16 (and the card
machine no ``ml_dtypes``): a bfloat16 tensor is written as its raw bits,
``<V2`` with ``"dtype": "bfloat16"`` in the meta, exactly as the
reference writes it, so the CRC covers the same bytes; reading views the
bits back. (The reference itself cannot restore such a leaf into a
bfloat16 target — numpy has no cast from ``V2`` — the port can.)

Restoring into a target is in place, PyTorch's way: each target tensor
is ``copy_``'d (shape checked, cast to its dtype), a generator takes its
state back, and Python leaves (the optimizer's ``step``) come back in a
rebuilt dict. A ``TrainState`` round-trips exactly: parameters, slots,
master copies, ``step`` (and with it the LR schedule's position) and the
generator.

Durability: ATOMIC save (same-directory ``.tmp``, fsync, ``os.replace``,
directory fsync), VERIFIED load (CRC32 per array; a truncated or damaged
file raises :class:`CheckpointCorruptError`), and a
:class:`CheckpointManager` with retention, a ``latest`` pointer that
advances only after the durable rename, fallback past a corrupt latest
checkpoint, and ``async_save`` with at most one save in flight.
"""
from __future__ import annotations

import json
import os
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from paddle_tpu_torch.observability import METRICS, span as _span
from paddle_tpu_torch.observability.flight import FLIGHT
from paddle_tpu_torch.utils.faults import fault_point

_SAVE_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)
_CKPT_SAVES = METRICS.counter("ckpt_saves_total", "durable checkpoint saves")
_CKPT_RESTORES = METRICS.counter(
    "ckpt_restores_total", "successful checkpoint restores")
_CKPT_SAVE_S = METRICS.histogram(
    "ckpt_save_seconds", "wall time of one durable save",
    buckets=_SAVE_BUCKETS)
_CKPT_RESTORE_S = METRICS.histogram(
    "ckpt_restore_seconds", "wall time of one verified load",
    buckets=_SAVE_BUCKETS)
_CKPT_BYTES = METRICS.counter(
    "ckpt_saved_bytes_total", "bytes written by durable saves")
_CKPT_LAST_BYTES = METRICS.gauge(
    "ckpt_last_save_bytes", "size of the newest durable checkpoint")
_CKPT_CRC_FAILS = METRICS.counter(
    "ckpt_crc_failures_total", "array CRC mismatches caught on load")
_CKPT_UNREADABLE = METRICS.counter(
    "ckpt_unreadable_total", "checkpoints that failed to parse at all")
_CKPT_ASYNC_INFLIGHT = METRICS.gauge(
    "ckpt_async_in_flight", "background checkpoint writes in flight (0/1 — "
    "at most one save is ever in flight)")

# dtypes numpy lacks: written as raw bits of the same width (``V<n>``)
_RAW = {torch.bfloat16: (torch.int16, "bfloat16"),
        torch.float8_e4m3fn: (torch.uint8, "float8_e4m3fn"),
        torch.float8_e5m2: (torch.uint8, "float8_e5m2")}
_FROM_RAW = {name: (view, dt) for dt, (view, name) in _RAW.items()}


class CheckpointCorruptError(RuntimeError):
    """Checkpoint failed CRC/structure verification on load."""


def _join(prefix, key):
    return f"{prefix}.{key}" if prefix else str(key)


def _children(tree):
    """(key, child) pairs of a container, or None for a leaf."""
    from paddle_tpu_torch.train.step import TrainState
    if isinstance(tree, TrainState):
        return [("model", tree.model), ("opt_state", tree.opt_state),
                ("rng", tree.rng)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().items())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix=""):
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from _flatten(v, _join(prefix, k))


def _to_host(leaf, copy: bool) -> tuple:
    """(numpy array, dtype name) of an array leaf; ``copy`` forces a
    fresh host buffer (the async snapshot)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy(), "uint8"
    if isinstance(leaf, np.ndarray):
        return (leaf.copy() if copy else leaf), str(leaf.dtype)
    t = leaf.detach()
    t = t.to("cpu", copy=True) if (copy or t.device.type != "cpu") else t
    raw = _RAW.get(t.dtype)
    if raw is not None:
        a = t.contiguous().view(raw[0]).numpy()
        return a.view(f"V{a.dtype.itemsize}"), raw[1]
    a = t.numpy()
    return a, str(a.dtype)


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, np.ndarray, torch.Generator))


def _snapshot(state, copy: bool):
    """(arrays, meta) of ``state``: every array leaf on the host, each
    with its CRC32."""
    arrays, meta = {}, {"leaves": []}
    for i, (p, leaf) in enumerate(_flatten(state)):
        if leaf is None:
            meta["leaves"].append({"path": p, "kind": "none"})
        elif _is_array(leaf):
            key = f"a{i}"
            arrays[key], dt = _to_host(leaf, copy)
            meta["leaves"].append({"path": p, "kind": "array", "key": key,
                                   "dtype": dt})
        else:
            meta["leaves"].append({"path": p, "kind": "py", "value": leaf})
    keyed = [lm for lm in meta["leaves"] if lm["kind"] == "array"]
    for lm, c in zip(keyed, _crcs([arrays[lm["key"]] for lm in keyed])):
        lm["crc"] = c
    return arrays, meta


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes (no copy of a contiguous array)."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8))


def _crcs(arrays) -> list:
    """The CRC32s of many arrays, on a few threads (zlib releases the GIL
    on large buffers)."""
    if len(arrays) < 2:
        return [_crc(a) for a in arrays]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(_crc, arrays))


def _fsync_dir(path: Path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:            # exotic fs: durability is best-effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _npz_path(path) -> Path:
    path = Path(path)
    return path if path.suffix == ".npz" else Path(str(path) + ".npz")


def _write(arrays, meta, path: Path) -> int:
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    with _span("ckpt.save", path=str(path)):
        fault_point("ckpt.write", path=str(path))  # injected host I/O error
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
            f.flush()
            os.fsync(f.fileno())
        fault_point("ckpt.rename", path=str(path))    # the crash window
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    nbytes = path.stat().st_size
    _CKPT_SAVES.inc()
    _CKPT_BYTES.inc(nbytes)
    _CKPT_LAST_BYTES.set(nbytes)
    _CKPT_SAVE_S.observe(time.monotonic() - t0)
    return nbytes


def save(state: Any, path) -> int:
    """``paddle.save``: any state (a module, a ``TrainState``, dicts of
    tensors) -> one file, crash-safe (the bytes reach ``path`` only
    through an fsync'd ``os.replace`` of ``<name>.tmp``). Returns the
    file's size in bytes."""
    arrays, meta = _snapshot(state, copy=False)
    return _write(arrays, meta, _npz_path(path))


def _decode(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of a stored array (raw-bit dtypes viewed back)."""
    if arr.dtype.kind == "V":
        if dtype not in _FROM_RAW:
            raise CheckpointCorruptError(f"unknown raw dtype {dtype!r}")
        view, dt = _FROM_RAW[dtype]
        np_view = np.int16 if view == torch.int16 else np.uint8
        return torch.from_numpy(np.ascontiguousarray(arr).view(np_view)) \
            .view(dt)
    return torch.from_numpy(np.ascontiguousarray(arr))


def load(path, target: Any = None, verify: bool = True) -> Any:
    """``paddle.load``. Without ``target``: {path: value} (arrays as numpy,
    raw-bit dtypes as CPU tensors). With it: restores into the target in
    place and returns it (see the module docstring). ``verify`` checks
    each array's CRC32 and raises :class:`CheckpointCorruptError` on a
    mismatch or an unreadable file."""
    with _span("ckpt.restore", path=str(path)):
        return _load_impl(path, target, verify)


def _read(p: str, verify: bool):
    try:
        with np.load(p, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            leaves_meta = meta["leaves"]
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
    except FileNotFoundError:
        raise
    except Exception as e:      # zip/json damage = corrupt file
        _CKPT_UNREADABLE.inc()
        raise CheckpointCorruptError(f"{p}: unreadable checkpoint "
                                     f"({type(e).__name__}: {e})") from e
    if verify:
        checked = [lm for lm in leaves_meta
                   if lm.get("kind") == "array" and "crc" in lm]
        for lm, got in zip(checked,
                           _crcs([arrays[lm["key"]] for lm in checked])):
            if got != lm["crc"]:
                _CKPT_CRC_FAILS.inc()
                raise CheckpointCorruptError(
                    f"{p}: CRC mismatch for leaf {lm['path']} "
                    f"(stored {lm['crc']:#010x}, got {got:#010x})")
    by_path = {}
    for lm in leaves_meta:
        if lm["kind"] == "array":
            by_path[lm["path"]] = (arrays[lm["key"]], lm.get("dtype", ""))
        elif lm["kind"] == "py":
            by_path[lm["path"]] = (lm["value"], None)
        else:
            by_path[lm["path"]] = (None, None)
    return by_path


def _load_impl(path, target, verify: bool) -> Any:
    p = str(_npz_path(path))
    t0 = time.monotonic()
    by_path = _read(p, verify)
    if target is None:
        out = {k: (_decode(v, dt) if isinstance(v, np.ndarray)
                   and v.dtype.kind == "V" else v)
               for k, (v, dt) in by_path.items()}
    else:
        # every leaf is found and checked before the first write, so a
        # failed restore leaves the target as it was
        writes = []
        out = _restore(target, by_path, "", writes)
        with torch.no_grad():
            for w in writes:
                w()
    _CKPT_RESTORES.inc()
    _CKPT_RESTORE_S.observe(time.monotonic() - t0)
    return out


def _value(by_path, ps):
    if ps not in by_path:
        raise KeyError(f"checkpoint missing leaf {ps}")
    return by_path[ps]


def _decoded_like(leaf, val, dt, ps):
    """The stored value of a tensor / array leaf as a tensor, after checking
    its shape and its kind (floating or not) against the target leaf."""
    t = _decode(np.asarray(val), dt)
    if tuple(t.shape) != tuple(leaf.shape):
        raise ValueError(f"{ps}: shape {tuple(t.shape)} != "
                         f"{tuple(leaf.shape)}")
    floating = (leaf.is_floating_point() if isinstance(leaf, torch.Tensor)
                else np.issubdtype(leaf.dtype, np.floating))
    if t.is_floating_point() != floating:
        raise ValueError(f"{ps}: stored {t.dtype} cannot restore a "
                         f"{leaf.dtype} leaf")
    return t


def _restore_leaf(leaf, val, dt, ps, writes):
    """The restored leaf; an in-place write into a live tensor or generator
    is appended to ``writes`` and made only once every leaf checked."""
    if isinstance(leaf, torch.Generator):
        st = torch.from_numpy(np.array(val, dtype=np.uint8))
        writes.append(lambda: leaf.set_state(st))
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = _decoded_like(leaf, val, dt, ps)
        writes.append(lambda: leaf.copy_(t.to(dtype=leaf.dtype)))
        return leaf
    if isinstance(leaf, np.ndarray):
        return _decoded_like(leaf, val, dt, ps).numpy().astype(leaf.dtype)
    return val if val is not None else leaf


def _restore(target, by_path, prefix, writes):
    from paddle_tpu_torch.train.step import TrainState
    kids = _children(target)
    if kids is None:
        val, dt = _value(by_path, prefix)
        return _restore_leaf(target, val, dt, prefix, writes)
    new = {k: _restore(v, by_path, _join(prefix, k), writes) for k, v in kids}
    if isinstance(target, TrainState):
        return TrainState(new["model"], new["opt_state"], new["rng"])
    if isinstance(target, torch.nn.Module):
        return target        # its state_dict tensors are copied in place
    if isinstance(target, dict):
        return new
    return type(target)(new[i] for i in range(len(target)))


class CheckpointManager:
    """Step-numbered checkpoints with retention (ref Fleet auto ckpt).

    ``save`` is atomic, the ``latest`` pointer advances only AFTER the
    checkpoint's durable rename, and ``restore`` verifies CRCs, falling
    back step by step to the newest checkpoint that still loads
    (``fallback=False`` restores strictly the requested step or raises).

    ``async_save=True``: ``save`` copies every tensor to fresh host
    buffers ON THE CALLER'S THREAD (so a later in-place update can never
    race the copy), then hands the tmp+fsync+``os.replace`` protocol to
    one background writer thread and returns. At most one save is in
    flight (a second ``save`` first waits out the previous one);
    ``wait()`` joins the writer and re-raises anything it threw. "save
    returned" means "snapshot taken", not "durable"."""

    def __init__(self, directory, max_to_keep: int = 3,
                 use_orbax: bool = False, async_save: bool = False):
        if use_orbax:
            raise NotImplementedError(
                "use_orbax=True: orbax writes JAX's sharded checkpoints; "
                "sharded checkpoints of the port come with the distributed "
                "slice (ROADMAP.md queue 1 item 7)")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.use_orbax = False
        self.async_save = async_save
        self.last_restored_step: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._writer_exc: Optional[BaseException] = None

    def _step_path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def _write_latest(self, step: int):
        tmp = self.dir / "latest.tmp"
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dir / "latest")
        _fsync_dir(self.dir)

    def save(self, step: int, state) -> None:
        if self.async_save:
            return self._save_async(step, state)
        save(state, self._step_path(step))
        # pointer AFTER the durable rename: a kill anywhere before this
        # line leaves ``latest`` on the previous good checkpoint
        self._write_latest(step)
        self._gc()
        FLIGHT.record("ckpt.save", step=step)

    def _save_async(self, step: int, state) -> None:
        self.wait()          # one save in flight, ever
        arrays, meta = _snapshot(state, copy=True)
        _CKPT_ASYNC_INFLIGHT.set(1)

        def _write_bg():
            try:
                _write(arrays, meta, self._step_path(step))
                self._write_latest(step)
                self._gc()
                FLIGHT.record("ckpt.save", step=step, mode="async")
            except BaseException as e:   # surfaced by wait()/next save()
                self._writer_exc = e
            finally:
                _CKPT_ASYNC_INFLIGHT.set(0)

        self._writer = threading.Thread(target=_write_bg,
                                        name="pt-ckpt-writer", daemon=True)
        self._writer.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight background save (if any) is durable;
        re-raise anything the writer threw. A no-op in sync mode."""
        t = self._writer
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"checkpoint writer still running after {timeout}s")
            self._writer = None
        if self._writer_exc is not None:
            exc, self._writer_exc = self._writer_exc, None
            raise exc

    def all_steps(self) -> list:
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("ckpt_*.npz"))

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if ptr.exists():
            try:
                step = int(ptr.read_text().strip())
                if self._step_path(step).exists():
                    return step
            except (ValueError, OSError):
                pass           # damaged pointer: fall back to the glob
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None,
                fallback: bool = True):
        """Restore into ``state_like`` (in place; see :func:`load`) and
        return it, or None when the directory holds no checkpoint."""
        if step is not None:
            out = load(self._step_path(step), target=state_like)
            self.last_restored_step = step
            return out
        start = self.latest_step()
        if start is None:
            return None
        if not fallback:
            out = load(self._step_path(start), target=state_like)
            self.last_restored_step = start
            return out
        candidates = [s for s in reversed(self.all_steps()) if s <= start]
        errors = []
        for s in candidates:
            try:
                out = load(self._step_path(s), target=state_like)
                self.last_restored_step = s
                if errors:
                    import warnings
                    warnings.warn(
                        f"CheckpointManager: fell back to step {s} — newer "
                        f"checkpoint(s) failed verification: {errors}")
                return out
            except (CheckpointCorruptError, OSError, KeyError,
                    ValueError) as e:
                errors.append(f"step {s}: {type(e).__name__}: {e}")
        raise CheckpointCorruptError(
            f"no loadable checkpoint in {self.dir} (tried "
            f"{candidates}); failures: {errors}")

    def _gc(self):
        """Keep the newest ``max_to_keep`` — never the one ``latest``
        points at, which is always the newest."""
        ckpts = sorted(self.dir.glob("ckpt_*.npz"))
        while len(ckpts) > self.max_to_keep:
            ckpts.pop(0).unlink()


def save_state_dict(module, path):
    """The module's ``state_dict()`` alone."""
    save(dict(module.state_dict()), path)


def load_state_dict(module, path):
    load(path, target=module)
    return module
