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

Sharded states (a module :func:`~paddle_tpu_torch.distributed.sharded.
shard_module` sharded over a ``HybridMesh``, alone or as a TrainState's
model): the file holds the GLOBAL arrays, as the reference's does — the
parameters under their reference names (``state_dict()`` gathers them and
undoes the tp interleave) and the optimizer's slots gathered the same way
under the same names — so one file serves any mesh and the JAX package.
Saving is collective: every rank of the mesh takes part in the gathers,
the mesh's first rank alone writes, and the ranks agree that the write
succeeded before ``save`` returns (a rank-0 guard AROUND ``save``
deadlocks the gathers). Restoring slices each global array into the
rank's piece (:func:`~paddle_tpu_torch.distributed.sharded.local_piece`:
the tp interleave reapplied, the FSDP chunk, the ep slice) and copies it
into the LIVE local parameter and slot tensors. Scalars (``step``,
``lr``) and the generator are replicated.

``CheckpointManager(use_orbax=True)`` is the sharded format, the
counterpart of the reference's orbax checkpoints (each process writes
only its shards; restore works across meshes): a directory a step with
one file a rank (its local pieces, the ``.npz`` format above) and an
``index.json`` that the first rank writes once every rank's file is
durable — each sharded leaf's global shape, spec, FSDP dim and tp
interleave, and the mesh it was saved under. A restore into the same
mesh reads the rank's own file; into another mesh (or one process) it
assembles the global arrays from the index and the pieces.

Durability: ATOMIC save (same-directory ``.tmp``, fsync, ``os.replace``,
directory fsync), VERIFIED load (CRC32 per array; a truncated or damaged
file raises :class:`CheckpointCorruptError`), and a
:class:`CheckpointManager` with retention, a ``latest`` pointer that
advances only after the durable rename (under a mesh: after the ranks
agreed that every rank's rename succeeded), fallback past a corrupt
latest checkpoint (under a mesh a collective decision: the ranks take
the newest step that EVERY rank verified), and ``async_save`` with at
most one save in flight.
"""
from __future__ import annotations

import json
import os
import shutil
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
# the sharded format's index: its name in a step's directory and version
_INDEX = "index.json"
_FORMAT = "paddle_tpu_torch.sharded.v1"


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


# ------------------------------------------------------- sharded states
class _Piece:
    """A live local tensor ``t`` of a global array sharded as ``info``
    (a ``ShardInfo``, None: whole) over ``mesh``: restore slices the
    stored global array into it."""
    __slots__ = ("t", "info", "mesh")

    def __init__(self, t, info, mesh):
        self.t, self.info, self.mesh = t, info, mesh


def _sharded_module(state):
    """The sharded module of ``state`` (itself, or a TrainState's model),
    or None."""
    from paddle_tpu_torch.train.step import TrainState
    m = state.model if isinstance(state, TrainState) else state
    if isinstance(m, torch.nn.Module) and \
            getattr(m, "_pt_mesh", None) is not None:
        return m
    return None


def _mesh_of(state):
    m = _sharded_module(state)
    return None if m is None else m._pt_mesh


def _rank(mesh) -> int:
    return 0 if mesh is None else int(mesh.rank)


def _is_writer(mesh) -> bool:
    """The rank that writes a global file: the mesh's first."""
    return mesh is None or mesh.rank == int(mesh.grid.flat[0])


def _side_group(mesh):
    """A gloo group over the mesh's ranks for the checkpoint's own
    agreements (None for one rank). Apart from the train step's groups,
    so the async writer thread can use it while the caller's thread runs
    the step's collectives. Made by its members on the caller's thread,
    once."""
    if mesh is None or mesh.grid.size == 1:
        return None
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import mesh as M
    ranks = tuple(sorted(int(r) for r in mesh.grid.ravel()))
    key = ("ckpt",) + ranks
    g = M._GROUPS.get(key)
    if g is None:
        g = dist.new_group(list(ranks), backend="gloo",
                           use_local_synchronization=True)
        M._GROUPS[key] = g
    return g


def _min(group, value: int) -> int:
    """The least ``value`` over ``group``'s ranks (a barrier too)."""
    if group is None:
        return value
    import torch.distributed as dist
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


def _slot_dicts(tree, params, fn):
    """An optimizer state with every slot dict (a dict keyed by the
    model's ``named_parameters()`` names) re-keyed by the parameters'
    reference names and each tensor ``t`` of parameter ``p`` replaced by
    ``fn(t, p)``."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(k in params for k in tree):
        return {params[k][0]: (fn(v, params[k][1])
                               if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}
    return {k: _slot_dicts(v, params, fn) for k, v in tree.items()}


def _unslot(new, orig, params):
    """The restored optimizer state: ``orig``'s slot dicts (their tensors
    were written in place) and ``new``'s other values."""
    if not isinstance(orig, dict):
        return new
    if orig and all(k in params for k in orig):
        return orig
    return {k: _unslot(new[k], orig[k], params) for k in orig}


def _module_view(m, fn) -> dict:
    """{reference name: fn(local parameter)} of a sharded module, plus its
    persistent buffers — no gather."""
    from paddle_tpu_torch.distributed.sharded import sharded_params
    out = {cn: fn(p) for cn, p in sharded_params(m).values()}
    for mname, sub in m.named_modules():
        for bname, b in sub._buffers.items():
            if b is not None and bname not in sub._non_persistent_buffers_set:
                out[_join(mname, bname)] = b
    return out


def _view(state, param_fn, slot_fn, model=None):
    """A sharded state as the plain tree the flatten walks: the model's
    leaves (``model``, else ``param_fn`` of each local parameter) and the
    slots re-keyed (``slot_fn``); the state itself when it is not
    sharded."""
    from paddle_tpu_torch.distributed.sharded import sharded_params
    from paddle_tpu_torch.train.step import TrainState
    m = _sharded_module(state)
    if m is None:
        return state
    mv = model if model is not None else _module_view(m, param_fn)
    if not isinstance(state, TrainState):
        return mv
    return {"model": mv,
            "opt_state": _slot_dicts(state.opt_state, sharded_params(m),
                                     slot_fn),
            "rng": state.rng}


def _global_view(state):
    """The global arrays of a sharded state (a collective over the shard
    axes: every rank of the mesh calls it, in the same order)."""
    from paddle_tpu_torch.distributed.sharded import _global
    m = _sharded_module(state)
    if m is None:
        return state
    mesh = m._pt_mesh
    return _view(state, None,
                 lambda t, p: _global(t, getattr(p, "_pt_shard", None),
                                      mesh),
                 model=m.state_dict())


def _local_view(state):
    """A sharded state's local pieces under the reference names."""
    return _view(state, lambda p: p, lambda t, p: t)


def _piece_view(state):
    """A sharded state's live tensors as :class:`_Piece` targets."""
    m = _sharded_module(state)
    if m is None:
        return state
    mesh = m._pt_mesh

    def piece(t, p):
        return _Piece(t, getattr(p, "_pt_shard", None), mesh)
    return _view(state, lambda p: piece(p, p), piece)


def _rebuilt(target, new_view):
    """The restore's result for ``target`` from the restored view."""
    from paddle_tpu_torch.distributed.sharded import sharded_params
    from paddle_tpu_torch.train.step import TrainState
    m = _sharded_module(target)
    if m is None:
        return new_view
    if not isinstance(target, TrainState):
        return target
    return TrainState(target.model,
                      _unslot(new_view["opt_state"], target.opt_state,
                              sharded_params(m)),
                      new_view["rng"])


# -------------------------------------------------------------- saving
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


def _write_text(path: Path, text: str):
    """``text`` into ``path`` through an fsync'd same-directory tmp file
    and ``os.replace``."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)


def _agreed(group, ok: bool, err, what: str):
    """Raise on every rank unless every rank of ``group`` succeeded (this
    rank its own error, the others a named one)."""
    if _min(group, int(ok)):
        return
    if err is not None:
        raise err
    raise RuntimeError(f"{what} failed on another rank")


def save(state: Any, path) -> int:
    """``paddle.save``: any state (a module, a ``TrainState``, dicts of
    tensors) -> one file, crash-safe (the bytes reach ``path`` only
    through an fsync'd ``os.replace`` of ``<name>.tmp``). Returns the
    file's size in bytes (0 on a rank that does not write). A sharded
    state is saved collectively (see the module docstring)."""
    mesh = _mesh_of(state)
    view = _global_view(state)            # every rank: the gathers
    ok, err, n = True, None, 0
    if _is_writer(mesh):
        try:
            arrays, meta = _snapshot(view, copy=False)
            n = _write(arrays, meta, _npz_path(path))
        except BaseException as e:
            if mesh is None:
                raise
            ok, err = False, e
    _agreed(_side_group(mesh), ok, err, "checkpoint save")
    return n


# ------------------------------------------------------------- loading
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


def _as_tensor(val, dt) -> torch.Tensor:
    if isinstance(val, torch.Tensor):
        return val
    return _decode(np.asarray(val), dt)


def load(path, target: Any = None, verify: bool = True) -> Any:
    """``paddle.load``. Without ``target``: {path: value} (arrays as numpy,
    raw-bit dtypes as CPU tensors). With it: restores into the target in
    place and returns it (see the module docstring; a sharded target
    takes its pieces of the file's global arrays, no communication).
    ``verify`` checks each array's CRC32 and raises
    :class:`CheckpointCorruptError` on a mismatch or an unreadable
    file."""
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


def _prepare(by_path, target, view=None):
    """(the restored state, the in-place writes) of ``target`` from
    ``by_path``; every leaf is found and checked before the first write,
    so a failed restore leaves the target as it was. ``view``: the tree
    whose leaves the values land in (default: ``target``'s pieces)."""
    writes = []
    view = _piece_view(target) if view is None else view
    out = _restore(view, by_path, "", writes)
    return _rebuilt(target, out), writes


def _commit(writes):
    with torch.no_grad():
        for w in writes:
            w()


def _load_impl(path, target, verify: bool) -> Any:
    p = str(_npz_path(path))
    t0 = time.monotonic()
    by_path = _read(p, verify)
    if target is None:
        out = {k: (_decode(v, dt) if isinstance(v, np.ndarray)
                   and v.dtype.kind == "V" else v)
               for k, (v, dt) in by_path.items()}
    else:
        out, writes = _prepare(by_path, target)
        _commit(writes)
    _CKPT_RESTORES.inc()
    _CKPT_RESTORE_S.observe(time.monotonic() - t0)
    return out


def _value(by_path, ps):
    if ps not in by_path:
        raise KeyError(f"checkpoint missing leaf {ps}")
    return by_path[ps]


def _decoded_like(shape, floating, val, dt, ps):
    """The stored value of a tensor / array leaf as a tensor, after checking
    its shape and its kind (floating or not) against the target's."""
    t = _as_tensor(val, dt)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{ps}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.is_floating_point() != floating:
        raise ValueError(f"{ps}: stored {t.dtype} cannot restore a "
                         f"{'floating' if floating else 'non-floating'} "
                         f"leaf")
    return t


def _restore_leaf(leaf, val, dt, ps, writes):
    """The restored leaf; an in-place write into a live tensor or generator
    is appended to ``writes`` and made only once every leaf checked."""
    if isinstance(leaf, torch.Generator):
        st = torch.from_numpy(np.array(val, dtype=np.uint8))
        writes.append(lambda: leaf.set_state(st))
        return leaf
    if isinstance(leaf, _Piece):
        from paddle_tpu_torch.distributed.sharded import (global_shape,
                                                          local_piece)
        dst = leaf.t
        t = _decoded_like(global_shape(dst.shape, leaf.info, leaf.mesh),
                          dst.is_floating_point(), val, dt, ps)
        t = local_piece(t, leaf.info, leaf.mesh)
        writes.append(lambda: dst.copy_(t.to(dtype=dst.dtype)))
        return dst
    if isinstance(leaf, torch.Tensor):
        t = _decoded_like(leaf.shape, leaf.is_floating_point(), val, dt, ps)
        writes.append(lambda: leaf.copy_(t.to(dtype=leaf.dtype)))
        return leaf
    if isinstance(leaf, np.ndarray):
        t = _decoded_like(leaf.shape, np.issubdtype(leaf.dtype, np.floating),
                          val, dt, ps)
        return t.numpy().astype(leaf.dtype)
    return val if val is not None else leaf


def _restore(target, by_path, prefix, writes):
    from paddle_tpu_torch.train.step import TrainState
    kids = None if isinstance(target, _Piece) else _children(target)
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


# ------------------------------------------------ the sharded format
def _index(state, mesh, step) -> dict:
    """The sharded format's index: each sharded leaf's global shape, spec,
    FSDP dim and tp interleave, and the mesh's grid of ranks."""
    from paddle_tpu_torch.distributed.mesh import GRID_AXES
    from paddle_tpu_torch.distributed.sharded import global_shape
    leaves = {}
    for p, leaf in _flatten(_piece_view(state)):
        if isinstance(leaf, _Piece) and leaf.info is not None:
            i = leaf.info
            leaves[p] = {"shape": list(global_shape(leaf.t.shape, i, mesh)),
                         "spec": list(i.spec), "fsdp_dim": i.fsdp_dim,
                         "perm": (None if i.perm is None
                                  else i.perm.cpu().tolist())}
    grid = (np.zeros((1,) * len(GRID_AXES), np.int64) if mesh is None
            else mesh.grid)
    return {"format": _FORMAT, "step": int(step), "axes": list(GRID_AXES),
            "grid": grid.tolist(), "leaves": leaves}


def _rank_file(d: Path, rank: int) -> Path:
    return d / f"rank_{rank:05d}.npz"


def _read_index(d: Path) -> dict:
    p = d / _INDEX
    try:
        index = json.loads(p.read_text())
    except FileNotFoundError:
        raise
    except Exception as e:
        _CKPT_UNREADABLE.inc()
        raise CheckpointCorruptError(f"{p}: unreadable index "
                                     f"({type(e).__name__}: {e})") from e
    if index.get("format") != _FORMAT:
        raise CheckpointCorruptError(f"{p}: not a {_FORMAT} index")
    return index


def _same_mesh(index, mesh) -> bool:
    """Whether ``mesh`` is the mesh the index was saved under (the same
    grid of ranks), so each rank's own file holds its pieces."""
    grid = np.asarray(index["grid"])
    if mesh is None:
        return grid.size == 1
    return grid.shape == mesh.grid.shape and np.array_equal(grid, mesh.grid)


def _assemble(d: Path, index: dict, verify: bool) -> dict:
    """The global arrays of a sharded-format step: each sharded leaf's
    pieces read from the ranks that hold them (at index 0 of every other
    axis), concatenated along their dims and the tp interleave undone;
    the other leaves from the first rank's file."""
    axes = index["axes"]
    grid = np.asarray(index["grid"])
    files: dict = {}

    def read(rank):
        if rank not in files:
            files[rank] = _read(str(_rank_file(d, rank)), verify)
        return files[rank]

    out = dict(read(int(grid.flat[0])))
    for path, li in index["leaves"].items():
        sizes = dict(zip(axes, grid.shape))
        spec = li["spec"]
        dims = [(ax, dim) for dim, ax in enumerate(spec)
                if ax in ("tp", "ep") and sizes[ax] > 1]
        if li["fsdp_dim"] is not None:
            dims.append(("fsdp", li["fsdp_dim"]))

        def get(coords, path=path):
            rank = int(grid[tuple(coords.get(a, 0) for a in axes)])
            val, dt = read(rank)[path]
            return _as_tensor(val, dt)

        def cat(coords, rest):
            if not rest:
                return get(coords)
            (ax, dim), tail = rest[0], rest[1:]
            return torch.cat([cat({**coords, ax: i}, tail)
                              for i in range(sizes[ax])], dim)

        x = cat({}, dims)
        if li["perm"] is not None and "tp" in spec and sizes["tp"] > 1:
            x = x.index_select(spec.index("tp"),
                               torch.argsort(torch.as_tensor(li["perm"])))
        if list(x.shape) != li["shape"]:
            raise CheckpointCorruptError(
                f"{d}: leaf {path} assembles to {list(x.shape)}, the index "
                f"says {li['shape']}")
        out[path] = (x, None)
    return out


class CheckpointManager:
    """Step-numbered checkpoints with retention (ref Fleet auto ckpt).

    ``save`` is atomic, the ``latest`` pointer advances only AFTER the
    checkpoint's durable rename, and ``restore`` verifies CRCs, falling
    back step by step to the newest checkpoint that still loads
    (``fallback=False`` restores strictly the requested step or raises).

    ``async_save=True``: ``save`` copies every tensor to fresh host
    buffers ON THE CALLER'S THREAD (so a later in-place update can never
    race the copy; under a mesh the gathers run there too), then hands
    the tmp+fsync+``os.replace`` protocol to one background writer thread
    and returns. At most one save is in flight (a second ``save`` first
    waits out the previous one); ``wait()`` joins the writer and re-raises
    anything it threw. "save returned" means "snapshot taken", not
    "durable".

    ``use_orbax=True``: the sharded format (module docstring), one file a
    rank plus the index. Under a mesh every method is collective over the
    mesh's ranks (``save``, ``restore``; the writer threads agree through
    a gloo group of their own), and the ranks must see one directory."""

    def __init__(self, directory, max_to_keep: int = 3,
                 use_orbax: bool = False, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.use_orbax = bool(use_orbax)
        self.async_save = async_save
        self.last_restored_step: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._writer_exc: Optional[BaseException] = None

    def _step_path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def _shard_dir(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}"

    def _write_latest(self, step: int):
        _write_text(self.dir / "latest", str(step))

    def save(self, step: int, state) -> None:
        mesh = _mesh_of(state)
        if self.async_save:
            self.wait()          # one save in flight, ever
        group = _side_group(mesh)
        copy = self.async_save
        if self.use_orbax:
            arrays, meta = _snapshot(
                _local_view(state) if mesh is not None else state, copy)
            index = _index(state, mesh, step) if _is_writer(mesh) else None

            def job():
                self._commit_sharded(step, arrays, meta, index, mesh, group)
        else:
            view = _global_view(state)        # every rank: the gathers
            arrays, meta = (_snapshot(view, copy) if _is_writer(mesh)
                            else (None, None))

            def job():
                self._commit_global(step, arrays, meta, mesh, group)
        if not self.async_save:
            job()
            FLIGHT.record("ckpt.save", step=step)
            return
        _CKPT_ASYNC_INFLIGHT.set(1)

        def _write_bg():
            try:
                job()
                FLIGHT.record("ckpt.save", step=step, mode="async")
            except BaseException as e:   # surfaced by wait()/next save()
                self._writer_exc = e
            finally:
                _CKPT_ASYNC_INFLIGHT.set(0)

        self._writer = threading.Thread(target=_write_bg,
                                        name="pt-ckpt-writer", daemon=True)
        self._writer.start()

    def _commit_global(self, step, arrays, meta, mesh, group):
        """The writer writes the global file; once the ranks agreed that
        it is durable the writer moves ``latest`` (a kill anywhere before
        leaves it on the previous good checkpoint) and trims."""
        ok, err = True, None
        if _is_writer(mesh):
            try:
                _write(arrays, meta, self._step_path(step))
            except BaseException as e:
                if group is None:
                    raise
                ok, err = False, e
        _agreed(group, ok, err, "checkpoint write")
        if _is_writer(mesh):
            self._write_latest(step)
            self._gc()
        _min(group, 1)              # latest moved before any rank returns

    def _commit_sharded(self, step, arrays, meta, index, mesh, group):
        """Every rank writes its file; once every rank's rename succeeded
        the first rank writes the index (which makes the step complete),
        then ``latest``, then trims."""
        d = self._shard_dir(step)
        ok, err = True, None
        try:
            _write(arrays, meta, _rank_file(d, _rank(mesh)))
        except BaseException as e:
            if group is None:
                raise
            ok, err = False, e
        _agreed(group, ok, err, "checkpoint write")
        if _is_writer(mesh):
            _write_text(d / _INDEX, json.dumps(index))
            self._write_latest(step)
            self._gc()
        _min(group, 1)

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
        if self.use_orbax:
            return sorted(int(p.name.split("_")[1])
                          for p in self.dir.glob("ckpt_*")
                          if p.is_dir() and (p / _INDEX).exists())
        return sorted(int(p.stem.split("_")[1])
                      for p in self.dir.glob("ckpt_*.npz"))

    def _exists(self, step: int) -> bool:
        if self.use_orbax:
            return (self._shard_dir(step) / _INDEX).exists()
        return self._step_path(step).exists()

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "latest"
        if ptr.exists():
            try:
                step = int(ptr.read_text().strip())
                if self._exists(step):
                    return step
            except (ValueError, OSError):
                pass           # damaged pointer: fall back to the glob
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _prepare_step(self, step: int, target):
        """(restored state, writes) of one step into ``target``, every file
        read and verified; nothing written yet."""
        mesh = _mesh_of(target)
        if not self.use_orbax:
            return _prepare(_read(str(self._step_path(step)), True), target)
        d = self._shard_dir(step)
        index = _read_index(d)
        if _same_mesh(index, mesh):
            rank = (_rank(mesh) if mesh is not None
                    else int(np.asarray(index["grid"]).flat[0]))
            by_path = _read(str(_rank_file(d, rank)), True)
            view = _local_view(target) if mesh is not None else target
            return _prepare(by_path, target, view)
        return _prepare(_assemble(d, index, True), target)

    def restore(self, state_like, step: Optional[int] = None,
                fallback: bool = True):
        """Restore into ``state_like`` (in place; see :func:`load`) and
        return it, or None when the directory holds no checkpoint. Under a
        mesh the ranks agree on the step: the newest that every rank
        verified."""
        self.wait()          # the writer's agreements share the group
        mesh = _mesh_of(state_like)
        group = _side_group(mesh)
        if step is not None:
            candidates, strict = [step], True
        else:
            start = _min(group, -1 if (s := self.latest_step()) is None
                         else s)
            if start < 0:
                return None
            strict = not fallback
            candidates = ([start] if strict else
                          [s for s in reversed(self.all_steps())
                           if s <= start])
        errors = []
        for s in candidates:
            t0 = time.monotonic()
            ok, err = True, None
            try:
                with _span("ckpt.restore", step=s):
                    out, writes = self._prepare_step(s, state_like)
            except (CheckpointCorruptError, OSError, KeyError,
                    ValueError) as e:
                ok, err = False, e
                errors.append(f"step {s}: {type(e).__name__}: {e}")
            if _min(group, int(ok)):
                _commit(writes)
                _CKPT_RESTORES.inc()
                _CKPT_RESTORE_S.observe(time.monotonic() - t0)
                self.last_restored_step = s
                if errors:
                    import warnings
                    warnings.warn(
                        f"CheckpointManager: fell back to step {s} — newer "
                        f"checkpoint(s) failed verification: {errors}")
                return out
            if strict:
                raise err if err is not None else CheckpointCorruptError(
                    f"step {s} of {self.dir} failed verification on "
                    f"another rank")
            if err is None:
                errors.append(f"step {s}: failed on another rank")
        raise CheckpointCorruptError(
            f"no loadable checkpoint in {self.dir} (tried "
            f"{candidates}); failures: {errors}")

    def _gc(self):
        """Keep the newest ``max_to_keep`` — never the one ``latest``
        points at, which is always the newest."""
        if self.use_orbax:
            for s in self.all_steps()[:-self.max_to_keep or None]:
                shutil.rmtree(self._shard_dir(s), ignore_errors=True)
            return
        ckpts = sorted(self.dir.glob("ckpt_*.npz"))
        while len(ckpts) > self.max_to_keep:
            ckpts.pop(0).unlink()


def save_state_dict(module, path):
    """The module's ``state_dict()`` alone (the global arrays of a sharded
    module, written by its mesh's first rank)."""
    save(module, path)


def load_state_dict(module, path):
    load(path, target=module)
    return module
