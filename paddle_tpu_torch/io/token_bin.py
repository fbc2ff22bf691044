"""Native token-bin reader — counterpart of ``paddle_tpu/io/token_bin.py``:
a ctypes binding over the repository's C++ mmap + prefetch-ring loader,
``native/fastloader.cpp``. Yields (input_ids, labels) int32 numpy
batches.

The port compiles that source itself, at first use, with ``g++ -O3
-std=c++17 -fPIC -pthread -shared`` into ``paddle_tpu_torch/_build/``
(untracked, keyed by a hash of the source and the flags). It never runs
``make -C native``, which would rewrite the tracked
``native/libfastloader.so``.

Determinism: with ``num_workers=1`` the batches are a pure function of
(file, seed, batch, seq) — the reference's reader gives the same ones. With
more workers the C++ threads draw their rows from one shared generator
under a lock in whatever order they reach it, so rows and batches come in
a schedule-dependent order.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from paddle_tpu_torch.io.dataset import IterableDataset
from paddle_tpu_torch.io.sampler import rank_and_world

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "fastloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/fastloader.cpp`` into ``_build/`` unless an
    up-to-date library is there; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.fl_open.restype = ctypes.c_void_p
        lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_int]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.fl_num_tokens.restype = ctypes.c_uint64
        lib.fl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.fl_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


class TokenBinDataset(IterableDataset):
    """Streams random (seq+1)-token windows from a binary token file:
    flat little-endian uint16 (default) or uint32 ids, the nanoGPT /
    Megatron ``.bin`` layout."""

    def __init__(self, path: str, batch_size: int, seq_len: int, seed: int = 0,
                 token_width: int = 2, num_workers: int = 2, prefetch: int = 8,
                 num_batches: int | None = None,
                 shard: tuple[int, int] | None = None):
        """``shard=(rank, world)`` de-correlates the window stream across
        processes (each draws from a distinct seeded stream); None reads
        it as :func:`paddle_tpu_torch.io.sampler.rank_and_world` does."""
        rank, world = shard if shard is not None else rank_and_world()
        if not (0 <= rank < world):
            raise ValueError(f"bad shard {(rank, world)}")
        self.shard = (rank, world)
        self.path = os.fspath(path)
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed * world + rank  # distinct stream per process
        self.token_width = token_width
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.num_batches = num_batches
        self._lib = _load_lib()

    def _open(self):
        h = self._lib.fl_open(self.path.encode(), self.token_width,
                              self.batch_size, self.seq_len, self.seed,
                              self.num_workers, self.prefetch)
        if not h:
            raise OSError(f"fastloader: cannot open {self.path}")
        return h

    @property
    def num_tokens(self) -> int:
        h = self._open()
        try:
            return int(self._lib.fl_num_tokens(h))
        finally:
            self._lib.fl_close(h)

    def __iter__(self):
        h = self._open()
        buf = np.empty((self.batch_size, self.seq_len + 1), dtype=np.int32)
        try:
            produced = 0
            while self.num_batches is None or produced < self.num_batches:
                rc = self._lib.fl_next(h, buf.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32)))
                if rc != 0:
                    break
                yield buf[:, :-1].copy(), buf[:, 1:].copy()
                produced += 1
        finally:
            self._lib.fl_close(h)
