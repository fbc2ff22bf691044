"""Build and load the hand-written CUDA kernels in ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library with a plain C interface, and loaded with :mod:`ctypes` — no
PyTorch headers, so a build takes seconds. Libraries land in
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one is reused. :func:`build` starts one ``nvcc`` per source,
all at once.

Nothing here runs at import: the CPU tests import every module and have
no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNEL_SOURCES = ("rms_norm", "flash_fwd", "flash_bwd", "paged_chunk",
                  "paged_decode", "grouped_matmul", "grouped_lora", "rope")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "are built with the CUDA toolkit at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    """The ``nvcc -Xptxas -v`` output (registers, spills) of the build."""
    return library_path(name).with_suffix(".log")


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every listed source that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns
    {name: compiler log}. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        log_path(name).write_text(text)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{text}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: log_path(name).read_text() for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                lib.ptt_error_string.restype = ctypes.c_char_p
                lib.ptt_error_string.argtypes = [ctypes.c_int]
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str):
    """Turn a C entry point's ``cudaGetLastError()`` code into an error."""
    if rc != 0:
        msg = lib.ptt_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def f16_counter() -> SimpleNamespace:
    """The float16 launches of one wrapper, counted beside its total
    (``<wrapper>.f16.launches``; ``ops.cuda.kernels()`` names it
    ``<name>_f16``)."""
    return SimpleNamespace(launches=0)


def count(fn, t: torch.Tensor):
    """One launch of ``fn``'s kernel on inputs of ``t``'s dtype: its
    total and, for float16, its float16 count."""
    fn.launches += 1
    if t.dtype == torch.float16:
        fn.f16.launches += 1


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: the CUDA kernel takes float32, bfloat16 "
                        f"or float16, got {t.dtype}") from None
