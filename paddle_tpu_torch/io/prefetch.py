"""Host->device prefetch — counterpart of ``paddle_tpu/io/prefetch.py``
(ref ``tf.data`` prefetch-to-device / flax ``prefetch_to_device``).

A background thread pulls batches from the iterator and lands them on
the device ``depth`` batches ahead of the consumer. On the card each
array leaf is copied into a pinned host buffer, then ``.to(device,
non_blocking=True)`` on a side CUDA stream, and an event is recorded
after the batch's copies. The consumer's stream waits on that event
before it reads the batch (no host sync), and each landed tensor calls
``record_stream`` on the consumer's stream, so the caching allocator
cannot reuse its memory while the consumer's work is still queued. On
the CPU the leaves become CPU tensors.

Contract (kept from the reference):
  * ORDER preserved — one producer, a FIFO queue.
  * EXCEPTIONS propagate — an error of the iterator (or of a copy) is
    re-raised in the consumer at its ``next()``, after every batch
    produced before it; the iterator is terminal after that.
  * CLEAN shutdown — :meth:`DevicePrefetch.close` unblocks and joins the
    producer (a daemon thread named ``pt-prefetch-*``); exhaustion joins
    it too.

Telemetry: ``io_prefetch_queue_depth`` (batches parked, sampled at each
get) and ``io_prefetch_stall_seconds`` (host time blocked waiting for the
next batch — the host-boundedness the pipeline could not hide).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.device import resolve_device
from paddle_tpu_torch.observability import METRICS

__all__ = ["DevicePrefetch", "prefetch_to_device"]

_QUEUE_DEPTH = METRICS.gauge(
    "io_prefetch_queue_depth", "device-resident batches waiting in the "
    "prefetch queue (sampled at each consumer get)")
_STALL_S = METRICS.histogram(
    "io_prefetch_stall_seconds", "host time blocked in next() waiting for "
    "the prefetch queue — residual host-boundedness")

_END = object()          # producer -> consumer: iterator exhausted (or died)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class DevicePrefetch:
    """The iterator :func:`prefetch_to_device` returns; also a context
    manager that closes the producer on exit."""

    def __init__(self, iterator: Iterable, depth: int, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = resolve_device(device)
        self._it = iter(iterator)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._thread = threading.Thread(
            target=self._produce, name=f"pt-prefetch-{id(self):x}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _leaf(self, x):
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if t.device == self.device:
            return t
        if self._stream is not None and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _land(self, batch):
        """(landed batch, event after its copies or None)."""
        if self._stream is None:
            return _map(self._leaf, batch), None
        with torch.cuda.stream(self._stream):
            landed = _map(self._leaf, batch)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return landed, ev

    def _put(self, item) -> bool:
        """Bounded put that gives up once the consumer closed us."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for batch in self._it:
                if not self._put(self._land(batch)):
                    return               # closed mid-stream: just stop
                if self._closed.is_set():
                    return
        except BaseException as e:       # re-raised consumer-side, in order
            self._exc = e
        self._put(_END)

    # ------------------------------------------------------------ consumer
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.monotonic()
        item = self._q.get()
        _STALL_S.observe(time.monotonic() - t0)
        _QUEUE_DEPTH.set(self._q.qsize())
        if item is _END:
            self._finished = True
            self._thread.join()
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        batch, ev = item
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in _leaves(batch):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(cur)
        return batch

    def close(self, timeout: float = 5.0):
        """Stop the producer and join it. Idempotent; safe at any point
        (batches in the queue are discarded)."""
        self._closed.set()
        self._finished = True
        while True:                      # unblock a producer stuck in put
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)
        _QUEUE_DEPTH.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            if not self._finished:
                self.close(timeout=0.5)
        except Exception:
            pass


def prefetch_to_device(iterator: Iterable, depth: int = 2,
                       device=None) -> DevicePrefetch:
    """Wrap ``iterator`` so its batches land on ``device`` (the card when
    None) ``depth`` ahead of consumption, from a background thread. An
    iterator and a context manager; close it (or exhaust it) to reap the
    producer thread."""
    return DevicePrefetch(iterator, depth, device)
