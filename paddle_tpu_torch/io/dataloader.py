"""DataLoader — counterpart of ``paddle_tpu/io/dataloader.py`` (ref
``python/paddle/io/dataloader/dataloader_iter.py``).

- map-style + ``num_workers>0`` -> forked worker processes pulling
  index-batches from a task queue, results reassembled IN ORDER, so the
  batches equal those of ``num_workers=0``.
- iterable datasets -> one producer thread with a bounded queue.
- token-LM training -> the native C++ reader
  (:class:`paddle_tpu_torch.io.token_bin.TokenBinDataset`).

Workers produce numpy only. A child forked from a process that holds a
CUDA context must not touch CUDA (the context does not survive ``fork``):
datasets that build tensors on the card take
``mp_start_method='spawn'``. :meth:`DataLoader.prefetch` lands batches on
the device from pinned host memory on a side stream
(:mod:`paddle_tpu_torch.io.prefetch`).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.io.dataset import Dataset, IterableDataset
from paddle_tpu_torch.io.sampler import BatchSampler

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id, num_workers, seed):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed


def get_worker_info():
    """Inside a worker: (id, num_workers, seed); None in the main process
    (ref ``paddle.io.get_worker_info``)."""
    return getattr(_worker_info, "info", None)


def _mp_worker(dataset, collate_fn, task_q, result_q, wid, num_workers, seed):
    _worker_info.info = WorkerInfo(wid, num_workers, seed)
    while True:
        task = task_q.get()
        if task is None:
            break
        seq, idxs = task
        try:
            batch = collate_fn([dataset[i] for i in idxs])
            result_q.put((seq, batch, None))
        except Exception as e:  # surface the real error in the parent
            result_q.put((seq, None, f"{type(e).__name__}: {e}"))


def default_collate_fn(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_fn([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples], axis=0)


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, prefetch_factor: int = 2,
                 batch_sampler: Optional[BatchSampler] = None, seed=None,
                 mp_start_method: str = "fork"):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.seed = seed
        self.mp_start_method = mp_start_method
        self.iterable = isinstance(dataset, IterableDataset)
        if self.iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last, seed=seed)

    def __len__(self):
        if self.iterable:
            raise TypeError("IterableDataset has no __len__")
        return len(self.batch_sampler)

    def _batches(self):
        if self.iterable:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers <= 0:
            yield from self._batches()
            return
        if self.iterable:
            yield from self._threaded_iter()
            return
        yield from self._mp_iter()

    def prefetch(self, depth: int = 2, device=None):
        """Host/device overlap: one pass of this loader through a
        background thread that lands each batch on ``device`` (the card
        when None) ``depth`` batches ahead of the consumer — see
        :func:`paddle_tpu_torch.io.prefetch.prefetch_to_device`. Close it
        (or exhaust it) to reap the producer thread."""
        from paddle_tpu_torch.io.prefetch import prefetch_to_device
        return prefetch_to_device(iter(self), depth, device)

    def _threaded_iter(self):
        q: queue.Queue = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        _END = object()
        failure = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except BaseException as e:  # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=producer, name="pt-dataloader",
                             daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]

    def _mp_iter(self):
        """Worker-process pool with in-order reassembly.

        Default start method is ``fork`` (cheap, no pickling — the
        reference loader's choice on Linux). Workers run host/numpy code
        only; a dataset that touches CUDA takes
        ``mp_start_method='spawn'``.
        """
        ctx = mp.get_context(self.mp_start_method)
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        nw = self.num_workers
        seed = self.seed or 0
        workers = [ctx.Process(target=_mp_worker,
                               args=(self.dataset, self.collate_fn, task_q,
                                     result_q, w, nw, seed + w), daemon=True)
                   for w in range(nw)]
        for w in workers:
            w.start()
        try:
            batches = iter(self.batch_sampler)
            inflight = 0
            seq_sent = 0
            for _ in range(nw * self.prefetch_factor):  # prime the pipeline
                try:
                    task_q.put((seq_sent, next(batches)))
                    seq_sent += 1
                    inflight += 1
                except StopIteration:
                    break
            pending = {}
            seq_want = 0
            while inflight:
                try:
                    seq, batch, err = result_q.get(timeout=5.0)
                except queue.Empty:
                    dead = [w for w in workers if not w.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker exited unexpectedly (exitcode "
                            f"{dead[0].exitcode}) — killed by OOM or a crash "
                            f"in dataset code")
                    continue
                inflight -= 1
                if err is not None:
                    raise RuntimeError(f"DataLoader worker failed: {err}")
                pending[seq] = batch
                try:
                    task_q.put((seq_sent, next(batches)))
                    seq_sent += 1
                    inflight += 1
                except StopIteration:
                    pass
                while seq_want in pending:  # emit in submission order
                    yield pending.pop(seq_want)
                    seq_want += 1
        finally:
            for _ in workers:
                task_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
