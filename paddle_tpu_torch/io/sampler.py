"""Samplers — a copy of ``paddle_tpu/io/sampler.py`` (ref
``python/paddle/io/dataloader/sampler.py`` + ``batch_sampler.py`` incl.
DistributedBatchSampler), with the rank read from ``torch.distributed``
(:func:`rank_and_world`)."""
from __future__ import annotations

import os

import numpy as np


def rank_and_world() -> tuple:
    """(rank, world) of this process: ``torch.distributed`` when it is
    initialised, else the launch contract's ``PROCESS_ID`` /
    ``NUM_PROCESSES``, else (0, 1). Never initialises anything."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("PROCESS_ID", "-1"))
    world = int(os.environ.get("NUM_PROCESSES", "-1"))
    if world > 0 and 0 <= rank < world:
        return rank, world
    return 0, 1


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, seed=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(
            None if self.seed is None else self.seed + self.epoch)
        n = len(self.data_source)
        if self.replacement:
            yield from rng.randint(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()
        self.epoch += 1

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False, seed=None):
        self.sampler = sampler or (
            RandomSampler(dataset, seed=seed) if shuffle else SequenceSampler(dataset))
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-host shard of the global batch (ref DistributedBatchSampler).
    Each PROCESS feeds its own device; global batch = world batches."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False, seed=0):
        auto_rank, auto_world = rank_and_world()
        self.num_replicas = (num_replicas if num_replicas is not None
                             else auto_world)
        self.rank = rank if rank is not None else auto_rank
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        # pad to a multiple of replicas so every rank sees equal batches
        total = ((n + self.num_replicas - 1) // self.num_replicas) * self.num_replicas
        order = np.concatenate([order, order[: total - n]])
        local = order[self.rank::self.num_replicas]
        batch = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        local = (len(self.dataset) + self.num_replicas - 1) // self.num_replicas
        if self.drop_last:
            return local // self.batch_size
        return (local + self.batch_size - 1) // self.batch_size


class WeightedRandomSampler(Sampler):
    """Ref sampler.py:WeightedRandomSampler — sample indices with given
    per-index weights."""

    def __init__(self, weights, num_samples, replacement=True, seed=None):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(
            None if self.seed is None else self.seed + self.epoch)
        p = self.weights / self.weights.sum()
        idx = rng.choice(len(self.weights), self.num_samples,
                         replace=self.replacement, p=p)
        self.epoch += 1
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Ref sampler.py:SubsetRandomSampler — permutation over given indices."""

    def __init__(self, indices, seed=None):
        self.indices = list(indices)
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.RandomState(
            None if self.seed is None else self.seed + self.epoch)
        self.epoch += 1
        for i in rng.permutation(len(self.indices)):
            yield self.indices[i]

    def __len__(self):
        return len(self.indices)
