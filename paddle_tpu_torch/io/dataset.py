"""Datasets — a copy of ``paddle_tpu/io/dataset.py`` (ref
``python/paddle/io/dataloader/dataset.py``). Samples are numpy arrays:
the loader's workers stay on the host, and the trainer or
:func:`paddle_tpu_torch.io.prefetch_to_device` moves batches to the
device."""
from __future__ import annotations

from typing import Sequence

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise TypeError("IterableDataset has no __len__")


def _host(x):
    """A sample as numpy (a CPU tensor's numpy view, a card tensor copied)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TensorDataset(Dataset):
    def __init__(self, *tensors):
        assert all(len(t) == len(tensors[0]) for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(_host(t[idx]) for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, seed=0):
    assert sum(lengths) == len(dataset)
    perm = np.random.RandomState(seed).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        return tuple(d[idx] for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Ref dataset.py:ConcatDataset — end-to-end concatenation."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1] if self.cumulative_sizes else 0

    def __getitem__(self, idx):
        n = len(self)
        if idx < 0:
            idx += n
        if not 0 <= idx < n:
            raise IndexError(f"index {idx} out of range for length {n}")
        import bisect
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[di - 1] if di else 0
        return self.datasets[di][idx - prev]
