"""The port's data path (``paddle_tpu_torch.io``) against the reference's
spec (``tests/test_io.py``, the io cases of
``tests/test_io_dist_gapfill.py``, the prefetch cases of
``tests/test_host_overlap.py``) and against ``paddle_tpu.io`` on the same
datasets: batches are compared exactly (integer and float32 data that
neither side transforms).

The token-bin reader: with one worker thread the C++ loader's batches
are a pure function of (file, seed, batch, seq), and the port's reader
(its own g++ build of ``native/fastloader.cpp``) yields the reference's
batches exactly. With more workers the threads draw rows from a shared
generator in a schedule-dependent order, so only the windows' shape and
provenance are checked.
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
from paddle_tpu_torch.io import (BatchSampler, ConcatDataset, DataLoader,
                                 Dataset, DistributedBatchSampler,
                                 IterableDataset, Subset,
                                 SubsetRandomSampler, TensorDataset,
                                 TokenBinDataset, WeightedRandomSampler,
                                 get_worker_info, prefetch_to_device,
                                 random_split)
from paddle_tpu_torch.io import sampler as tsampler
from paddle_tpu_torch.io import token_bin
from paddle_tpu_torch.observability import METRICS


@pytest.fixture(autouse=True)
def _port_hygiene():
    METRICS.reset()
    yield
    METRICS.reset()


class _Square(Dataset):
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return np.asarray([i, i * i])


class _SquareDataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i * i], np.int64)


class _FailingDataset(_SquareDataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return super().__getitem__(i)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- datasets

@pytest.mark.parametrize("kw", [dict(batch_size=4),
                                dict(batch_size=4, drop_last=True),
                                dict(batch_size=3, shuffle=True, seed=7),
                                dict(batch_size=4, num_workers=3),
                                dict(batch_size=4, shuffle=True, seed=7,
                                     num_workers=2)],
                         ids=["plain", "drop_last", "shuffle", "workers",
                              "shuffle_workers"])
def test_loader_batches_equal_reference(kw):
    xs = np.arange(46).reshape(23, 2)
    ys = np.arange(23)
    got = list(DataLoader(TensorDataset(xs, ys), **kw))
    want = list(jio.DataLoader(jio.TensorDataset(xs, ys), **kw))
    _same(got, want)


def test_tensor_dataset_takes_tensors_and_lengths():
    xs = np.arange(20).reshape(10, 2)
    dl = DataLoader(TensorDataset(torch.as_tensor(xs), np.arange(10)),
                    batch_size=4)
    batches = list(dl)
    assert len(batches) == 3 and len(dl) == 3
    assert isinstance(batches[0][0], np.ndarray)
    np.testing.assert_array_equal(batches[0][0], xs[:4])
    assert batches[-1][0].shape == (2, 2)


def test_random_split_and_subset_equal_reference():
    parts = random_split(_Square(), [7, 3])
    jparts = jio.random_split(_Square(), [7, 3])
    for p, jp in zip(parts, jparts):
        assert p.indices == jp.indices
    firsts = sorted(int(parts[0][i][0]) for i in range(7)) + \
        sorted(int(parts[1][i][0]) for i in range(3))
    assert sorted(firsts) == list(range(10))
    assert Subset(_Square(), [3, 1])[1].tolist() == [1, 1]


def test_concat_dataset_and_out_of_range():
    cd = ConcatDataset([TensorDataset(np.arange(3.0)),
                        TensorDataset(np.arange(5.0) + 10)])
    assert len(cd) == 8
    assert float(cd[2][0]) == 2.0 and float(cd[3][0]) == 10.0
    assert float(cd[-1][0]) == 14.0
    with pytest.raises(IndexError):
        cd[8]
    with pytest.raises(IndexError):
        cd[-9]


def test_weighted_and_subset_random_samplers_equal_reference():
    s = WeightedRandomSampler([0.0, 0.0, 1.0, 1.0], 100, seed=0)
    idx = list(s)
    assert len(idx) == 100 and set(idx) <= {2, 3}
    assert idx == list(jio.WeightedRandomSampler([0.0, 0.0, 1.0, 1.0], 100,
                                                 seed=0))
    assert list(SubsetRandomSampler([5, 7, 9], seed=0)) == \
        list(jio.SubsetRandomSampler([5, 7, 9], seed=0))


def test_distributed_batch_sampler_partitions_like_reference():
    ds = _Square()
    seen = []
    for rank in range(2):
        s = DistributedBatchSampler(ds, batch_size=2, num_replicas=2,
                                    rank=rank, shuffle=True, seed=3)
        js = jio.DistributedBatchSampler(ds, batch_size=2, num_replicas=2,
                                         rank=rank, shuffle=True, seed=3)
        got = list(s)
        assert got == list(js) and len(s) == len(js)
        seen += [i for b in got for i in b]
    assert sorted(seen) == list(range(10))


def test_rank_detection_reads_the_launch_contract(monkeypatch):
    """No torch.distributed group: PROCESS_ID / NUM_PROCESSES, else (0, 1)
    — for the sampler and the token-bin shard alike."""
    monkeypatch.delenv("PROCESS_ID", raising=False)
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert tsampler.rank_and_world() == (0, 1)
    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    assert tsampler.rank_and_world() == (1, 2)
    s = DistributedBatchSampler(_Square(), batch_size=5)
    assert (s.rank, s.num_replicas) == (1, 2)
    assert [i for b in s for i in b] == list(range(1, 10, 2))


# ------------------------------------------------------------ workers

def test_mp_worker_error_propagates():
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(DataLoader(_FailingDataset(8), batch_size=2, num_workers=2))


def test_get_worker_info_and_worker_seeds():
    assert get_worker_info() is None

    class _InfoDataset(_SquareDataset):
        def __getitem__(self, i):
            info = get_worker_info()
            assert info is not None and 0 <= info.id < info.num_workers
            return np.asarray([info.num_workers, info.seed], np.int64)

    out = list(DataLoader(_InfoDataset(6), batch_size=2, num_workers=2,
                          seed=1234))
    assert all(int(b[0, 0]) == 2 for b in out)
    assert {int(b[0, 1]) for b in out} <= {1234, 1235}


def test_threaded_iterable_loader_and_error_propagates():
    class _Count(IterableDataset):
        def __iter__(self):
            yield from (np.asarray([i]) for i in range(5))

    got = list(DataLoader(_Count(), batch_size=2, num_workers=1))
    assert [b[:, 0].tolist() for b in got] == [[0, 1], [2, 3], [4]]

    class _Boom(IterableDataset):
        def __iter__(self):
            yield np.zeros(1)
            raise ValueError("iterable boom")

    with pytest.raises(ValueError, match="iterable boom"):
        list(DataLoader(_Boom(), batch_size=1, num_workers=1))


# ----------------------------------------------------------- token bin

def _token_file(tmp_path, n=100_000, seed=0):
    tokens = np.random.RandomState(seed).randint(0, 5000, n).astype(np.uint16)
    path = tmp_path / "toks.bin"
    tokens.tofile(path)
    return path, tokens


def test_token_bin_equals_reference_batches(tmp_path):
    path, _ = _token_file(tmp_path)
    kw = dict(batch_size=4, seq_len=64, seed=3, num_batches=6, num_workers=1,
              shard=(1, 2))
    got = list(TokenBinDataset(str(path), **kw))
    want = list(jio.TokenBinDataset(str(path), **kw))
    _same(got, want)
    assert token_bin.library_path().parent.name == "_build"
    assert token_bin.library_path().exists()


def test_token_bin_windows_come_from_the_file(tmp_path):
    path, tokens = _token_file(tmp_path)
    ds = TokenBinDataset(str(path), batch_size=4, seq_len=64, seed=3,
                         num_batches=5)
    assert ds.num_tokens == 100_000
    batches = list(ds)
    assert len(batches) == 5
    joined = tokens.astype(np.int32)
    for x, y in batches:
        assert x.shape == (4, 64) and y.shape == (4, 64)
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
        for row in x:
            pos = np.where(joined == row[0])[0]
            assert any((joined[p:p + 64] == row).all() for p in pos
                       if p + 64 <= len(joined))
    with pytest.raises(ValueError, match="bad shard"):
        TokenBinDataset(str(path), 4, 64, shard=(2, 2))


# ------------------------------------------------------------- prefetch

def test_prefetch_preserves_order_and_lands_on_device():
    batches = [np.full((2, 2), i, np.float32) for i in range(10)]
    out = list(prefetch_to_device(iter(batches), depth=3, device="cpu"))
    assert len(out) == 10
    for i, b in enumerate(out):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), batches[i])


def test_prefetch_handles_pytree_batches():
    def gen():
        for i in range(4):
            yield {"x": np.ones((2,), np.float32) * i,
                   "y": (np.zeros((1,), np.int32) + i, i)}
    out = list(prefetch_to_device(gen(), depth=2, device="cpu"))
    assert len(out) == 4
    assert isinstance(out[3]["x"], torch.Tensor)
    assert float(out[3]["x"][0]) == 3.0
    assert int(out[2]["y"][0][0]) == 2
    assert int(out[2]["y"][1]) == 2


def test_prefetch_propagates_iterator_exception_in_order():
    def bad_gen():
        yield np.ones((2,), np.float32)
        yield np.ones((2,), np.float32) * 2
        raise ValueError("source died")

    p = prefetch_to_device(bad_gen(), depth=4, device="cpu")
    assert float(next(p)[0]) == 1.0
    assert float(next(p)[0]) == 2.0
    with pytest.raises(ValueError, match="source died"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def test_prefetch_close_unblocks_full_queue_producer():
    produced = []

    def slow_to_drain():
        for i in range(1000):
            produced.append(i)
            yield np.full((1,), i, np.float32)

    p = prefetch_to_device(slow_to_drain(), depth=2, device="cpu")
    assert float(next(p)[0]) == 0.0
    time.sleep(0.1)
    p.close()
    assert not p._thread.is_alive()
    assert len(produced) < 1000
    with pytest.raises(StopIteration):
        next(p)
    p.close()


def test_prefetch_context_manager_and_depth_validation():
    with pytest.raises(ValueError, match="depth"):
        prefetch_to_device(iter([]), depth=0, device="cpu")
    with prefetch_to_device(iter([np.ones(2)] * 50), depth=2,
                            device="cpu") as p:
        next(p)
    assert not p._thread.is_alive()


def test_prefetch_queue_depth_and_stall_metrics():
    list(prefetch_to_device(iter([np.ones(2)] * 5), depth=2, device="cpu"))
    snap = METRICS.snapshot()
    assert snap["gauges"]["io_prefetch_queue_depth"] == 0
    assert snap["histograms"]["io_prefetch_stall_seconds"]["count"] == 6


def test_dataloader_prefetch_wires_through():
    xs = np.arange(32, dtype=np.float32).reshape(16, 2)
    ys = np.arange(16, dtype=np.int64)
    dl = DataLoader(TensorDataset(xs, ys), batch_size=4)
    got = list(dl.prefetch(depth=2, device="cpu"))
    assert len(got) == 4
    assert isinstance(got[0][0], torch.Tensor)
    np.testing.assert_array_equal(got[0][0].numpy(), xs[:4])
    np.testing.assert_array_equal(got[3][1].numpy(), ys[12:])
    assert BatchSampler(list(range(5)), batch_size=2).__len__() == 3
