"""``paddle_tpu_torch.io`` against ``paddle_tpu.io``: datasets, samplers,
the collate function and the DataLoader's order.

Everything here is exact: the samplers draw from numpy's global RNG as
the JAX package's do, so under one ``np.random.seed`` both packages give
the same batches, element for element, with 0 or 2 worker processes
(the port's) against the JAX package's in-process loader. Worker tests
use ``fork`` (CUDA is not initialised here) and a ``timeout`` of their
own on the loader, so a hung worker fails the test instead of the
suite."""
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io
from paddle_tpu_torch.io import worker

torch.set_num_threads(1)

LOADER_TIMEOUT = 60  # seconds a worker batch may take before the loader fails


class Squares(io.Dataset):
    """Sample i: (a float32 row of 1,500 values, so a batch crosses the
    shared-memory threshold, the int i, a dict)."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        return (np.full(1500, i, np.float32) + np.arange(1500,
                                                         dtype=np.float32),
                i, {"sq": float(i * i)})


class JSquares(jio.Dataset):
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return Squares()[i]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "_data", x))


def _flat(batch):
    if isinstance(batch, dict):
        return [_np(batch[k]) for k in sorted(batch)]
    if isinstance(batch, (tuple, list)):
        return [a for b in batch for a in _flat(b)]
    return [_np(batch)]


def _epoch(loader, seed):
    np.random.seed(seed)
    return [_flat(b) for b in loader]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype or (a.dtype, b.dtype) == (
                np.int64, np.int32)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax(num_workers, drop_last):
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last)
    loader = io.DataLoader(Squares(), num_workers=num_workers,
                           timeout=LOADER_TIMEOUT, device="cpu", **kw)
    jloader = jio.DataLoader(JSquares(), **kw)
    for seed in (3, 4):
        got, want = _epoch(loader, seed), _epoch(jloader, seed)
        _assert_same(got, want)
    assert len(loader) == len(jloader) == (5 if drop_last else 6)
    assert all(isinstance(t, torch.Tensor) for t in next(iter(loader))[:2])


def test_persistent_workers_survive_an_abandoned_epoch():
    """Persistent workers: an epoch left after one batch, then two full
    epochs in the JAX package's order (the stale batches are dropped)."""
    loader = io.DataLoader(Squares(), batch_size=3, shuffle=True,
                           num_workers=2, persistent_workers=True,
                           timeout=LOADER_TIMEOUT, device="cpu")
    jloader = jio.DataLoader(JSquares(), batch_size=3, shuffle=True)
    try:
        np.random.seed(0)
        next(iter(loader))
        procs = loader._persistent_iter.procs
        for seed in (1, 2):
            _assert_same(_epoch(loader, seed), _epoch(jloader, seed))
        assert loader._persistent_iter.procs is procs
    finally:
        loader.close()
    assert all(not p.is_alive() for p in procs)


class Shards(io.IterableDataset):
    """0..19, each worker taking every num_workers-th value from its id."""

    def __iter__(self):
        info = io.get_worker_info()
        wid, n = (0, 1) if info is None else (info.id, info.num_workers)
        return iter(range(wid, 20, n))


def test_iterable_sharding_by_worker():
    loader = io.DataLoader(Shards(), batch_size=3, num_workers=2,
                           timeout=LOADER_TIMEOUT, device="cpu")
    batches = [b.tolist() for b in loader]
    assert sorted(v for b in batches for v in b) == list(range(20))
    # each worker batches its own shard: 10 values in 3 + 3 + 3 + 1
    assert sorted(len(b) for b in batches) == [1, 1, 3, 3, 3, 3, 3, 3]
    single = [b.tolist() for b in io.DataLoader(Shards(), batch_size=3,
                                                drop_last=True,
                                                device="cpu")]
    assert single == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11],
                      [12, 13, 14], [15, 16, 17]]


class Broken(io.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("sample 5 is broken")
        return np.zeros(3, np.float32)


def test_worker_error_reaches_the_caller():
    loader = io.DataLoader(Broken(), batch_size=2, num_workers=2,
                           timeout=LOADER_TIMEOUT, device="cpu")
    with pytest.raises(RuntimeError, match="sample 5 is broken"):
        list(loader)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_ranks_match_jax(shuffle, drop_last):
    data = list(range(23))
    for rank in range(3):
        s = io.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                       shuffle=shuffle, drop_last=drop_last)
        js = jio.DistributedBatchSampler(data, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=drop_last)
        for epoch in range(2):
            assert list(s) == list(js)
        assert len(s) == len(js)
    s.set_epoch(7)
    js.set_epoch(7)
    assert list(s) == list(js)


def test_samplers_and_random_split_match_jax():
    data = list(range(17))
    for seed in (0, 1):
        np.random.seed(seed)
        got = [list(io.RandomSampler(data)),
               list(io.RandomSampler(data, replacement=True,
                                     num_samples=9)),
               list(io.WeightedRandomSampler(np.arange(1.0, 18.0), 12)),
               [s.indices for s in io.random_split(data, [10, 7])]]
        np.random.seed(seed)
        want = [list(jio.RandomSampler(data)),
                list(jio.RandomSampler(data, replacement=True,
                                       num_samples=9)),
                list(jio.WeightedRandomSampler(np.arange(1.0, 18.0), 12)),
                [s.indices for s in jio.random_split(data, [10, 7])]]
        assert got == want
    assert list(io.SequenceSampler(data)) == list(range(17))
    bs = io.BatchSampler(data, batch_size=5, drop_last=True)
    assert list(bs) == list(jio.BatchSampler(data, batch_size=5,
                                             drop_last=True))
    assert len(bs) == 3


def test_datasets_and_collate_match_jax():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6)
    ds = io.TensorDataset([torch.from_numpy(a), b])
    jds = jio.TensorDataset([a, b])
    assert len(ds) == 6 and all(np.array_equal(x, y) for x, y in
                                zip(ds[4], jds[4]))
    cat = io.ConcatDataset([ds, io.Subset(ds, [5, 0])])
    assert len(cat) == 8 and cat[7][1] == 0
    comp = io.ComposeDataset([ds, io.TensorDataset([b * 10])])
    assert [int(v) for v in comp[2][1:]] == [2, 20]
    assert list(iter(io.ChainDataset([range(2), range(3)]))) == [0, 1, 0, 1,
                                                                2]
    samples = [(np.ones(2, np.float32) * i, i, 0.5 * i, {"k": i})
               for i in range(3)]
    got, want = io.default_collate_fn(samples), jio.default_collate_fn(
        samples)
    _assert_same([_flat(got)], [_flat(want)])
    t = io.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(t, torch.Tensor) and t.shape == (2, 2)


def test_shared_memory_transport_accounts_and_unlinks():
    arr = np.arange(4096, dtype=np.float32)
    small = worker._pack(np.arange(3), True)
    assert small[1][0] == "raw"
    packed = worker._pack((arr, {"x": arr * 2}), True)
    assert packed[1][0][1][0] == "shm"
    name = packed[1][0][1][1]
    peak = worker.shm_stats["peak"]
    out = worker._unpack(packed)
    np.testing.assert_array_equal(out[0], arr)
    np.testing.assert_array_equal(out[1]["x"], arr * 2)
    assert worker.shm_stats["current"] == 0
    assert worker.shm_stats["peak"] >= max(peak, arr.nbytes)
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    stale = worker._pack([arr], True)
    worker.discard(stale)
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=stale[1][0][1][1])


def test_start_method_and_device(monkeypatch):
    """fork until CUDA is initialised, then spawn; the environment
    overrides; the default device is CUDA and raises without it."""
    monkeypatch.delenv("PADDLE_TPU_LOADER_START_METHOD", raising=False)
    assert io._start_method() == "fork"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert io._start_method() == "spawn"
    monkeypatch.setenv("PADDLE_TPU_LOADER_START_METHOD", "forkserver")
    assert io._start_method() == "forkserver"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            io.DataLoader(Squares())
    with pytest.raises(ValueError, match="persistent_workers"):
        io.DataLoader(Squares(), persistent_workers=True, device="cpu")


def test_shuffle_plan_is_drawn_on_the_calling_thread():
    """With the buffered reader the epoch's permutation is drawn before
    ``iter`` returns: the global RNG has moved once, whatever the reader
    thread does."""
    loader = io.DataLoader(Squares(), batch_size=4, shuffle=True,
                           device="cpu")
    np.random.seed(11)
    it = iter(loader)
    after = np.random.get_state()[1].copy()
    np.random.seed(11)
    np.random.permutation(23)
    assert np.array_equal(after, np.random.get_state()[1])
    assert len(list(it)) == 6
