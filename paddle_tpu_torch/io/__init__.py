"""``paddle.io``: datasets, samplers and the DataLoader (counterpart of
``paddle_tpu/io/__init__.py``).

Host-side numpy batching as in the JAX package: the samplers draw from
numpy's global RNG exactly as the JAX package's do, so one
``np.random.seed`` gives both packages the same order, and the DataLoader
draws its epoch's shuffle plan on the calling thread before any worker or
reader thread runs. ``num_workers > 0`` decodes and collates in worker
processes (:mod:`.worker`, shared-memory transport); ``use_buffer_reader``
(on by default) keeps ``prefetch_factor`` batches ready on a producer
thread. Batches reach the loader's device (``device``, ``"cuda"`` by
default; ``places`` is paddle's name for it) as torch tensors: on a CUDA
device through pinned host memory and non-blocking copies on the current
stream, on the CPU as ``torch.from_numpy`` views.

Worker start method: ``fork`` while ``torch.cuda.is_initialized()`` is
false, ``spawn`` once it is true (CUDA cannot be forked);
``PADDLE_TPU_LOADER_START_METHOD`` overrides it, as in the JAX package.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import List

import numpy as np
import torch

from ..core import device as device_mod
from . import worker as worker_mod

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Subset",
           "ConcatDataset", "ChainDataset", "ComposeDataset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "default_collate_fn", "DataLoader", "get_worker_info"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


def _numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class TensorDataset(Dataset):
    """Sample i is the tuple of every array's row i (torch tensors are kept
    as numpy arrays)."""

    def __init__(self, tensors: List):
        self.tensors = [_numpy(t) for t in tensors]

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._lens = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx):
        for d, n in zip(self.datasets, self._lens):
            if idx < n:
                return d[idx]
            idx -= n
        raise IndexError(idx)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ComposeDataset(Dataset):
    """Zips datasets sample-wise; their fields are concatenated."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets[1:]):
            raise ValueError("ComposeDataset requires equal lengths")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (tuple, list)) else [s])
        return tuple(out)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if sum(lengths) != total:
        raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

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
    """Shards the indices across data-parallel ranks: rank r takes every
    ``num_replicas``-th index from r, the list padded at its end from its
    start. ``num_replicas`` and ``rank`` default to the initialised
    ``torch.distributed`` group's, else 1 and 0; no group is needed when
    they are given. ``shuffle`` draws the epoch's permutation from
    ``RandomState(epoch)``, the same on every rank."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        dist = torch.distributed
        live = dist.is_available() and dist.is_initialized()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else dist.get_world_size() if live else 1)
        self.local_rank = (rank if rank is not None
                           else dist.get_rank() if live else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[:self.total_size - len(indices)]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stacks samples field by field: numpy arrays into one array, torch
    tensors into one tensor, ints into int64, floats into float32."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    return np.asarray(batch)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False,
                 device=device_mod.DEFAULT_DEVICE):
        self.device = device_mod.resolve(places if places is not None
                                         else device)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_buffer_reader = bool(use_buffer_reader)
        self.prefetch_factor = max(prefetch_factor, 1)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        if persistent_workers and num_workers == 0:
            raise ValueError("persistent_workers requires num_workers > 0")
        self._persistent_iter = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _batches(self, idx_plan=None):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for idx_batch in (self.batch_sampler if idx_plan is None
                              else idx_plan):
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def _to_device(self, batch):
        """numpy leaves as torch tensors on the loader's device (pinned
        host memory and a non-blocking copy for CUDA); torch tensors
        moved there."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(b) for b in batch)
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        if not isinstance(batch, torch.Tensor):
            return batch
        if self.device.type == "cuda":
            if batch.device.type == "cpu":
                batch = batch.pin_memory()
            return batch.to(self.device, non_blocking=True)
        return batch.to(self.device)

    def __iter__(self):
        idx_plan = None
        if self.use_buffer_reader and not self._iterable_mode:
            # the shuffle plan is drawn on the calling thread: the producer
            # must not touch numpy's global RNG, or a seeded run's order
            # would depend on the reader
            idx_plan = list(self.batch_sampler)
        it = self._iter_batches(idx_plan)
        if self.use_buffer_reader:
            return _buffered_iter(it, self.prefetch_factor)
        return it

    def _iter_batches(self, idx_plan=None):
        """Not a generator: worker processes start on the calling thread,
        eagerly, never on the reader thread (forking a process that runs
        threads can deadlock)."""
        if self.num_workers == 0:
            def gen_inline():
                for b in self._batches(idx_plan):
                    yield self._to_device(b)

            return gen_inline()
        if self.persistent_workers and not self._iterable_mode:
            if self._persistent_iter is None:
                self._persistent_iter = _MultiProcessIter(self)
            it = self._persistent_iter
        else:
            it = _MultiProcessIter(self)
        it.start_epoch(idx_plan)

        def gen_workers():
            try:
                for b in it.epoch_batches():
                    yield self._to_device(b)
            finally:
                if it is not self._persistent_iter:
                    it.shutdown()

        return gen_workers()

    def close(self) -> None:
        """Stop persistent workers (also done when the loader is
        collected)."""
        if self._persistent_iter is not None:
            self._persistent_iter.shutdown()
            self._persistent_iter = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: nothing left to report to
            pass

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)


def _buffered_iter(gen, depth: int):
    """Drive ``gen`` from a producer thread through a bounded queue. The
    producer alone iterates and closes ``gen``; the consumer sees items,
    the end, or the producer's exception re-raised. When the consumer
    stops early the producer closes ``gen`` promptly."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    END, ERR, ITEM = "end", "err", "item"
    stop = threading.Event()

    def put(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            try:
                for item in gen:
                    if not put((ITEM, item)):
                        return
            finally:
                if stop.is_set():
                    gen.close()
            put((END, None))
        except BaseException as e:  # re-raised on the consumer's thread
            put((ERR, e))

    t = threading.Thread(target=produce, daemon=True,
                         name="paddle-tpu-torch-buffer-reader")
    t.start()
    try:
        while True:
            kind, val = q.get()
            if kind == END:
                return
            if kind == ERR:
                raise val
            yield val
    finally:
        stop.set()
        t.join(timeout=5.0)


def _start_method() -> str:
    """``fork`` while CUDA is not initialised in this process, ``spawn``
    once it is (a forked CUDA context is unusable);
    ``PADDLE_TPU_LOADER_START_METHOD`` overrides."""
    env = os.environ.get("PADDLE_TPU_LOADER_START_METHOD")
    if env:
        return env
    return "spawn" if torch.cuda.is_initialized() else "fork"


class _MultiProcessIter:
    """The parent side of the worker pool: feeds batch-index tasks to the
    workers (one index queue each, round robin, ``prefetch_factor`` tasks
    a worker in flight) and yields their results in sampler order through
    a reorder buffer. Results of an abandoned epoch (persistent workers
    after an early break) carry an old epoch tag and are discarded."""

    def __init__(self, loader: "DataLoader"):
        import multiprocessing as mp

        self.loader = loader
        ctx = mp.get_context(_start_method())
        self.nw = loader.num_workers
        self.iterable = loader._iterable_mode
        self.result_queue = ctx.Queue()
        self.index_queues = []
        self.procs = []
        self.alive = True
        self._epoch = -1
        base_seed = int(np.random.randint(0, 1 << 30))
        for wid in range(self.nw):
            iq = ctx.Queue() if not self.iterable else None
            self.index_queues.append(iq)
            p = ctx.Process(
                target=worker_mod.worker_loop,
                args=(loader.dataset, iq, self.result_queue,
                      loader.collate_fn, loader.use_shared_memory, wid,
                      self.nw, loader.worker_init_fn, self.iterable,
                      loader.batch_size, loader.drop_last, base_seed),
                daemon=True)
            p.start()
            self.procs.append(p)

    def start_epoch(self, idx_plan=None):
        if self.iterable:
            return  # workers stream on their own; _iterable_epoch ends it
        self._epoch += 1
        self._task_iter = enumerate(iter(
            self.loader.batch_sampler if idx_plan is None else idx_plan))
        self._sent = 0
        self._yielded = 0
        self._next_worker = 0
        self._reorder = {}
        for _ in range(self.loader.prefetch_factor * self.nw):
            self._send_task()

    def _send_task(self) -> bool:
        task = next(self._task_iter, None)
        if task is None:
            return False
        seq, indices = task
        self.index_queues[self._next_worker].put(
            (self._epoch, seq, list(indices)))
        self._next_worker = (self._next_worker + 1) % self.nw
        self._sent += 1
        return True

    def _get(self):
        """The next result, watching the workers: one that died without a
        traceback (killed) raises instead of hanging, and so does a wait
        past ``timeout`` seconds."""
        deadline = (time.monotonic() + self.loader.timeout
                    if self.loader.timeout else None)
        while True:
            try:
                return self.result_queue.get(timeout=1.0)
            except queue.Empty:
                pass
            dead = [i for i, p in enumerate(self.procs)
                    if not p.is_alive() and p.exitcode not in (0, None)]
            if dead:
                codes = [self.procs[i].exitcode for i in dead]
                self.shutdown()
                raise RuntimeError(f"DataLoader worker(s) {dead} died "
                                   f"unexpectedly (exitcodes {codes})")
            if deadline is not None and time.monotonic() > deadline:
                self.shutdown()
                raise RuntimeError(f"DataLoader timed out after "
                                   f"{self.loader.timeout}s waiting for a "
                                   "worker batch")

    def _failed(self, kind, tag, payload):
        self.shutdown()
        if kind == "error":
            raise RuntimeError(f"DataLoader worker {tag} failed:\n{payload}")
        raise RuntimeError(f"DataLoader worker {tag} exited early")

    def epoch_batches(self):
        if self.iterable:
            yield from self._iterable_epoch()
            return
        while self._yielded < self._sent:
            if self._yielded in self._reorder:
                batch = self._reorder.pop(self._yielded)
                self._yielded += 1
                yield batch
                continue
            kind, tag, payload = self._get()
            if kind in ("error", "done"):
                self._failed(kind, tag, payload)
            epoch, seq = tag
            if epoch != self._epoch:
                worker_mod.discard(payload)
                continue
            # refill on receipt, not on the in-order yield: a straggler
            # must not starve the other workers of tasks
            self._send_task()
            self._reorder[seq] = worker_mod._unpack(payload)

    def _iterable_epoch(self):
        done = 0
        while done < self.nw:
            kind, wid, payload = self._get()
            if kind == "error":
                self._failed(kind, wid, payload)
            if kind == "done":
                done += 1
                continue
            yield worker_mod._unpack(payload)
        self.alive = False

    def shutdown(self):
        if not self.alive:
            return
        self.alive = False
        for iq in self.index_queues:
            if iq is not None:
                try:
                    iq.put(None)
                except (OSError, ValueError):  # a queue already closed
                    pass
        # drain while the workers flush and exit (joining a process that
        # still writes to a queue can deadlock); every drained segment is
        # unlinked
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                kind, _, payload = self.result_queue.get(timeout=0.2)
                if kind == "batch":
                    worker_mod.discard(payload)
                continue
            except queue.Empty:
                pass
            if all(not p.is_alive() for p in self.procs):
                break
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=1)
        while True:
            try:
                kind, _, payload = self.result_queue.get(timeout=0.1)
            except (queue.Empty, OSError, ValueError):
                break
            if kind == "batch":
                worker_mod.discard(payload)

    def __del__(self):
        # workers start eagerly: an iterator made but never advanced would
        # leak them without this
        try:
            self.shutdown()
        except Exception:  # interpreter teardown: nothing left to report to
            pass


def get_worker_info():
    """The worker's info (id, num_workers, seed, dataset); None in the
    parent."""
    return worker_mod.get_worker_info()
