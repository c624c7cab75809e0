"""DataLoader worker processes and their shared-memory transport
(counterpart of ``paddle_tpu/io/worker.py``).

Workers decode and collate batches; numpy leaves of at least 4 KiB travel
through ``multiprocessing.shared_memory`` segments (the worker creates and
fills one, the parent copies it out and unlinks it), smaller ones and other
objects are pickled through the result queue. Ordering is restored in the
parent with a sequence-number reorder buffer (``io._MultiProcessIter``).

Workers never touch CUDA: each hides every device
(``CUDA_VISIBLE_DEVICES=""``) before it runs any user code, and torch
tensors in a batch leave the worker as numpy arrays (bfloat16 ones, which
numpy has no type for, are pickled as tensors).
"""
from __future__ import annotations

import itertools
import os
import threading
import traceback
from dataclasses import dataclass
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Optional

import numpy as np
import torch

SHM_THRESHOLD = 1 << 12

_worker_info: Optional["WorkerInfo"] = None

#: shared-memory transport bytes this process has mapped: live (``current``)
#: and the high-water mark (``peak``), the JAX package's ``ShmTransport``
#: host-memory stat
shm_stats = {"current": 0, "peak": 0}
_stats_lock = threading.Lock()


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: Any


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker: its ``(id, num_workers, seed, dataset)``; None in
    the parent."""
    return _worker_info


# ------------------------------------------------------------- transport


def _stat_update(delta: int) -> None:
    with _stats_lock:
        shm_stats["current"] += delta
        shm_stats["peak"] = max(shm_stats["peak"], shm_stats["current"])


def _untrack(name: str) -> None:
    """Drop a segment from this process's resource tracker: ownership
    passes to the parent with the message, which unlinks it."""
    try:
        resource_tracker.unregister(
            name if name.startswith("/") else f"/{name}", "shared_memory")
    except (KeyError, ValueError, OSError):  # tracker internals vary
        pass


def _pack_leaf(x, use_shm: bool, shm_threshold: int = SHM_THRESHOLD):
    arr = np.ascontiguousarray(x)
    if use_shm and arr.nbytes >= shm_threshold:
        seg = shared_memory.SharedMemory(create=True, size=arr.nbytes)
        np.ndarray(arr.shape, arr.dtype, buffer=seg.buf)[...] = arr
        name = seg.name
        seg.close()
        _untrack(name)
        return ("shm", name, str(arr.dtype), arr.shape)
    return ("raw", arr)


def _unpack_leaf(p):
    if p[0] == "raw":
        return p[1]
    _, name, dtype, shape = p
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    seg = shared_memory.SharedMemory(name=name)
    _stat_update(nbytes)
    try:
        arr = np.array(np.ndarray(shape, np.dtype(dtype), buffer=seg.buf))
    finally:
        seg.close()
        try:
            seg.unlink()
        except FileNotFoundError:
            pass
        _stat_update(-nbytes)
    return arr


def _pack(obj, use_shm):
    if isinstance(obj, np.ndarray):
        return ("leaf", _pack_leaf(obj, use_shm))
    if isinstance(obj, tuple):
        return ("tuple", [_pack(o, use_shm) for o in obj])
    if isinstance(obj, list):
        return ("list", [_pack(o, use_shm) for o in obj])
    if isinstance(obj, dict):
        return ("dict", {k: _pack(v, use_shm) for k, v in obj.items()})
    return ("obj", obj)


def _unpack(p):
    kind, payload = p
    if kind == "leaf":
        return _unpack_leaf(payload)
    if kind == "tuple":
        return tuple(_unpack(o) for o in payload)
    if kind == "list":
        return [_unpack(o) for o in payload]
    if kind == "dict":
        return {k: _unpack(v) for k, v in payload.items()}
    return payload


def discard(p) -> None:
    """Unlink the segments of a packed batch nobody will read (a stale
    epoch's, or one drained at shutdown)."""
    kind, payload = p
    if kind == "leaf" and payload[0] == "shm":
        try:
            seg = shared_memory.SharedMemory(name=payload[1])
            seg.close()
            seg.unlink()
        except FileNotFoundError:
            pass
    elif kind in ("tuple", "list"):
        for o in payload:
            discard(o)
    elif kind == "dict":
        for o in payload.values():
            discard(o)


# ------------------------------------------------------------- worker loop


def _to_numpy_tree(obj):
    """Torch CPU tensors in a collated batch become numpy arrays, so the
    transport and the parent's device copy own them."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, tuple):
        return tuple(_to_numpy_tree(o) for o in obj)
    if isinstance(obj, list):
        return [_to_numpy_tree(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    return obj


def worker_loop(dataset, index_queue, result_queue, collate_fn, use_shm,
                worker_id, num_workers, worker_init_fn, iterable_mode,
                batch_size, drop_last, base_seed):
    global _worker_info
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # data workers never take a card
    _worker_info = WorkerInfo(id=worker_id, num_workers=num_workers,
                              seed=base_seed + worker_id, dataset=dataset)
    np.random.seed((base_seed + worker_id) % (1 << 31))
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if iterable_mode:
            _iterable_loop(dataset, result_queue, collate_fn, use_shm,
                           batch_size, drop_last)
        else:
            _map_loop(dataset, index_queue, result_queue, collate_fn, use_shm)
    except KeyboardInterrupt:
        pass
    except Exception:  # the boundary: the traceback goes to the parent
        result_queue.put(("error", worker_id, traceback.format_exc()))
    finally:
        result_queue.put(("done", worker_id, None))
        result_queue.close()


def _map_loop(dataset, index_queue, result_queue, collate_fn, use_shm):
    while True:
        task = index_queue.get()
        if task is None:
            return
        epoch, seq, indices = task
        batch = collate_fn([dataset[i] for i in indices])
        result_queue.put(
            ("batch", (epoch, seq), _pack(_to_numpy_tree(batch), use_shm)))


def _iterable_loop(dataset, result_queue, collate_fn, use_shm, batch_size,
                   drop_last):
    # each worker iterates its own replica of the dataset; the dataset
    # shards its work by worker through get_worker_info() in __iter__
    it = iter(dataset)
    while True:
        samples = list(itertools.islice(it, batch_size))
        if not samples:
            return
        if len(samples) < batch_size and drop_last:
            return
        batch = collate_fn(samples)
        result_queue.put(("batch", -1, _pack(_to_numpy_tree(batch),
                                             use_shm)))
