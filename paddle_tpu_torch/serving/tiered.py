"""Tiered KV cache: host-RAM and on-disk spill tiers under the paged arena
(counterpart of ``paddle_tpu/serving/tiered.py``).

A radix prefix cache's content keys (:mod:`.prefix_cache`) do not depend on
where a block lives, so the key that names a device-resident block can name
its spilled copy in host RAM or on disk. HBM, then host RAM, then disk:

* **Spill**: when :meth:`PrefixCache.evict` reclaims a cold block, its rows
  in every array of every layer's entry (an int8 arena's payload and its
  scales as one unit) are copied to the host (``KVArena.read_block``) into
  the :class:`HostKVCache`, and the radix node stays in the tree, spilled.
* **Host tier**: an LRU dict under ``FLAGS_serving_host_cache_bytes``.
  Inserts into the prefix cache are written through here as well, so a
  later spill usually finds its bytes already present. Engines that pass
  one store (``ServingConfig.tier_store``, else :func:`get_tier_store`)
  share it.
* **Disk tier**: LRU overflow lands in ``FLAGS_serving_disk_cache_dir`` as
  atomic tmp + ``os.replace`` files with a crc32 header; a corrupt or
  truncated file is deleted and reads as a miss (the prefix is recomputed,
  never served from damaged bytes). The directory is scanned at start, so
  the tier survives the process, and processes may share it: each writer
  fills a temporary file of its own (process and thread id in its name),
  so two writers of one key never share an inode. With
  ``FLAGS_serving_tier_publish`` a write-through also lands on disk at once
  (``HostKVCache.ensure(publish=True)``): how a disaggregated prefill
  worker hands its chain to the decode workers.
* **Restore**: a radix hit on a spilled node takes a fresh arena block and
  writes the host rows into it through one captured program per engine
  (``ServingEngine._restore_nodes``): the destination ids are data, so
  every restore replays the same program.

**Payloads** (:class:`Payload`) are a list with one tuple per layer of the
block's rows of each pool array, numpy arrays that view ONE host buffer
(pinned when CUDA is present), laid out at 16-byte aligned offsets in entry
order: the restore copies each block's buffer to the device in one copy.
A bfloat16 pool's rows travel as their raw 16-bit words (``uint16``; numpy
has no bfloat16) and the dtype is in the :class:`TierView`'s signature, so
a restored block is bit-equal to the spilled one; nothing is cast. A
payload read from disk is copied into a pinned buffer when it enters the
host tier; a dropped entry's buffer returns to PyTorch's host allocator.

Entries are namespaced by the arena's signature (layers, heads, head dim,
block size, dtype, quantized; the port has no mesh fingerprint yet) and by
what filled it: the int8-weights mode and :func:`state_fingerprint`, a hash
of every byte of the served model's parameters and buffers. So only engines
of byte-compatible arenas over the same weights exchange entries; two
checkpoints of one shape, or int8 weights against float ones, never
restore each other's K/V (the JAX signature names the shape only, a
deliberate difference). Counters and gauges: ``tier.*``
in :mod:`.metrics` (the corrupt and failed disk entries in
``core.resilience`` too), ``latency.spill`` in :mod:`.telemetry`.
"""
from __future__ import annotations

import hashlib
import io
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import flags, resilience
from . import metrics, telemetry

__all__ = ["Payload", "DiskTier", "HostKVCache", "TierView",
           "get_tier_store", "reset_tier_store", "block_layout", "pack",
           "NP_DTYPE", "state_fingerprint"]

#: disk entry layout: MAGIC + 4-byte little-endian crc32(body) + body, the
#: body an ``np.savez`` archive of the entry's arrays
_MAGIC = b"PTKV1\n"
#: byte alignment of each array inside a payload's buffer
_ALIGN = 16

#: numpy's view of each pool dtype: raw 16-bit words for bfloat16
NP_DTYPE = {torch.float32: np.float32, torch.float16: np.float16,
            torch.bfloat16: np.uint16, torch.int8: np.int8}


def _aligned(n: int) -> int:
    return -(-int(n) // _ALIGN) * _ALIGN


def block_layout(specs: Sequence[Sequence[Tuple[tuple, np.dtype]]]):
    """The byte layout of one payload: ``specs`` per layer, per array,
    ``(shape, numpy dtype)``. Returns ``(pieces, total)``: per layer, per
    array ``(offset, nbytes, shape, dtype)``, and the buffer's bytes (a
    multiple of 16)."""
    pieces, off = [], 0
    for entry in specs:
        row = []
        for shape, dtype in entry:
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            row.append((off, n, tuple(int(d) for d in shape),
                        np.dtype(dtype)))
            off = _aligned(off + n)
        pieces.append(row)
    return pieces, off


def _pin() -> bool:
    return torch.cuda.is_available()


class Payload(list):
    """A spilled block: one tuple per layer of numpy arrays, each a view of
    ``buffer`` (a uint8 host tensor, pinned when CUDA is present), laid out
    by :func:`block_layout`."""

    buffer: torch.Tensor

    @classmethod
    def views(cls, buffer: torch.Tensor, pieces) -> "Payload":
        raw = buffer.numpy()
        out = cls(tuple(raw[off:off + n].view(dtype).reshape(shape)
                        for off, n, shape, dtype in entry)
                  for entry in pieces)
        out.buffer = buffer
        return out


def pack(payload) -> Payload:
    """``payload`` (per layer, per array numpy arrays) as a :class:`Payload`
    over one host buffer: a copy into a fresh (pinned) buffer, unless it is
    one already."""
    if isinstance(payload, Payload):
        return payload
    pieces, total = block_layout([[(a.shape, a.dtype) for a in entry]
                                  for entry in payload])
    buffer = torch.zeros(total, dtype=torch.uint8, pin_memory=_pin())
    raw = buffer.numpy()
    for entry, row in zip(payload, pieces):
        for a, (off, n, _, _) in zip(entry, row):
            raw[off:off + n] = np.ascontiguousarray(a).view(np.uint8) \
                .reshape(-1)
    return Payload.views(buffer, pieces)


def _payload_bytes(payload) -> int:
    return sum(arr.nbytes for entry in payload for arr in entry)


def _pack_body(payload) -> bytes:
    """The on-disk body of a payload (its structure as two scalar arrays,
    so loading needs nothing else)."""
    arrays = {"layers": np.int64(len(payload)),
              "arrs": np.int64(len(payload[0]))}
    for li, entry in enumerate(payload):
        for ai, arr in enumerate(entry):
            arrays[f"l{li}a{ai}"] = arr
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack_body(body: bytes) -> list:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        layers = int(z["layers"])
        arrs = int(z["arrs"])
        return [tuple(z[f"l{li}a{ai}"] for ai in range(arrs))
                for li in range(layers)]


def _tmp_writer_alive(name: str) -> bool:
    """Whether the process that named the temporary file ``name``
    (:meth:`DiskTier._tmp_path`: ``<key>.kv.<pid>.<tid>.tmp``) still runs
    on this host. A name of another form is not ours: counted alive, so
    it is left alone."""
    parts = name.split(".")
    if len(parts) != 5 or parts[1] != "kv" or not parts[2].isdigit():
        return True
    try:
        os.kill(int(parts[2]), 0)
    except ProcessLookupError:
        return False
    except OSError:  # another user's process
        pass
    return True


class DiskTier:
    """Content-addressed spill files under one directory
    (``paddle_tpu/serving/tiered.py:103``).

    Writes are atomic (a tmp file in the same directory, then
    ``os.replace``); the tmp file is the writer's own (:meth:`_tmp_path`:
    the JAX tier's one ``.tmp`` name per key lets two processes writing one
    key fill one inode, so a reader may meet a torn file and the second
    ``os.replace`` fails), and tmp files are never indexed; the scan at
    construction deletes those of writers no longer alive on this host (a
    writer killed between its write and its rename leaves one). Every file
    carries a crc32 of its body: a load that
    fails the check (a torn write, bit rot, truncation) deletes the file
    and returns None, so the caller recomputes. The directory is scanned at
    construction, oldest first by mtime. Bounded by ``max_bytes``
    (``FLAGS_serving_disk_cache_bytes``): past it the oldest-written
    entries are deleted. A write that fails (no space, a dead disk) leaves
    that entry a miss and is counted (``tier.disk_write_failed``). The lock
    guards only the size index; reads, writes and (de)serialisation run
    outside it."""

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        if max_bytes is None:
            max_bytes = int(flags.flag("serving_disk_cache_bytes"))
        self.root = root
        self.max_bytes = int(max_bytes)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._sizes: "OrderedDict[str, int]" = OrderedDict()
        found = []
        for name in os.listdir(root):
            if name.endswith(".kv"):
                try:
                    st = os.stat(os.path.join(root, name))
                    found.append((st.st_mtime, name, st.st_size))
                except OSError:
                    pass
            elif name.endswith(".tmp") and not _tmp_writer_alive(name):
                try:
                    os.unlink(os.path.join(root, name))
                except OSError:
                    pass
        for _, name, size in sorted(found):
            self._sizes[name] = size
        self._publish()

    def _name(self, key: bytes) -> str:
        return key.hex() + ".kv"

    @staticmethod
    def _tmp_path(path: str) -> str:
        """This writer's temporary file for ``path``: unique to the process
        and thread, and never ending in ``.kv`` (the scan skips it)."""
        return f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"

    def _publish(self) -> None:
        # the caller holds self._lock
        metrics.set_gauge("tier.disk_entries", len(self._sizes))
        metrics.set_gauge("tier.disk_bytes", sum(self._sizes.values()))

    def has(self, key: bytes) -> bool:
        """In this tier: indexed, or written into the directory by another
        process since the scan (adopted then: a file there is complete)."""
        name = self._name(key)
        with self._lock:
            if name in self._sizes:
                return True
        try:
            size = os.stat(os.path.join(self.root, name)).st_size
        except OSError:
            return False
        with self._lock:
            if name not in self._sizes:
                self._sizes[name] = size
                self._publish()
        return True

    def put(self, key: bytes, payload) -> None:
        body = _pack_body(payload)
        blob = _MAGIC + struct.pack("<I", zlib.crc32(body)) + body
        name = self._name(key)
        path = os.path.join(self.root, name)
        tmp = self._tmp_path(path)
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # readers never see a torn file
        except OSError:
            metrics.bump("tier.disk_write_failed")
            resilience.bump("tier.disk_write_failed")
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        evict = []
        with self._lock:
            self._sizes.pop(name, None)
            self._sizes[name] = len(blob)  # newest last
            metrics.bump("tier.disk_writes")
            total = sum(self._sizes.values())
            while total > self.max_bytes and len(self._sizes) > 1:
                victim, vsize = self._sizes.popitem(last=False)
                total -= vsize
                evict.append(victim)
            self._publish()
        for victim in evict:
            metrics.bump("tier.disk_evictions")
            try:
                os.unlink(os.path.join(self.root, victim))
            except OSError:
                pass

    def get(self, key: bytes) -> Optional[list]:
        name = self._name(key)
        path = os.path.join(self.root, name)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            with self._lock:
                self._sizes.pop(name, None)
                self._publish()
            return None
        head = len(_MAGIC)
        ok = (blob[:head] == _MAGIC and len(blob) >= head + 4
              and struct.unpack("<I", blob[head:head + 4])[0]
              == zlib.crc32(blob[head + 4:]))
        if ok:
            try:
                payload = _unpack_body(blob[head + 4:])
            except (OSError, ValueError, KeyError):
                ok = False
        if not ok:
            # delete the entry and miss: the caller recomputes
            metrics.bump("tier.disk_corrupt")
            resilience.bump("tier.disk_corrupt")
            try:
                os.unlink(path)
            except OSError:
                pass
            with self._lock:
                self._sizes.pop(name, None)
                self._publish()
            return None
        return payload

    def drop(self, key: bytes) -> None:
        name = self._name(key)
        try:
            os.unlink(os.path.join(self.root, name))
        except OSError:
            pass
        with self._lock:
            self._sizes.pop(name, None)
            self._publish()

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._sizes),
                    "bytes": sum(self._sizes.values()),
                    "budget_bytes": self.max_bytes}


class HostKVCache:
    """The host-RAM tier (``paddle_tpu/serving/tiered.py:254``): an LRU,
    byte-budgeted dict of spilled payloads, overflowing to an optional
    :class:`DiskTier`. Thread-safe. Keys arrive namespaced by a
    :class:`TierView`. Every payload it holds is a :class:`Payload` over
    one (pinned) buffer: it is packed on insert."""

    def __init__(self, max_bytes: Optional[int] = None,
                 disk_dir: Optional[str] = None):
        if max_bytes is None:
            max_bytes = int(flags.flag("serving_host_cache_bytes"))
        if disk_dir is None:
            disk_dir = str(flags.flag("serving_disk_cache_dir"))
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._host: "OrderedDict[bytes, Payload]" = OrderedDict()
        self._bytes = 0
        self.disk = DiskTier(disk_dir) if disk_dir else None

    # -------------------------------------------------------------- lookup

    def has(self, key: bytes) -> bool:
        """Resident in some tier (no LRU touch, no load)."""
        with self._lock:
            if key in self._host:
                return True
        return self.disk.has(key) if self.disk is not None else False

    def tier_of(self, key: bytes) -> Optional[str]:
        """``'host'``, ``'disk'`` or None."""
        with self._lock:
            if key in self._host:
                return "host"
        if self.disk is not None and self.disk.has(key):
            return "disk"
        return None

    def get(self, key: bytes):
        """``(payload, tier)``, or ``(None, None)`` on a miss (the entry was
        dropped, or its disk copy failed its crc). A disk hit is promoted
        into the host tier, pinned, and that copy is returned."""
        with self._lock:
            payload = self._host.get(key)
            if payload is not None:
                self._host.move_to_end(key)
                return payload, "host"
        if self.disk is not None:
            payload = self.disk.get(key)
            if payload is not None:
                return self._insert(key, payload), "disk"
        return None, None

    # -------------------------------------------------------------- insert

    def put(self, key: bytes, payload) -> None:
        self._insert(key, payload)

    def ensure(self, key: bytes, reader: Callable[[], Payload],
               publish: bool = False) -> int:
        """Make ``key`` resident in some tier; ``reader`` (one device-to-host
        copy) runs only when it is in none. Returns the bytes written (0:
        already present). ``publish`` puts the bytes on the disk tier now,
        not only at a host-LRU overflow (``tier.published_blocks``): other
        processes share the directory, never this host dict. No-op without
        a disk tier."""
        with self._lock:
            payload = self._host.get(key)
            if payload is not None:
                self._host.move_to_end(key)
        on_disk = self.disk is not None and self.disk.has(key)
        written = 0
        if payload is None and not on_disk:
            payload = self._insert(key, reader())
            written = _payload_bytes(payload)
        if publish and self.disk is not None and not on_disk \
                and payload is not None:
            self.disk.put(key, payload)
            metrics.bump("tier.published_blocks")
        return written

    def _insert(self, key: bytes, payload) -> Payload:
        payload = pack(payload)
        with self._lock:
            old = self._host.pop(key, None)
            if old is not None:
                self._bytes -= _payload_bytes(old)
            self._host[key] = payload
            self._bytes += _payload_bytes(payload)
            # LRU victims stay host-readable until their bytes are on disk:
            # a lookup between the two must not miss both tiers
            victims = []
            excess = self._bytes - self.max_bytes
            for k, v in self._host.items():
                if excess <= 0 or len(self._host) - len(victims) <= 1:
                    break
                if k == key:
                    continue
                victims.append((k, v))
                excess -= _payload_bytes(v)
        if self.disk is not None:
            for k, v in victims:
                self.disk.put(k, v)
        with self._lock:
            for k, v in victims:
                if self._host.get(k) is v:  # not replaced meanwhile
                    del self._host[k]
                    self._bytes -= _payload_bytes(v)
                    metrics.bump("tier.host_evictions")
                    if self.disk is None:
                        metrics.bump("tier.host_drops")
            metrics.set_gauge("tier.host_entries", len(self._host))
            metrics.set_gauge("tier.host_bytes", self._bytes)
        return payload

    def drop(self, key: bytes) -> None:
        with self._lock:
            payload = self._host.pop(key, None)
            if payload is not None:
                self._bytes -= _payload_bytes(payload)
                metrics.set_gauge("tier.host_entries", len(self._host))
                metrics.set_gauge("tier.host_bytes", self._bytes)
        if self.disk is not None:
            self.disk.drop(key)

    def stats(self) -> dict:
        with self._lock:
            out = {"host_entries": len(self._host),
                   "host_bytes": self._bytes,
                   "host_budget_bytes": self.max_bytes}
        if self.disk is not None:
            d = self.disk.stats()
            out["disk_entries"] = d["entries"]
            out["disk_bytes"] = d["bytes"]
            out["disk_dir"] = self.disk.root
        return out


def state_fingerprint(model) -> bytes:
    """A blake2b of every byte of ``model``'s parameters and buffers (int8
    payloads and their ``weight_scale`` buffers included), each with its
    name, dtype and shape: what a tier signature needs to tell two sets of
    weights apart, however few tensors differ. Every byte is hashed (a
    device tensor is copied to the host first), so the first call on a
    large model takes seconds. Memoized on the model, keyed by each
    tensor's ``(data_ptr(), _version)``: engines sharing one model hash it
    once, and an in-place update, or a tensor swapped in, is hashed
    again."""
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    stamp = tuple((name, t.data_ptr(), t._version) for name, t in tensors)
    memo = getattr(model, "_state_fingerprint", None)
    if memo is not None and memo[0] == stamp:
        return memo[1]
    h = hashlib.blake2b(digest_size=16)
    with torch.no_grad():
        for name, t in tensors:
            h.update(f"{name}:{t.dtype}:{tuple(t.shape)};".encode())
            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            h.update(raw.cpu().numpy().data)
    digest = h.digest()
    model._state_fingerprint = (stamp, digest)
    return digest


class TierView:
    """One engine's handle on a shared :class:`HostKVCache`
    (``paddle_tpu/serving/tiered.py:458``): every key is prefixed with a
    hash of the arena's ``signature``, and the view keeps the engine's
    lifetime counters (the ``tier.*`` metrics are process-global). It
    survives ``ServingEngine.rebuild()``: the tiers are off the device, so
    the requests replayed after a fault restore their prefixes warm."""

    def __init__(self, store: HostKVCache, signature: tuple):
        self.store = store
        self.signature = signature
        self._ns = hashlib.blake2b(repr(signature).encode(),
                                   digest_size=8).digest()
        #: rank 0 of a tensor-parallel mesh: ``mirror(kind, key, block)``
        #: sends each tier write to the followers, which write their own
        #: rows of ``block`` under ``key`` (``serving.tp``)
        self.mirror: Optional[Callable[[str, bytes, int], None]] = None
        self.spilled_blocks = 0
        self.spilled_bytes = 0
        self.restored_blocks = 0
        self.restored_bytes = 0
        self.host_hits = 0
        self.disk_hits = 0
        self.misses = 0

    @property
    def namespace(self) -> str:
        """The hash every key of this view is prefixed with, in hex: equal
        across engines (and processes) whose signatures agree."""
        return self._ns.hex()

    def _k(self, key: bytes) -> bytes:
        return self._ns + key

    def has(self, key: bytes) -> bool:
        return self.store.has(self._k(key))

    def tier_of(self, key: bytes) -> Optional[str]:
        return self.store.tier_of(self._k(key))

    def spill(self, key: bytes, reader: Callable[[], Payload],
              block: Optional[int] = None) -> None:
        """A device block is evicted: make its bytes tier-resident
        (``reader`` runs only when the write-through copy is gone).
        ``block`` is the device block ``reader`` reads (for the mirror)."""
        if self.mirror is not None and block is not None:
            self.mirror("spill", key, block)
        t0 = time.perf_counter()
        written = self.store.ensure(self._k(key), reader)
        telemetry.observe("latency.spill", time.perf_counter() - t0)
        self.spilled_blocks += 1
        self.spilled_bytes += written
        metrics.bump("tier.spilled_blocks")
        if written:
            metrics.bump("tier.spilled_bytes", written)

    def write_through(self, key: bytes, reader: Callable[[], Payload],
                      block: Optional[int] = None) -> None:
        """A freshly inserted prefix block lands in the host tier too, so a
        later spill is free and a rebuilt engine can restore it; under
        ``FLAGS_serving_tier_publish`` on the disk tier at once as well."""
        if self.mirror is not None and block is not None:
            self.mirror("write_through", key, block)
        self.store.ensure(self._k(key), reader,
                          publish=bool(flags.flag("serving_tier_publish")))

    def lookup(self, key: bytes) -> Optional[Payload]:
        """Load for a restore; None when the entry was lost. Counts the
        tier's hit or the miss; the restore counters move only once the
        restore has run (:meth:`note_restored`)."""
        payload, tier = self.store.get(self._k(key))
        if payload is None:
            self.misses += 1
            metrics.bump("tier.misses")
            return None
        if tier == "host":
            self.host_hits += 1
            metrics.bump("tier.host_hits")
        else:
            self.disk_hits += 1
            metrics.bump("tier.disk_hits")
        return payload

    def note_restored(self, payloads: List[Payload]) -> None:
        if not payloads:
            return
        n = sum(_payload_bytes(p) for p in payloads)
        self.restored_blocks += len(payloads)
        self.restored_bytes += n
        metrics.bump("tier.restored_blocks", len(payloads))
        metrics.bump("tier.restored_bytes", n)

    def stats(self) -> dict:
        out = {"tier.spilled_blocks": self.spilled_blocks,
               "tier.spilled_bytes": self.spilled_bytes,
               "tier.restored_blocks": self.restored_blocks,
               "tier.restored_bytes": self.restored_bytes,
               "tier.host_hits": self.host_hits,
               "tier.disk_hits": self.disk_hits,
               "tier.misses": self.misses}
        out.update({f"tier.{k}": v for k, v in self.store.stats().items()
                    if isinstance(v, (int, float))})
        return out


_default_store: Optional[HostKVCache] = None
_default_lock = threading.Lock()


def get_tier_store() -> HostKVCache:
    """The process-global store, made once from
    ``FLAGS_serving_host_cache_bytes`` / ``FLAGS_serving_disk_cache_dir``:
    every tiered engine without ``ServingConfig.tier_store`` attaches
    here."""
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = HostKVCache()
        return _default_store


def reset_tier_store() -> None:
    """Drop the process-global store (a fresh one re-reads the flags)."""
    global _default_store
    with _default_lock:
        _default_store = None
