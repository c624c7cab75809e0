"""Block-granular KV cache over a fixed arena (counterpart of
``paddle_tpu/serving/kv_arena.py``).

One arena per layer, ``k_pool, v_pool : [num_blocks, block_size, num_heads,
head_dim]`` on the engine's device; with ``quantized=True`` each layer's
entry is int8 ``(k, v, k_scale, v_scale)`` with float32 ``[num_blocks,
block_size]`` scale pools, one scale per token row. A request's cache is a
block table of physical block ids taken from a LIFO free list as its
context grows and returned at retire. **Physical block 0 is the scratch sink**: masked writes
of inactive lanes and padded prefill positions land there, so one decode
step serves any admit/retire pattern.

Unlike the JAX package, where pools are immutable arrays replaced after
every compiled step, the port's pools are **updated in place** (the
engine's ``index_put_``): one allocation per layer for the engine's life,
no second copy during a step.

Admission is two-phase: :meth:`KVArena.reserve` claims a request's
worst-case block budget up front, so growth mid-decode cannot fail, and
:meth:`Reservation.take` turns one reserved block into a physical block as
the context crosses a block boundary. Every block carries a refcount
(``take`` starts it at 1, :meth:`KVArena.ref` adds a sharer,
:meth:`KVArena.deref` drops one); a block returns to the free list at
refcount zero, unless the radix prefix cache (:mod:`.prefix_cache`) holds
it resident (:meth:`KVArena.mark_cached`): then it stays out of the free
list at refcount zero as a cached prefix, reclaimed by LRU eviction only
when :meth:`KVArena.reserve` would otherwise fail. Shared blocks are
read-only; a slot that must write into one copies it first (copy-on-write,
in the engine).

With the tiered KV cache (:mod:`.tiered`), :meth:`KVArena.read_block`
copies one block's rows of every primary array to the host (a spill) and
:meth:`KVArena.take_cached_block` hands out a free block at refcount zero,
cached, as the target of a restore.

Named **namespaces** (:meth:`KVArena.add_namespace`; the speculative
decoder's ``"draft"`` cache) are further per-layer pool sets addressed by
the same block ids and the same free list, refcounts and reservations: a
block taken for a slot's draft table is one allocation like any other, it
only indexes another physical pool, shaped for the draft's layers, heads and
head dim. A namespace of an int8 arena is int8 with its scale pools too.

On a tensor-parallel mesh (``mesh=``, ``paddle_tpu/serving/kv_arena.py:111``)
every payload pool, of every namespace, holds this rank's heads only
(``sharding_util.local_heads``: ``num_heads // mp``, or all of them when
they do not divide), and the int8 scale pools are whole on every rank
(``sharding_util.shard_kv_entry``). The block ids, the free list, the
refcounts and the reservations are the same on every rank: rank 0's
engine decides them and the others apply its decisions. :meth:`mesh_key`
joins the stats.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..core import device as device_mod
from ..core import flags
from ..distributed import collective
from ..distributed.sharding_util import (heads_split, local_heads,
                                         mesh_axes_key, shard_kv_entry)
from . import metrics, tiered


class ArenaExhaustedError(RuntimeError):
    """Not enough free (unreserved) blocks for the requested budget."""


class ReservationExhaustedError(ArenaExhaustedError):
    """A request tried to ``take()`` past its own budget: a bug in the
    caller's block accounting, not arena pressure."""


@dataclass
class Reservation:
    """A request's admission-time block budget."""

    arena: "KVArena"
    total: int
    taken: List[int] = field(default_factory=list)
    released: bool = False

    def remaining(self) -> int:
        return self.total - len(self.taken)

    def take(self) -> int:
        if self.released:
            raise RuntimeError("reservation already released")
        if self.remaining() <= 0:
            raise ReservationExhaustedError(
                f"reservation exhausted: all {self.total} budgeted blocks "
                "already taken; the request under-reserved at admission")
        blk = self.arena._pop_block()
        self.taken.append(blk)
        return blk

    def release(self) -> None:
        if self.released:
            return
        self.released = True
        self.arena._release(self)


class KVArena:
    """The paged KV storage and its free-list allocator. ``num_blocks``
    includes scratch block 0; ``num_blocks - 1`` blocks are allocatable.
    ``num_heads`` is the model's whole count; on a ``mesh`` the pools hold
    this rank's heads."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: Optional[int] = None,
                 dtype=torch.float32, quantized: bool = False,
                 device=device_mod.DEFAULT_DEVICE, mesh=None):
        self.block_size = int(block_size or flags.flag("kv_block_size"))
        if self.block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the scratch sink)")
        self.num_blocks = int(num_blocks)
        self.num_layers = int(num_layers)
        # `dtype` is the compute dtype; with `quantized` the payload is int8
        self.dtype = dtype
        self.quantized = bool(quantized)
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        # each namespace's whole head count (its pools may hold a shard)
        self._whole_heads: Dict[str, int] = {"primary": int(num_heads)}
        self._pools: List[Tuple[torch.Tensor, ...]] = [
            self._fresh_entry(num_heads, head_dim)
            for _ in range(self.num_layers)]
        # named namespaces: name -> per-layer entries, and name ->
        # (layers, heads, head_dim, dtype, quantized)
        self._ns_pools: Dict[str, List[Tuple[torch.Tensor, ...]]] = {}
        self._ns_shapes: Dict[str, tuple] = {}
        # LIFO: churn re-takes the most recently freed blocks
        self._free: List[int] = list(range(1, self.num_blocks))
        self._reserved = 0
        self._ever_used: set = set()
        self._high_water = 0
        self._refs: List[int] = [0] * self.num_blocks
        # blocks resident in the prefix cache at refcount zero, and the
        # cache itself (bound by PrefixCache.__init__): the eviction
        # authority reserve() turns to under pressure
        self._cached: set = set()
        self._cache = None
        # the stream whose work writes the pools (the serving engine's):
        # read_block copies there, after what it queued; None is the
        # current stream
        self.stream: Optional[torch.cuda.Stream] = None
        self._layout = None  # memoized block_layout()
        # bytes_by_namespace() as it stood when free_storage() ran
        self._freed_bytes: Optional[dict] = None

    def _fresh_entry(self, num_heads: int, head_dim: int,
                     dtype: Optional[torch.dtype] = None,
                     quantized: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, ...]:
        """One layer's zeroed entry: ``(k, v)`` in the compute dtype, or
        int8 ``(k, v, k_scale, v_scale)``; the arena's dtype and mode
        unless given. On a mesh, this rank's shard of the whole entry
        (``sharding_util.shard_kv_entry``, applied to its shapes)."""
        dtype = self.dtype if dtype is None else dtype
        quantized = self.quantized if quantized is None else quantized
        shape = (self.num_blocks, self.block_size, int(num_heads),
                 int(head_dim))
        whole = ((shape, dtype),) * 2 if not quantized else (
            ((shape, torch.int8),) * 2 + ((shape[:2], torch.float32),) * 2)
        local = shard_kv_entry(tuple(torch.empty(s, dtype=d, device="meta")
                                     for s, d in whole), self.mesh)
        return tuple(torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                     for t in local)

    def reset(self) -> None:
        """Return the arena to what a fresh one of the same arguments
        holds, keeping every tensor's storage: each pool array (k and v,
        and the scale pools of an int8 arena) is zeroed in place on the
        current stream, and the host bookkeeping -- free list, refcounts,
        reservations, cached residency, reuse history, high water, the
        bound prefix cache -- starts over. The serving engine's rebuild
        (the JAX package throws its arena away and allocates a new one,
        ``paddle_tpu/serving/engine.py:1754``): the captured step programs
        hold these tensors' addresses, so they stay valid. Every
        namespace's pools are zeroed in place too and the namespaces kept
        (the JAX ``SpecDecoder.rebuild`` binds a fresh draft namespace to
        its fresh arena; the captured speculative step holds these
        addresses as well)."""
        with torch.no_grad():
            for pools in [self._pools] + list(self._ns_pools.values()):
                for entry in pools:
                    for t in entry:
                        t.zero_()
        self._free = list(range(1, self.num_blocks))
        self._reserved = 0
        self._ever_used = set()
        self._high_water = 0
        self._refs = [0] * self.num_blocks
        self._cached = set()
        self._cache = None

    def free_storage(self) -> None:
        """Give every pool's device memory back (a gateway pool retiring a
        closed replica's engine): each array of every namespace is set to
        empty storage in place, so whatever still holds the arena -- the
        closed engine, until the garbage collector reaches it -- holds no
        device memory. The byte reports keep the sizes the pools had. The
        arena serves nothing afterwards."""
        self._freed_bytes = self.bytes_by_namespace()
        with torch.no_grad():
            for pools in [self._pools] + list(self._ns_pools.values()):
                for entry in pools:
                    for t in entry:
                        t.set_()

    @property
    def pools(self) -> List[Tuple[torch.Tensor, ...]]:
        return self._pools

    def add_namespace(self, name: str, num_layers: int, num_heads: int,
                      head_dim: int, dtype: Optional[torch.dtype] = None,
                      quantized: Optional[bool] = None) -> None:
        """Make a named pool set over the same block ids (the speculative
        decoder's draft cache), ``num_layers`` entries of ``[num_blocks,
        block_size, num_heads, head_dim]``. It shares the allocator: a block
        id taken from the free list is valid in every namespace, and the
        engine decides which namespace a slot table writes. ``quantized``
        defaults to the arena's own mode (an int8 arena's namespace is
        int8 with scale pools). A name is added once; :meth:`reset` keeps
        it."""
        if name in self._ns_pools or name == "primary":
            raise ValueError(f"namespace {name!r} already exists")
        dtype = self.dtype if dtype is None else dtype
        quantized = self.quantized if quantized is None else bool(quantized)
        self._ns_pools[name] = [
            self._fresh_entry(num_heads, head_dim, dtype, quantized)
            for _ in range(int(num_layers))]
        self._whole_heads[name] = int(num_heads)
        self._ns_shapes[name] = (int(num_layers),
                                 local_heads(num_heads, self.mesh),
                                 int(head_dim), dtype, quantized)

    def ns_pools(self, name: str) -> List[Tuple[torch.Tensor, ...]]:
        """The per-layer entries of namespace ``name``."""
        return self._ns_pools[name]

    def namespaces(self) -> List[str]:
        return list(self._ns_pools)

    def kernel_layout(self) -> dict:
        """The layout contract the paged kernels
        (:mod:`paddle_tpu_torch.ops.paged_attention`) read: per-layer
        ``(k, v)`` pools ``[num_blocks, block_size, heads, head_dim]`` in the
        compute dtype, or int8 ``(k, v, k_scale, v_scale)`` with float32
        ``[num_blocks, block_size]`` scale pools; int32 block tables index
        pool axis 0 and row 0 is the
        scratch sink, so a kernel may read any table entry (garbage rows are
        masked by position, never out of bounds); tables, positions and
        prefix lengths are runtime data on the device."""
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "quantized": self.quantized,
                "dtype": str(self.dtype).replace("torch.", ""),
                "scratch_block": 0,
                "device": str(self.device),
                "mesh": self.mesh_key()}

    # -------------------------------------------------------- allocation

    def blocks_free(self) -> int:
        return len(self._free)

    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_cached(self) -> int:
        """Blocks resident in the prefix cache (in use, but reclaimable)."""
        return len(self._cached)

    def grantable(self) -> int:
        """Blocks a new reservation could claim now: the free list minus the
        untaken remainder of outstanding reservations, plus what the prefix
        cache could evict (cached prefixes extend the free list)."""
        n = len(self._free) - self._reserved
        if self._cache is not None:
            n += self._cache.evictable_blocks()
        return n

    def reserve(self, n: int) -> Reservation:
        """Claim a worst-case budget of ``n`` blocks (none taken yet). When
        the free list alone cannot cover it, cold cached prefixes are
        evicted (LRU leaves first): eviction happens only here, where it
        would otherwise be an admission failure."""
        n = int(n)
        short = n - (len(self._free) - self._reserved)
        if (short > 0 and self._cache is not None
                and short <= self._cache.evictable_blocks()):
            # feasibility first: a doomed reservation must not flush the
            # cache on its way to raising anyway
            self._cache.evict(short)
        if len(self._free) - self._reserved < n:
            metrics.bump("arena.alloc_failed")
            raise ArenaExhaustedError(
                f"cannot reserve {n} blocks ({len(self._free)} free, "
                f"{self._reserved} already reserved)")
        self._reserved += n
        return Reservation(self, n)

    def _pop_block(self) -> int:
        if not self._free:
            metrics.bump("arena.alloc_failed")
            raise ArenaExhaustedError("free list empty")
        blk = self._free.pop()
        self._reserved -= 1
        self._refs[blk] = 1
        metrics.bump("arena.alloc")
        if blk in self._ever_used:
            metrics.bump("arena.reuse")
        self._ever_used.add(blk)
        self._high_water = max(self._high_water, self.blocks_in_use())
        return blk

    def _release(self, res: Reservation) -> None:
        self._reserved -= res.remaining()
        for blk in res.taken:
            self.deref(blk)
        res.taken = []

    def take_cached_block(self) -> int:
        """Pop one free block as a tier restore's target
        (``paddle_tpu/serving/kv_arena.py:330``): it starts at refcount
        zero and cached, so once the restore has written it, it is a
        resident prefix block like any other (admissions ``ref`` it,
        eviction can spill it again). It is outside the reservations but
        never eats into their headroom; under pressure it evicts cold
        cached prefixes as :meth:`reserve` does."""
        short = 1 - (len(self._free) - self._reserved)
        if (short > 0 and self._cache is not None
                and short <= self._cache.evictable_blocks()):
            self._cache.evict(short)
        if len(self._free) - self._reserved < 1:
            metrics.bump("arena.alloc_failed")
            raise ArenaExhaustedError(
                "no free block for a tier restore "
                f"({len(self._free)} free, {self._reserved} reserved)")
        blk = self._free.pop()
        self._refs[blk] = 0
        self._cached.add(blk)
        metrics.bump("arena.alloc")
        if blk in self._ever_used:
            metrics.bump("arena.reuse")
        self._ever_used.add(blk)
        self._high_water = max(self._high_water, self.blocks_in_use())
        if self._cache is not None:
            self._cache.invalidate()
        return blk

    def block_layout(self):
        """The :func:`.tiered.block_layout` of one primary block: per layer,
        per array (k, v and an int8 arena's scales), ``(offset, nbytes,
        shape, numpy dtype)``, and the bytes of the whole block."""
        if self._layout is None:
            self._layout = tiered.block_layout(
                [[(tuple(t.shape[1:]), tiered.NP_DTYPE[t.dtype])
                  for t in entry] for entry in self._pools])
        return self._layout

    def read_block(self, blk: int) -> "tiered.Payload":
        """Host copy of physical block ``blk``'s rows in every array of
        every PRIMARY layer entry (``paddle_tpu/serving/kv_arena.py:360``):
        the spill payload, an int8 arena's payload and scales as one unit.
        The draft namespace is never spilled (its blocks are private). On
        the card the rows are copied into one pinned buffer on the
        arena's stream, after the work queued there, and the stream is
        synchronised before this returns, so the block may be handed out
        again at once. A bfloat16 pool's rows come as their raw 16-bit
        words."""
        pieces, total = self.block_layout()
        cuda = self.device.type == "cuda"
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        stream = (torch.cuda.stream(self.stream)
                  if cuda and self.stream is not None
                  else contextlib.nullcontext())
        with torch.no_grad(), stream:
            for entry, row in zip(self._pools, pieces):
                for t, (off, n, shape, _) in zip(entry, row):
                    buf[off:off + n].view(t.dtype).view(shape).copy_(
                        t[blk], non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
        return tiered.Payload.views(buf, pieces)

    def bind_cache(self, cache) -> None:
        """Adopt a :class:`~.prefix_cache.PrefixCache` as this arena's
        eviction authority (the cache's constructor calls this)."""
        self._cache = cache

    def ref(self, blk: int) -> None:
        """Attach one more reference to a live or cached block (a slot
        sharing a resident prefix block)."""
        if blk <= 0 or (self._refs[blk] == 0 and blk not in self._cached):
            raise RuntimeError(
                f"ref() on block {blk} which is neither live nor cached")
        self._refs[blk] += 1
        # only the 0 -> 1 transition can change evictability
        if self._refs[blk] == 1 and self._cache is not None:
            self._cache.invalidate()

    def deref(self, blk: int) -> None:
        """Drop one reference; at refcount zero the block is free again,
        unless the prefix cache holds it resident: then it stays allocated
        (reclaimable by eviction) so its K/V survives for later
        admissions to share."""
        if self._refs[blk] <= 0:
            raise RuntimeError(f"deref() on block {blk} with refcount 0: "
                               "double free in the caller's accounting")
        self._refs[blk] -= 1
        if self._refs[blk] == 0:
            if self._cache is not None:
                self._cache.invalidate()
            if blk not in self._cached:
                self._free.append(blk)
                metrics.bump("arena.freed")

    def mark_cached(self, blk: int) -> None:
        """The prefix cache took residency of ``blk``: at refcount zero it
        is kept (not freed) until evicted."""
        self._cached.add(blk)

    def uncache(self, blk: int) -> None:
        """The prefix cache evicted ``blk``: if no slot still references
        it, it returns to the free list now."""
        if blk not in self._cached:
            raise RuntimeError(f"uncache() on block {blk} that is not "
                               "cached: double eviction in the caller's "
                               "accounting")
        self._cached.discard(blk)
        if self._refs[blk] == 0:
            self._free.append(blk)
            metrics.bump("arena.freed")

    def refcount(self, blk: int) -> int:
        return self._refs[blk]

    def check_invariants(self, tables=None) -> None:
        """Audit the refcount layer: free blocks are refcount zero, unique
        and uncached; cached blocks are in use (off the free list) at any
        refcount, zero included; every block is free, cached or referenced;
        and ``tables`` (per-slot block-id lists of occupied slots, a
        namespace's tables included: a draft block is private, one
        reference) reference each block exactly ``refcount`` times. Every
        pool entry of every namespace must have its structure: 4 arrays
        with ``[num_blocks, block_size]`` float32 scale pools when
        quantized, else 2."""
        sets = [("primary", self._pools, self.quantized)] + [
            (name, pools, self._ns_shapes[name][4])
            for name, pools in self._ns_pools.items()]
        for name, pools, quantized in sets:
            want = 4 if quantized else 2
            for li, entry in enumerate(pools):
                if len(entry) != want:
                    raise RuntimeError(
                        f"invariant violated: {name} pool entry {li} has "
                        f"{len(entry)} arrays (expected {want}): a quantized "
                        "pool without its scales")
                if quantized and any(
                        tuple(t.shape) != (self.num_blocks, self.block_size)
                        or t.dtype != torch.float32 for t in entry[2:]):
                    raise RuntimeError(
                        f"invariant violated: {name} scale pools of entry "
                        f"{li} are not float32 "
                        f"{(self.num_blocks, self.block_size)}")
        if len(self._free) != len(set(self._free)):
            raise RuntimeError(
                "invariant violated: duplicate block id on the free list")
        if 0 in self._free:
            raise RuntimeError("invariant violated: scratch block 0 is free")
        for blk in self._free:
            if self._refs[blk] != 0:
                raise RuntimeError(f"invariant violated: free block {blk} "
                                   f"has refcount {self._refs[blk]}")
            if blk in self._cached:
                raise RuntimeError(
                    f"invariant violated: free block {blk} is marked cached")
        if 0 in self._cached:
            raise RuntimeError("invariant violated: scratch block 0 is "
                               "cached")
        free = set(self._free)
        for blk in range(1, self.num_blocks):
            if blk not in free and not self._refs[blk] \
                    and blk not in self._cached:
                raise RuntimeError(
                    f"invariant violated: block {blk} is neither free, "
                    "cached nor referenced: leaked")
        if self._reserved < 0:
            raise RuntimeError(
                f"invariant violated: {self._reserved} blocks reserved")
        if tables is not None:
            counts: dict = {}
            for table in tables:
                for blk in table:
                    counts[blk] = counts.get(blk, 0) + 1
            live = {b for b in range(1, self.num_blocks) if self._refs[b]}
            for blk in live | set(counts):
                if blk != 0 and self._refs[blk] != counts.get(blk, 0):
                    raise RuntimeError(
                        f"invariant violated: block {blk} appears in "
                        f"{counts.get(blk, 0)} slot table entries but has "
                        f"refcount {self._refs[blk]}")

    # ------------------------------------------------------------- stats

    @staticmethod
    def _pool_bytes(pools) -> Tuple[int, int]:
        """(K/V payload bytes, scale-pool bytes) of one pool set."""
        kv = scale = 0
        for entry in pools:
            for i, t in enumerate(entry):
                b = t.numel() * t.element_size()
                if i < 2:
                    kv += b
                else:
                    scale += b
        return kv, scale

    def bytes_total(self) -> int:
        """All pool bytes of every namespace: K/V payload plus scale
        pools."""
        return sum(d["bytes"] for d in self.bytes_by_namespace().values())

    def bytes_by_namespace(self) -> dict:
        """``{name: {kv_bytes, scale_bytes, bytes, dtype, quantized}}``,
        the main pools under ``"primary"`` (the JAX package's
        breakdown)."""
        if self._freed_bytes is not None:
            return {k: dict(v) for k, v in self._freed_bytes.items()}
        out = {}
        sets = [("primary", self._pools, self.dtype, self.quantized)] + [
            (name, pools, self._ns_shapes[name][3], self._ns_shapes[name][4])
            for name, pools in self._ns_pools.items()]
        for name, pools, dtype, quantized in sets:
            kv, scale = self._pool_bytes(pools)
            out[name] = {"kv_bytes": kv, "scale_bytes": scale,
                         "bytes": kv + scale,
                         "dtype": "int8" if quantized else str(dtype)[6:],
                         "quantized": bool(quantized)}
        return out

    def scale_reduce(self, name: str = "primary"):
        """For an int8 arena whose namespace ``name`` holds a head shard:
        the in-place max over the model group that makes each token row's
        absmax, and so its scale, the whole row's on every rank
        (``quantization.quantize_kv(amax_reduce=)``); None otherwise."""
        if not (self.quantized and heads_split(self._whole_heads[name],
                                               self.mesh)):
            return None
        group = self.mesh.group
        return lambda amax: collective.all_reduce(amax, group, op="max")

    def mesh_key(self) -> Optional[tuple]:
        """The arena's mesh fingerprint (``sharding_util.mesh_axes_key``;
        None without a mesh), surfaced beside the shape facts."""
        return mesh_axes_key(self.mesh)

    def stats(self) -> dict:
        return {"blocks_total": self.num_blocks - 1,
                "blocks_free": self.blocks_free(),
                "blocks_in_use": self.blocks_in_use(),
                "blocks_reserved": self._reserved,
                "blocks_cached": self.blocks_cached(),
                "high_water": self._high_water,
                "block_size": self.block_size,
                "kv_bytes": self.bytes_total(),
                "quantized": self.quantized,
                "bytes_by_namespace": self.bytes_by_namespace(),
                "namespaces": len(self._ns_pools),
                "mesh": self.mesh_key()}
