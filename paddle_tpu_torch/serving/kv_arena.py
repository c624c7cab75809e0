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
refcount zero.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from ..core import device as device_mod
from ..core import flags
from . import metrics


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
    includes scratch block 0; ``num_blocks - 1`` blocks are allocatable."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: Optional[int] = None,
                 dtype=torch.float32, quantized: bool = False,
                 device=device_mod.DEFAULT_DEVICE):
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
        shape = (self.num_blocks, self.block_size, int(num_heads),
                 int(head_dim))
        self._pools: List[Tuple[torch.Tensor, ...]] = [
            self._fresh_entry(shape) for _ in range(self.num_layers)]
        # LIFO: churn re-takes the most recently freed blocks
        self._free: List[int] = list(range(1, self.num_blocks))
        self._reserved = 0
        self._ever_used: set = set()
        self._high_water = 0
        self._refs: List[int] = [0] * self.num_blocks

    def _fresh_entry(self, shape) -> Tuple[torch.Tensor, ...]:
        """One layer's zeroed entry: ``(k, v)`` in the compute dtype, or
        int8 ``(k, v, k_scale, v_scale)``."""
        if not self.quantized:
            return tuple(torch.zeros(shape, dtype=self.dtype,
                                     device=self.device) for _ in range(2))
        return (tuple(torch.zeros(shape, dtype=torch.int8, device=self.device)
                      for _ in range(2))
                + tuple(torch.zeros(shape[:2], dtype=torch.float32,
                                    device=self.device) for _ in range(2)))

    @property
    def pools(self) -> List[Tuple[torch.Tensor, ...]]:
        return self._pools

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
                "device": str(self.device)}

    # -------------------------------------------------------- allocation

    def blocks_free(self) -> int:
        return len(self._free)

    def blocks_in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def grantable(self) -> int:
        """Blocks a new reservation could claim now: the free list minus the
        untaken remainder of outstanding reservations."""
        return len(self._free) - self._reserved

    def reserve(self, n: int) -> Reservation:
        n = int(n)
        if self.grantable() < n:
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

    def ref(self, blk: int) -> None:
        """Attach one more reference to a live block."""
        if blk <= 0 or self._refs[blk] == 0:
            raise RuntimeError(f"ref() on block {blk} which is not live")
        self._refs[blk] += 1

    def deref(self, blk: int) -> None:
        """Drop one reference; at refcount zero the block is free again."""
        if self._refs[blk] <= 0:
            raise RuntimeError(f"deref() on block {blk} with refcount 0: "
                               "double free in the caller's accounting")
        self._refs[blk] -= 1
        if self._refs[blk] == 0:
            self._free.append(blk)
            metrics.bump("arena.freed")

    def refcount(self, blk: int) -> int:
        return self._refs[blk]

    def check_invariants(self, tables=None) -> None:
        """Audit the refcount layer: free blocks are refcount zero and
        unique, and ``tables`` (per-slot block-id lists of occupied slots)
        reference each block exactly ``refcount`` times. Every pool entry
        must have the arena's structure: 4 arrays with ``[num_blocks,
        block_size]`` float32 scale pools when quantized, else 2."""
        want = 4 if self.quantized else 2
        for li, entry in enumerate(self._pools):
            if len(entry) != want:
                raise RuntimeError(
                    f"invariant violated: pool entry {li} has {len(entry)} "
                    f"arrays (expected {want}): a quantized pool without its "
                    "scales")
            if self.quantized and any(
                    tuple(t.shape) != (self.num_blocks, self.block_size)
                    or t.dtype != torch.float32 for t in entry[2:]):
                raise RuntimeError(
                    f"invariant violated: scale pools of entry {li} are not "
                    f"float32 {(self.num_blocks, self.block_size)}")
        if len(self._free) != len(set(self._free)):
            raise RuntimeError(
                "invariant violated: duplicate block id on the free list")
        if 0 in self._free:
            raise RuntimeError("invariant violated: scratch block 0 is free")
        for blk in self._free:
            if self._refs[blk] != 0:
                raise RuntimeError(f"invariant violated: free block {blk} "
                                   f"has refcount {self._refs[blk]}")
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

    def _pool_bytes(self) -> Tuple[int, int]:
        """(K/V payload bytes, scale-pool bytes) of every layer."""
        kv = scale = 0
        for entry in self._pools:
            for i, t in enumerate(entry):
                b = t.numel() * t.element_size()
                if i < 2:
                    kv += b
                else:
                    scale += b
        return kv, scale

    def bytes_total(self) -> int:
        """All pool bytes: K/V payload plus scale pools."""
        return sum(self._pool_bytes())

    def bytes_by_namespace(self) -> dict:
        """``{"primary": {kv_bytes, scale_bytes, bytes, dtype, quantized}}``
        (the JAX package's breakdown; the port has no other namespace)."""
        kv, scale = self._pool_bytes()
        dtype = "int8" if self.quantized else str(self.dtype)[6:]
        return {"primary": {"kv_bytes": kv, "scale_bytes": scale,
                            "bytes": kv + scale, "dtype": dtype,
                            "quantized": self.quantized}}

    def stats(self) -> dict:
        return {"blocks_total": self.num_blocks - 1,
                "blocks_free": self.blocks_free(),
                "blocks_in_use": self.blocks_in_use(),
                "blocks_reserved": self._reserved,
                "high_water": self._high_water,
                "block_size": self.block_size,
                "kv_bytes": self.bytes_total(),
                "quantized": self.quantized,
                "bytes_by_namespace": self.bytes_by_namespace()}
