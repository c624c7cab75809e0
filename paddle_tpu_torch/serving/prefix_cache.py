"""Radix prefix cache: content-addressed KV block sharing for the arena
(counterpart of ``paddle_tpu/serving/prefix_cache.py``).

Serving traffic shares prompt prefixes: system prompts, few-shot examples,
chat history replayed every turn. The paged arena (:mod:`.kv_arena`)
stores K/V at block granularity, which is the unit a prefix cache wants: a
prompt's K/V is a chain of full blocks, and two prompts that agree on their
first ``k * block_size`` tokens can share the same ``k`` physical blocks.

This module is the tree over those chains:

* **Nodes are block-granular token chunks.** A node's key is the content
  hash of ``(parent_key, chunk_tokens)``, the tokens as **int32** bytes (as
  the JAX package hashes them, so keys agree across the two packages), so a
  chunk equals another chunk only in the same left context. Only FULL
  blocks are inserted; the trailing partial block of a prompt stays private
  to its slot, which is still writing it.
* **Matching is admission's tree walk.** :meth:`PrefixCache.match` returns
  the longest chain of resident full blocks. The engine attaches each
  matched block to the slot's table by reference (``KVArena.ref``) and
  prefills only the unmatched suffix. Shared blocks are read-only; a slot
  that must write into one (a fully cached, block-aligned prompt
  recomputing its last token) copies it first (copy-on-write, in the
  engine).
* **Insertion** follows a successful prefill: the prompt's full blocks are
  inserted and ``arena.mark_cached`` keeps them off the free list when the
  slot retires (refcount zero and cached is resident, not leaked).
* **Eviction is LRU over leaves at refcount zero**, and only when
  ``KVArena.reserve`` would otherwise fail: cached prefixes extend the free
  list and never compete with live traffic. Evicting a leaf can expose its
  parent, so a cold chain unwinds from its tail.

Counters (``prefix.*`` in :mod:`.metrics`): ``hits`` (admissions with at
least one matched block), ``misses``, ``hit_tokens``, ``inserted_blocks``,
``evictions``, and the ``resident_blocks`` gauge; the engine bumps
``cow_copies`` and ``suffix_prefills``.

**Tiered spill** (``tier=``, a :class:`.tiered.TierView`;
``FLAGS_serving_kv_tiering``): eviction does not discard a block's K/V.
Its rows are already in a tier (written through at insert) or are copied
out now, and the node stays in the tree, spilled (``block == -1``). A walk
that reaches a spilled node, or a chunk key another engine wrote into the
shared store, counts it as matched: the engine restores it into a fresh
block before attaching. A spilled node whose tier entry was lost (dropped
from the host tier with no disk tier, or a disk file that failed its crc)
is pruned when found, and the walk stops there: the admission recomputes.

**Adapter roots.** A chain is rooted at a key per adapter: the base model
(adapter 0) at ``_ROOT_KEY``, so its keys stay byte-equal to the JAX
package's, and an adapter at :func:`adapter_root` of its weights
fingerprint (``AdapterArena.fingerprint``), never of its recyclable row
id. An adapter lane's K/V depends on its adapter, so a chain under one
root never serves a lane of another, and a tier entry written under it
is keyed honestly too. :meth:`PrefixCache.chunk_keys`, :meth:`match`,
:meth:`match_stats` and :meth:`insert` take the root; the JAX package
roots every chain at ``_ROOT_KEY`` whatever the adapter.

**Cross-replica index** (:meth:`PrefixCache.bind_index`, a gateway
``GlobalRadixIndex``): device-residency deltas are published per replica,
an insert or a restore as ``publish_insert``, an eviction, a spill or a
removal as ``publish_evict`` (the index is device-only: a spilled block
lives in the shared tier, which every replica reads).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from . import metrics

_ROOT_KEY = b"prefix-cache-root"


def adapter_root(fingerprint: bytes) -> bytes:
    """The root key of an adapter's chains, from its weights fingerprint:
    disjoint from ``_ROOT_KEY`` and from every other adapter's root."""
    h = hashlib.blake2b(_ROOT_KEY + b"/adapter/", digest_size=16)
    h.update(fingerprint)
    return h.digest()


def _chunk_key(parent_key: bytes, chunk: np.ndarray) -> bytes:
    """Content hash of one block-granular chunk in its left context: keyed
    by (parent hash, int32 token bytes), so equal chunks under different
    prefixes never alias."""
    h = hashlib.blake2b(parent_key, digest_size=16)
    h.update(np.ascontiguousarray(chunk, np.int32).tobytes())
    return h.digest()


class PrefixNode:
    """One full block of the tree: its chunk's tokens, the physical arena
    block holding the chunk's K/V, and its place in the tree. With a tier a
    node may be spilled instead: ``block == -1`` and its rows in the tier
    under ``key``. A resident node's ancestors are all resident (eviction
    takes leaves first; restores and inserts walk from the root), so every
    matched chain is a resident prefix followed by a spilled tail."""

    __slots__ = ("key", "chunk", "block", "parent", "children", "last_use",
                 "spilled")

    def __init__(self, key: bytes, chunk: np.ndarray, block: int,
                 parent: Optional["PrefixNode"]):
        self.key = key
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[bytes, "PrefixNode"] = {}
        self.last_use = 0
        self.spilled = False


class PrefixCache:
    """The radix tree over one :class:`~.kv_arena.KVArena`'s blocks. Host
    bookkeeping only: a hit is other int32 rows in a slot's block table and
    never builds a program. Single-threaded: the API lock serialises
    admission."""

    def __init__(self, arena, block_size: Optional[int] = None, tier=None):
        self.arena = arena
        self.block_size = int(block_size or arena.block_size)
        # the spill store (a tiered.TierView); None: eviction discards
        self.tier = tier
        self._root = PrefixNode(_ROOT_KEY, np.zeros(0, np.int32), -1, None)
        self._nodes: Dict[bytes, PrefixNode] = {}
        self._n_spilled = 0
        self._tick = 0
        self._evictable_memo: Optional[int] = None
        # the cross-replica residency index and this cache's replica id
        self._index = None
        self._replica: Optional[int] = None
        # per-instance lifetime counters (metrics are process-global)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evictions = 0
        self.spills = 0
        self.restores = 0
        arena.bind_cache(self)

    # ------------------------------------------------------ index plumbing

    def bind_index(self, index, replica: int) -> None:
        """Attach a gateway ``GlobalRadixIndex``: this cache's
        device-residency deltas are published under ``replica``. Binding
        resets the replica's published state first (a respawned or
        rebuilt engine starts cold), then publishes the blocks already
        resident."""
        self._index = index
        self._replica = int(replica)
        index.publish_reset(self._replica)
        resident = [n.key for n in self._nodes.values() if not n.spilled]
        if resident:
            index.publish_insert(self._replica, resident)

    def _publish_insert(self, keys: List[bytes]) -> None:
        if self._index is not None and keys:
            self._index.publish_insert(self._replica, keys)

    def _publish_evict(self, key: bytes) -> None:
        if self._index is not None:
            self._index.publish_evict(self._replica, key)

    # ------------------------------------------------------------- walking

    def _walk(self, tokens, root: bytes = _ROOT_KEY) -> List[PrefixNode]:
        """Longest chain of matchable FULL blocks of ``tokens``: resident
        nodes, then (with a tier) spilled nodes whose entry is still in a
        tier. A key absent from the tree but present in the shared store
        (another engine's write-through) becomes a spilled node; a spilled
        node whose entry was lost is pruned, with its subtree, and the walk
        stops there."""
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        out: List[PrefixNode] = []
        node = self._root
        for i, key in enumerate(self.chunk_keys(tokens, root)):
            child = node.children.get(key)
            if child is None:
                if self.tier is None or not self.tier.has(key):
                    break
                child = PrefixNode(key, np.array(tokens[i * bs:(i + 1) * bs]),
                                   -1, node)
                child.spilled = True
                node.children[key] = child
                self._nodes[key] = child
                self._n_spilled += 1
            elif child.spilled and not self.tier.has(key):
                self.prune_lost(child)
                break
            out.append(child)
            node = child
        return out

    def chunk_keys(self, tokens, root: bytes = _ROOT_KEY) -> List[bytes]:
        """The content-key chain of ``tokens``' full blocks under ``root``
        (the adapter's: ``_ROOT_KEY`` for the base model): a pure function
        of the tokens and the root (not of the tree), so a caller polling
        residency every scheduler step hashes once and reuses it."""
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        keys: List[bytes] = []
        parent = root
        for i in range(int(tokens.shape[0]) // bs):
            parent = _chunk_key(parent, tokens[i * bs:(i + 1) * bs])
            keys.append(parent)
        return keys

    def match_stats(self, tokens=None, keys: Optional[List[bytes]] = None,
                    root: bytes = _ROOT_KEY):
        """One probe, the admission-sizing numbers ``(resident, spilled,
        unpinned)``: device-resident matched full blocks (attached by
        reference), tier-restorable matched blocks (spilled in the tree or
        in the shared store: no prefill, but each takes a fresh block) and
        the resident ones at refcount zero. The last matters because
        ``grantable()`` counts refcount-zero cached blocks as eviction
        headroom, but an admission of these tokens pins them before it
        reserves: a feasibility check must subtract them. Changes nothing;
        pass precomputed ``keys`` (:meth:`chunk_keys`) to skip hashing,
        else ``tokens`` are hashed under ``root``."""
        if keys is None:
            keys = self.chunk_keys(tokens, root)
        resident = spilled = unpinned = 0
        node: Optional[PrefixNode] = self._root
        for k in keys:
            child = node.children.get(k) if node is not None else None
            if child is not None and not child.spilled:
                resident += 1
                if self.arena.refcount(child.block) == 0:
                    unpinned += 1
                node = child
                continue
            # spilled or absent: matchable while the tier holds it (past
            # the resident prefix everything is spilled or absent)
            if self.tier is not None and self.tier.has(k):
                spilled += 1
                node = child
                continue
            break
        return resident, spilled, unpinned

    def resident_tokens_for(self, keys: List[bytes]) -> int:
        """Matchable full blocks of a precomputed :meth:`chunk_keys` chain
        (hashed under the request's adapter root),
        device-resident or tier-restorable, in tokens (cache-affinity
        scheduling: either skips the prefill)."""
        resident, spilled, _ = self.match_stats(keys=keys)
        return (resident + spilled) * self.block_size

    def match(self, tokens, root: bytes = _ROOT_KEY) -> List[PrefixNode]:
        """The admission walk under ``root``: the matched chain, each
        node's LRU clock touched. The caller takes the references
        (``arena.ref``)."""
        chain = self._walk(tokens, root)
        self._tick += 1
        for node in chain:
            node.last_use = self._tick
        return chain

    # ----------------------------------------------------------- insertion

    def insert(self, tokens, blocks, num_blocks: int,
               root: bytes = _ROOT_KEY) -> int:
        """Insert the first ``num_blocks`` full chunks of ``tokens`` under
        ``root`` (the adapter's), whose K/V was just scattered into
        physical ``blocks[i]``. A chunk already
        resident is skipped: the existing block stays authoritative and the
        caller's copy stays private to its slot, freed at retire. A spilled
        node is revived onto the caller's block (the same tokens in the
        same left context: the same bytes). With a tier every full block is
        also written through to the host tier. Returns how many blocks
        became resident."""
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        node = self._root
        self._tick += 1
        inserted = 0
        new_keys: List[bytes] = []
        arena = self.arena
        keys = self.chunk_keys(tokens[:num_blocks * bs], root)
        for i, key in enumerate(keys):
            chunk = tokens[i * bs:(i + 1) * bs]
            child = node.children.get(key)
            if child is None or child.spilled:
                blk = int(blocks[i])
                if blk <= 0:
                    raise RuntimeError(
                        f"insert of block {blk}: scratch block 0 (or no "
                        "block) can never enter the tree")
                if child is None:
                    child = PrefixNode(key, np.array(chunk), blk, node)
                    node.children[key] = child
                    self._nodes[key] = child
                else:
                    child.block = blk
                    child.spilled = False
                    self._n_spilled -= 1
                arena.mark_cached(blk)
                inserted += 1
                new_keys.append(key)
            child.last_use = self._tick
            if self.tier is not None:
                blk = child.block
                self.tier.write_through(key,
                                        lambda b=blk: arena.read_block(b),
                                        block=blk)
            node = child
        if inserted:
            self.invalidate()
            self._publish_insert(new_keys)
            self.inserted_blocks += inserted
            metrics.bump("prefix.inserted_blocks", inserted)
            metrics.set_gauge("prefix.resident_blocks",
                              self.resident_blocks())
        return inserted

    # ------------------------------------------------------------ eviction

    def _is_evictable_leaf(self, node: PrefixNode) -> bool:
        # a leaf for eviction has no RESIDENT child: spilled descendants
        # hold no device block
        return (node is not self._root and not node.spilled
                and self.arena.refcount(node.block) == 0
                and not any(not c.spilled for c in node.children.values()))

    def invalidate(self) -> None:
        """Drop the memoized evictable count (the arena calls this on every
        refcount transition that can change it; insert and evict too)."""
        self._evictable_memo = None

    def evictable_blocks(self) -> int:
        """Blocks reclaimable by (possibly cascading) eviction: nodes whose
        whole subtree is at refcount zero. The arena adds this to
        ``grantable()``. Memoized between transitions."""
        if self._evictable_memo is not None:
            return self._evictable_memo
        order: List[PrefixNode] = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            order.append(node)
            stack.extend(node.children.values())
        blocked: Dict[bytes, bool] = {}
        n = 0
        for node in reversed(order):  # children before parents
            # spilled nodes hold no device block: never pinned or counted
            pinned = (not node.spilled
                      and self.arena.refcount(node.block) > 0) or any(
                blocked[c.key] for c in node.children.values())
            blocked[node.key] = pinned
            n += not pinned and not node.spilled
        self._evictable_memo = n
        return n

    def evict(self, need: int) -> int:
        """Free up to ``need`` device blocks, least recently used leaves
        first (evicting a leaf may expose its parent, which joins the
        candidates). With a tier a victim is spilled, its node kept;
        without one it is removed. The arena calls this from ``reserve()``
        and ``take_cached_block()`` when the free list alone cannot cover
        a budget. Returns the blocks freed."""
        freed = 0
        leaves = {n.key: n for n in self._nodes.values()
                  if self._is_evictable_leaf(n)}
        while freed < need and leaves:
            victim = min(leaves.values(), key=lambda n: n.last_use)
            del leaves[victim.key]
            parent = victim.parent
            if self.tier is not None:
                self._spill(victim)
            else:
                self._remove(victim)
            freed += 1
            if self._is_evictable_leaf(parent):
                leaves[parent.key] = parent
        if freed:
            self.evictions += freed
            metrics.bump("prefix.evictions", freed)
            metrics.set_gauge("prefix.resident_blocks",
                              self.resident_blocks())
        return freed

    def _spill(self, node: PrefixNode) -> None:
        """Demote a resident refcount-zero node to the tier: make its rows
        tier-resident (usually free: the write-through copy is there), then
        free its device block. The node stays for a later walk."""
        blk = node.block
        self.tier.spill(node.key, lambda: self.arena.read_block(blk),
                        block=blk)
        node.spilled = True
        node.block = -1
        self._n_spilled += 1
        self.spills += 1
        self.invalidate()
        self.arena.uncache(blk)
        self._publish_evict(node.key)

    def mark_restored(self, node: PrefixNode, blk: int) -> None:
        """The engine restored ``node``'s rows into the fresh cached block
        ``blk`` (refcount zero: the restoring admission refs it next)."""
        node.block = int(blk)
        node.spilled = False
        self._n_spilled -= 1
        self.restores += 1
        self.invalidate()
        self._publish_insert([node.key])
        metrics.set_gauge("prefix.resident_blocks", self.resident_blocks())

    def prune_lost(self, node: PrefixNode) -> None:
        """Drop a spilled node whose tier entry vanished, with its subtree
        (all spilled, by the resident-ancestors invariant). Spilled nodes
        hold no device block: tree bookkeeping only."""
        stack = [node]
        while stack:
            n = stack.pop()
            if not n.spilled:
                raise RuntimeError("prune_lost() reached a resident node")
            stack.extend(n.children.values())
            n.parent.children.pop(n.key, None)
            self._nodes.pop(n.key, None)
            self._n_spilled -= 1
        self.invalidate()

    def _remove(self, node: PrefixNode) -> None:
        assert not node.children, "only leaves are evicted"
        node.parent.children.pop(node.key, None)
        self._nodes.pop(node.key, None)
        self.invalidate()
        self.arena.uncache(node.block)
        self._publish_evict(node.key)

    # --------------------------------------------------------------- admin

    def resident_blocks(self) -> int:
        """Device-resident nodes (spilled ones hold no block)."""
        return len(self._nodes) - self._n_spilled

    def spilled_nodes(self) -> int:
        return self._n_spilled

    def note_hit(self, matched_tokens: int) -> None:
        """Engine callback after a successful admission (counted on
        success, not at walk time, so a failed prefill is not a hit)."""
        if matched_tokens > 0:
            self.hits += 1
            self.hit_tokens += matched_tokens
            metrics.bump("prefix.hits")
            metrics.bump("prefix.hit_tokens", matched_tokens)
        else:
            self.misses += 1
            metrics.bump("prefix.misses")

    def stats(self) -> dict:
        out = {"resident_blocks": self.resident_blocks(),
               "evictable_blocks": self.evictable_blocks(),
               "hits": self.hits,
               "misses": self.misses,
               "hit_tokens": self.hit_tokens,
               "inserted_blocks": self.inserted_blocks,
               "evictions": self.evictions}
        if self.tier is not None:
            out["spilled_nodes"] = self._n_spilled
            out["spills"] = self.spills
            out["restores"] = self.restores
        return out
