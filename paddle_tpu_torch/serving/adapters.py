"""Paged multi-LoRA adapter arena for the serving engine (counterpart of
``paddle_tpu/serving/adapters.py``).

One engine serves many fine-tunes of one base model, and one batch mixes
them: each slot names an adapter row, and the row is data to the captured
step programs, as a slot's block table is.

* Per targeted linear (the four matmuls ``quantize_serving_weights``
  quantizes: ``attn.qkv``, ``attn.proj``, ``mlp.up``, ``mlp.down`` of each
  layer) the arena holds stacked float32 pools ``A [cap+1, in, r]`` and ``B
  [cap+1, r, out]``, **allocated once on the engine's device**. Row 0 is
  the identity (all zeros): a slot with adapter 0 runs the base model,
  token for token what an engine without the arena emits.
* :meth:`AdapterArena.register` takes a row from a LIFO free list and
  writes the adapter's matrices into it, ``alpha / rank`` folded into B;
  :meth:`AdapterArena.unregister` zeroes the row and returns it. Both write
  **in place** (``copy_`` / ``zero_``): the captured graphs hold the pools'
  addresses, where the JAX arena swaps in fresh device arrays
  (``paddle_tpu/serving/adapters.py:289``). A write runs on the engine's
  stream after that stream has finished everything queued on it, so no
  replay in flight reads a half-written row; the engine calls both under
  its API lock, between two steps.
* Inside a step each lane gathers its row: ``delta = (x @ A[ids]) @ B[ids]``
  batched over lanes in float32 and added to the base matmul's output once,
  cast to its dtype (:func:`lora_delta`, through the hook that
  ``models.gpt._serving_linear`` calls). With int8 weights the base matmul
  dequantizes and the adapter stays float32.

The binding between the pools and the model's linears is a context
(:meth:`AdapterArena.bind`) over a tensor of per-lane ids: the engine's step
functions enter it around the model call, with the decode step's static
``[S]`` id buffer or a prefill's ``[1]`` one, so a captured graph records the
gather from those buffers. Entered eagerly around ``generate()`` with one id
it runs that adapter alone. Without a binding (training, ``generate()``,
the speculative verify step) the hook returns the base output untouched.

Each live row carries a **fingerprint** (:meth:`AdapterArena.fingerprint`),
a blake2b of the adapter's A and B bytes, its rank and its alpha, computed
once on the host at registration and cleared at unregister. The prefix
cache roots an adapter's chains at a key derived from it
(:func:`.prefix_cache.adapter_root`): a lane's K/V depends on its adapter,
so chains of different adapters never meet, and a freed row registered
again with other weights misses the old chain. The JAX package keys a
chain by its tokens alone, whatever the adapter (a deliberate difference).

On a tensor-parallel mesh every rank holds the arena (the JAX package
replicates it, ``paddle_tpu/serving/adapters.py:289-312``), each site's
pools shaped as its layer's shard: on a column-split linear A whole and
B's columns for this rank; on a row-split linear A's rows for this rank and
B whole, so the update of a row linear is this rank's partial product,
added before the all-reduce (``models.gpt._serving_linear``). A whole delta
is never added on every rank. Rank 0 sends each registration and
unregistration to the followers (``serving.tp``).

Counters and gauges (``lora.*`` in :mod:`.metrics`): ``registered`` /
``unregistered`` / ``register_failed`` / ``admits``, gauges ``lora.slots``
/ ``lora.live`` / ``lora.arena_bytes`` / ``lora.active_slots``.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import gpt as gpt_mod
from . import metrics

__all__ = ["LoraAdapter", "AdapterArena", "AdapterExhaustedError",
           "TARGETS", "lora_delta"]

#: the targeted linears, in model order per layer
TARGETS = ("attn.qkv", "attn.proj", "mlp.up", "mlp.down")

_tls = threading.local()  # .ctx: the binding the current thread entered


class AdapterExhaustedError(RuntimeError):
    """Every adapter row is live: unregister one, or make the engine with a
    larger ``lora_adapters`` (``FLAGS_serving_lora_adapters``)."""


class LoraAdapter:
    """One adapter's weights, ``{"<layer>.<target>": (A [in, r], B [r,
    out])}`` with ``target`` in :data:`TARGETS`; a site left out stays the
    identity. ``alpha`` is the LoRA scaling, folded into B as ``alpha /
    rank`` at registration."""

    def __init__(self, weights: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 alpha: float = 1.0, name: str = ""):
        self.weights = {str(k): (np.asarray(a, np.float32),
                                 np.asarray(b, np.float32))
                        for k, (a, b) in weights.items()}
        self.alpha = float(alpha)
        self.name = name

    @classmethod
    def random(cls, cfg, rank: int, seed: int = 0, scale: float = 0.02,
               name: str = "") -> "LoraAdapter":
        """A dense random adapter over every site, drawn from numpy's
        ``default_rng(seed)`` in the JAX package's order, so both packages
        build the same adapter from the same seed."""
        rng = np.random.default_rng(seed)
        dims = {"attn.qkv": (cfg.hidden_size, 3 * cfg.hidden_size),
                "attn.proj": (cfg.hidden_size, cfg.hidden_size),
                "mlp.up": (cfg.hidden_size, cfg.intermediate_size),
                "mlp.down": (cfg.intermediate_size, cfg.hidden_size)}
        weights = {}
        for li in range(cfg.num_layers):
            for tgt, (fi, fo) in dims.items():
                weights[f"{li}.{tgt}"] = (
                    rng.normal(0, scale, (fi, rank)),
                    rng.normal(0, scale, (rank, fo)))
        return cls(weights, name=name)


class _Binding:
    """What the hook reads: the arena and the per-lane id tensor."""

    __slots__ = ("arena", "ids")

    def __init__(self, arena: "AdapterArena", ids: torch.Tensor):
        self.arena = arena
        self.ids = ids


def lora_delta(x, a_pool, b_pool, ids):
    """The low-rank update of lanes ``x [S, t, in]``: each lane's rows of
    ``a_pool [cap+1, in, r]`` and ``b_pool [cap+1, r, out]`` gathered by
    ``ids [S]``, two batched products in float32 (``paddle_tpu/serving/
    adapters.py:128-132``). Returns ``[S, t, out]`` float32."""
    a = a_pool.index_select(0, ids)
    b = b_pool.index_select(0, ids)
    return torch.bmm(torch.bmm(x.float(), a), b)


def _lora_hook(layer, x, y):
    """``models.gpt._serving_linear``'s hook: ``y`` plus the bound lanes'
    update, cast once to ``y``'s dtype; ``y`` itself without a binding or
    for a linear the bound arena does not cover (a draft model's)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return y
    site = ctx.arena.site_of(layer)
    if site is None:
        return y
    a_pool, b_pool = ctx.arena.pools(site)
    return y + lora_delta(x, a_pool, b_pool, ctx.ids).to(y.dtype)


class AdapterArena:
    """The adapter store of one :class:`~.engine.ServingEngine`. ``rank`` and
    ``capacity`` are fixed for the engine's life (its captured programs
    hold the pools' shapes); which adapters are live and which slot wears
    which are data."""

    def __init__(self, model, rank: int, capacity: int):
        if rank < 1:
            raise ValueError("AdapterArena needs rank >= 1 "
                             "(FLAGS_serving_lora_rank)")
        if capacity < 1:
            raise ValueError("AdapterArena needs capacity >= 1 "
                             "(FLAGS_serving_lora_adapters)")
        self.rank = int(rank)
        self.capacity = int(capacity)
        device = model.gpt.wte.weight.device
        self._a: List[torch.Tensor] = []
        self._b: List[torch.Tensor] = []
        self._site_names: List[str] = []
        self._site_by_layer: Dict[int, int] = {}
        # per site: this rank's rows of A (a row-split linear) and columns
        # of B (a column-split one); None keeps the axis whole
        self._a_rows: List[Optional[Tuple[int, int]]] = []
        self._b_cols: List[Optional[np.ndarray]] = []
        for li, blk in enumerate(model.gpt.layers):
            for tgt, lin in (("attn.qkv", blk.attn.qkv),
                             ("attn.proj", blk.attn.proj),
                             ("mlp.up", blk.mlp.up),
                             ("mlp.down", blk.mlp.down)):
                fi, fo = (int(d) for d in lin.weight.shape)  # [in, out]
                self._site_by_layer[id(lin)] = len(self._site_names)
                self._site_names.append(f"{li}.{tgt}")
                split = bool(getattr(lin, "split", False))
                self._a_rows.append(getattr(lin, "rows", None)
                                    if split else None)
                self._b_cols.append(getattr(lin, "columns", None)
                                    if split else None)
                self._a.append(torch.zeros((capacity + 1, fi, rank),
                                           dtype=torch.float32,
                                           device=device))
                self._b.append(torch.zeros((capacity + 1, rank, fo),
                                           dtype=torch.float32,
                                           device=device))
        # LIFO over rows 1..capacity (row 0 is the identity, never handed
        # out), seeded descending so that ids come out 1, 2, ... in
        # registration order
        self._free: List[int] = list(range(capacity, 0, -1))
        self._live: Dict[int, str] = {}   # id -> name
        self._names: Dict[str, int] = {}  # name -> id
        self._fingerprints: Dict[int, bytes] = {}  # id -> weights digest
        self._engine = None  # the liveness guard and stream of unregister
        gpt_mod.set_lora_hook(_lora_hook)
        metrics.set_gauge("lora.slots", self.capacity)
        metrics.set_gauge("lora.live", 0)
        metrics.set_gauge("lora.arena_bytes", self.bytes_total())

    # ------------------------------------------------------------ the hook

    def site_of(self, layer) -> Optional[int]:
        return self._site_by_layer.get(id(layer))

    def pools(self, site: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._a[site], self._b[site]

    @contextlib.contextmanager
    def bind(self, ids: torch.Tensor):
        """Enter the binding for the model calls inside: each lane of a
        served linear's input gets the rows ``ids`` (an int64 tensor of one
        id per lane, on the pools' device) names. Per thread, so a
        background pump's capture and a caller's own model calls do not see
        each other's binding."""
        prev = getattr(_tls, "ctx", None)
        _tls.ctx = _Binding(self, ids)
        try:
            yield
        finally:
            _tls.ctx = prev

    # ----------------------------------------------------------- lifecycle

    def bind_engine(self, engine) -> None:
        """Adopt the owning engine: its occupied slots guard
        :meth:`unregister`, and its stream orders the pools' writes."""
        self._engine = engine

    @contextlib.contextmanager
    def _writing(self):
        """Context of a pool write: on the engine's stream once everything
        queued there has finished (the rows a replay in flight reads are
        never half-written), and with gradients off."""
        eng = self._engine
        with torch.no_grad(), (eng._graphs.on_stream() if eng is not None
                               else contextlib.nullcontext()):
            pool = self._a[0]
            if pool.is_cuda:
                torch.cuda.current_stream(pool.device).synchronize()
            yield

    def register(self, adapter: LoraAdapter,
                 name: Optional[str] = None) -> int:
        """Write ``adapter`` into a free row; returns its id, the value
        requests pass as ``adapter=``. Nothing is built again. Raises
        :class:`AdapterExhaustedError` at capacity and ``ValueError`` for a
        site the model does not have or a shape the arena does not hold
        (the row goes back to the free list)."""
        if not self._free:
            metrics.bump("lora.register_failed")
            raise AdapterExhaustedError(
                f"all {self.capacity} adapter rows are live; unregister "
                "one or raise FLAGS_serving_lora_adapters")
        name = name or adapter.name or f"adapter-{len(self._names)}"
        if name in self._names:
            raise ValueError(f"adapter name {name!r} already registered "
                             f"(id {self._names[name]})")
        known = set(self._site_names)
        for key in adapter.weights:
            if key not in known:
                raise ValueError(
                    f"adapter site {key!r} does not exist in this model "
                    f"(sites are '<layer>.<target>', targets {TARGETS})")
        local = [self._local(si, adapter.weights.get(site))
                 for si, site in enumerate(self._site_names)]
        for si, site in enumerate(self._site_names):
            ab = local[si]
            if ab is not None and (
                    ab[0].shape != tuple(self._a[si].shape[1:])
                    or ab[1].shape != tuple(self._b[si].shape[1:])):
                raise ValueError(
                    f"adapter site {site!r} shapes {ab[0].shape}/"
                    f"{ab[1].shape} do not match arena "
                    f"{tuple(self._a[si].shape[1:])}/"
                    f"{tuple(self._b[si].shape[1:])} (rank {self.rank})")
        idx = self._free.pop()
        self._fingerprints[idx] = self._digest(adapter)
        scale = adapter.alpha / self.rank
        with self._writing():
            for si, site in enumerate(self._site_names):
                ab = local[si]
                if ab is None:
                    self._a[si][idx].zero_()
                    self._b[si][idx].zero_()
                    continue
                # B scaled in numpy float32, as the JAX arena scales it
                self._a[si][idx].copy_(torch.from_numpy(ab[0]))
                self._b[si][idx].copy_(torch.from_numpy(
                    np.ascontiguousarray(ab[1] * scale, np.float32)))
        self._live[idx] = name
        self._names[name] = idx
        metrics.bump("lora.registered")
        metrics.set_gauge("lora.live", len(self._live))
        self._mirror("register", adapter, name)
        return idx

    def _local(self, si: int, ab):
        """Site ``si``'s ``(A, B)`` as this rank holds them: A's rows of a
        row-split linear, B's columns of a column-split one."""
        if ab is None:
            return None
        a, b = ab
        if self._a_rows[si] is not None:
            lo, hi = self._a_rows[si]
            a = a[lo:hi]
        if self._b_cols[si] is not None:
            b = b[:, self._b_cols[si]]
        return np.ascontiguousarray(a), np.ascontiguousarray(b)

    def _mirror(self, op: str, *args) -> None:
        """Rank 0 of a mesh: the same registration on every follower."""
        leader = getattr(self._engine, "_tp", None)
        if leader is not None:
            leader.send("lora", op, *args)

    def unregister(self, adapter) -> None:
        """Free one row (by id or name): zero its matrices, so that a stale
        id decodes as the identity, and return it to the free list. Refused
        while an occupied slot wears it: zeroing it, or handing it to the
        next registrant, would change a live stream's weights."""
        idx = (self._names.get(adapter) if isinstance(adapter, str)
               else int(adapter))
        if idx is None or idx not in self._live:
            raise KeyError(f"adapter {adapter!r} is not registered")
        eng = self._engine
        if eng is not None:
            wearing = np.flatnonzero(eng._occupied & (eng._adapter == idx))
            if wearing.size:
                raise RuntimeError(
                    f"adapter {self._live[idx]!r} (id {idx}) is in use by "
                    f"slot(s) {wearing.tolist()}; retire those requests "
                    "before unregistering")
        name = self._live.pop(idx)
        del self._names[name]
        del self._fingerprints[idx]
        with self._writing():
            for a, b in zip(self._a, self._b):
                a[idx].zero_()
                b[idx].zero_()
        self._free.append(idx)
        metrics.bump("lora.unregistered")
        metrics.set_gauge("lora.live", len(self._live))
        self._mirror("unregister", idx)

    def _digest(self, adapter: LoraAdapter) -> bytes:
        """The fingerprint of what :meth:`register` writes: every site's A
        and B bytes (float32, before the ``alpha / rank`` fold) in site
        order, an absent site marked as the identity, then the rank and
        the alpha."""
        h = hashlib.blake2b(digest_size=16)
        for site in self._site_names:
            h.update(site.encode())
            ab = adapter.weights.get(site)
            if ab is None:
                h.update(b"\0identity")
                continue
            for m in ab:
                h.update(repr(m.shape).encode())
                h.update(np.ascontiguousarray(m, np.float32).tobytes())
        h.update(f"rank={self.rank};alpha={adapter.alpha!r}".encode())
        return h.digest()

    def fingerprint(self, adapter_id: int) -> bytes:
        """The weights fingerprint of live row ``adapter_id`` (the base
        model's row 0 has none: raises ``KeyError`` for it and for a row
        not registered)."""
        return self._fingerprints[int(adapter_id)]

    def check_live(self, adapter_id: int) -> None:
        """Admission-time check: a request naming an unregistered adapter
        fails at submit, not with the identity's output."""
        if int(adapter_id) == 0:
            return
        if int(adapter_id) not in self._live:
            raise ValueError(
                f"adapter id {adapter_id} is not registered "
                f"(live: {sorted(self._live)})")

    def adapter_id(self, name: str) -> int:
        return self._names[name]

    def live(self) -> Dict[int, str]:
        return dict(self._live)

    # --------------------------------------------------------------- stats

    def bytes_total(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self._a + self._b)

    def stats(self) -> dict:
        return {"lora.rank": self.rank,
                "lora.slots": self.capacity,
                "lora.live": len(self._live),
                "lora.free": len(self._free),
                "lora.arena_bytes": self.bytes_total(),
                "lora.names": dict(self._names)}
