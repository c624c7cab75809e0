"""The meshes of the port: the serving mesh (counterpart of
``paddle_tpu/distributed/mesh.py:57 serving_mesh``, ``set_mesh`` /
``get_mesh`` / ``clear_mesh`` ``:84-100`` and ``axis_size``) and the
training mesh (``build_mesh`` ``:34``, ``HybridCommunicateGroup``
``:119-186``, ``init_hybrid_mesh`` ``:188``), below.

The JAX mesh is one controller over many devices: a ``("data", "model")``
array of devices, and XLA inserts the collectives. The port runs one
process per rank on the model axis, each holding its own shard of the
weights and of the KV arena, and a :class:`ServingMesh` is one rank's view
of that axis: its sizes, this process's rank, the model group, the group's
backend and whether the backend can be captured in a CUDA graph (NCCL can,
gloo cannot).

* The caller names the backend (``backend="nccl"`` or ``"gloo"``); the
  mesh never picks one by what it finds.
* ``serving_mesh(model_parallel)`` in the caller's process makes that
  process rank 0. The serving engine, built on the mesh with
  ``model_parallel > 1``, starts the other ranks (``launch="process"``:
  spawned processes on the engine's device, ``launch="thread"``: threads of
  this process, for tests on the CPU) and forms the group with them
  (:meth:`ServingMesh.open`). A follower holds :meth:`ServingMesh.peer`'s
  mesh of its own rank.
* ``data > 1`` raises ``NotImplementedError``: the JAX data axis shards
  the slot batch inside one engine, which the port does not do yet
  (``ROADMAP.md`` §1).

A group is built on a store of the mesh's own (:func:`.collective.
new_group`), a ``TCPStore`` on the loopback for processes and a
``HashStore`` for threads, with a timeout that bounds every collective.
"""
from __future__ import annotations

import datetime
import math
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from . import collective

__all__ = ["ServingMesh", "serving_mesh", "set_mesh", "get_mesh",
           "clear_mesh", "axis_size", "LAUNCHES", "HYBRID_AXES",
           "HybridMesh", "build_mesh", "init_hybrid_mesh",
           "HybridCommunicateGroup", "set_hybrid_mesh", "get_hybrid_mesh",
           "clear_hybrid_mesh"]

#: how the engine starts the ranks other than 0
LAUNCHES = ("process", "thread")

_global_mesh: Optional["ServingMesh"] = None
_global_lock = threading.Lock()


class ServingMesh:
    """One rank's view of a ``("data", "model")`` serving mesh.
    ``model_parallel`` ranks shard the attention and MLP weights, the
    vocabulary and the KV arena's heads; ``rank`` is this process's place
    on that axis. ``timeout`` (seconds) bounds every collective and every
    control receive of the ranks. The model group is formed by the engine
    (:meth:`open`, :meth:`peer`, :meth:`connect`)."""

    def __init__(self, model_parallel: int = 1, data: int = 1, *,
                 backend: str, rank: int = 0, launch: str = "process",
                 timeout: float = 60.0):
        if int(data) != 1:
            raise NotImplementedError(
                f"serving_mesh(data={data}): the data axis (the slot batch "
                "sharded inside one engine) is not ported yet; see "
                "ROADMAP.md §1 (multi-GPU). Run data-parallel replicas "
                "behind the gateway instead")
        if int(model_parallel) < 1:
            raise ValueError(f"model_parallel must be >= 1, got "
                             f"{model_parallel}")
        if backend not in collective.BACKENDS:
            raise ValueError(f"name the mesh's backend: one of "
                             f"{collective.BACKENDS}, got {backend!r}")
        if launch not in LAUNCHES:
            raise ValueError(f"launch must be one of {LAUNCHES}, got "
                             f"{launch!r}")
        self.model_parallel = int(model_parallel)
        self.data = 1
        self.rank = int(rank)
        if not 0 <= self.rank < self.model_parallel:
            raise ValueError(f"rank {rank} is outside a model axis of "
                             f"{model_parallel}")
        self.backend = backend
        #: whether the model group's collectives can sit inside a captured
        #: CUDA graph: NCCL's can, gloo's cannot (the engine's programs then
        #: run uncaptured on the card)
        self.capturable = backend == "nccl"
        self.launch = launch
        self.timeout = float(timeout)
        self._group = None
        self._store = None
        self._addr: Optional[Tuple[str, int]] = None

    # ------------------------------------------------------------- shape

    @property
    def shape(self) -> dict:
        """Axis sizes, as the JAX ``Mesh.shape``."""
        return {"data": self.data, "model": self.model_parallel}

    @property
    def model_rank(self) -> int:
        """This process's place on the model axis (its rank)."""
        return self.rank

    # ------------------------------------------------------------- group

    @property
    def group(self):
        """The model group; raises until :meth:`connect` (or the engine's
        :meth:`open`) formed it."""
        if self._group is None:
            raise RuntimeError(f"rank {self.rank}'s model group is not "
                               "formed: the serving engine forms it")
        return self._group

    @property
    def connected(self) -> bool:
        return self._group is not None

    def open(self) -> None:
        """Rank 0: a fresh store for the next group (a new rendezvous per
        engine, so a mesh outlives the engines built on it). The peers are
        then made by :meth:`peer` and every rank calls :meth:`connect`."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 opens a mesh's rendezvous")
        self._group = None
        if self.model_parallel == 1 or self.launch == "thread":
            self._store, self._addr = dist.HashStore(), None
            return
        span = datetime.timedelta(seconds=self.timeout)
        self._store = dist.TCPStore("localhost", 0, self.model_parallel,
                                    True, timeout=span,
                                    wait_for_workers=False)
        self._addr = ("localhost", int(self._store.port))

    def peer(self, rank: int) -> "ServingMesh":
        """The mesh follower ``rank`` holds: this mesh's sizes, backend and
        timeout, its own rank, and the rendezvous (the store itself for a
        thread, the store's address for a process: a mesh pickles without
        its store and group)."""
        if self._store is None:
            raise RuntimeError("open() the mesh before making its peers")
        other = ServingMesh(self.model_parallel, backend=self.backend,
                            rank=rank, launch=self.launch,
                            timeout=self.timeout)
        other._store, other._addr = self._store, self._addr
        return other

    def connect(self) -> None:
        """Form this rank's model group (every rank calls it; the call
        returns once all have)."""
        if self._group is not None:
            return
        if self._store is None:
            if self._addr is None:
                raise RuntimeError("the mesh has no rendezvous: rank 0 "
                                   "open()s it and hands out peer() meshes")
            span = datetime.timedelta(seconds=self.timeout)
            self._store = dist.TCPStore(self._addr[0], self._addr[1],
                                        self.model_parallel, False,
                                        timeout=span)
        self._group = collective.new_group(self.backend, self._store,
                                           self.rank, self.model_parallel,
                                           self.timeout)

    def close(self) -> None:
        """Drop the group and the store (the engine's ``close``)."""
        self._group = None
        self._store = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_group"] = None
        state["_store"] = None
        return state

    def __repr__(self) -> str:
        return (f"ServingMesh(model={self.model_parallel}, rank={self.rank}, "
                f"backend={self.backend!r}, launch={self.launch!r})")


def serving_mesh(model_parallel: int, data: int = 1, *, backend: str,
                 launch: str = "process", timeout: float = 60.0,
                 install: bool = True) -> ServingMesh:
    """The serving topology: a ``("data", "model")`` mesh whose rank 0 is
    the calling process (``paddle_tpu/distributed/mesh.py:57``).
    ``install=True`` makes it the global mesh, which a serving engine built
    afterwards captures unless its ``ServingConfig.mesh`` names one."""
    mesh = ServingMesh(model_parallel, data, backend=backend, rank=0,
                       launch=launch, timeout=timeout)
    if install:
        set_mesh(mesh)
    return mesh


def set_mesh(mesh: Optional[ServingMesh]) -> None:
    global _global_mesh
    with _global_lock:
        _global_mesh = mesh


def get_mesh() -> Optional[ServingMesh]:
    return _global_mesh


def clear_mesh() -> None:
    """Uninstall the global mesh: engines built afterwards run without
    one."""
    set_mesh(None)


def axis_size(axis: str, mesh: Optional[ServingMesh] = None) -> int:
    """The size of ``axis`` on ``mesh`` (the installed one by default); 1
    for an axis the mesh lacks, or without a mesh."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return 1
    return mesh.shape.get(axis, 1)


# ------------------------------------------------------------ training mesh

#: the JAX package's axis order, outer to inner: ``model`` is innermost, so
#: a rank's coordinates are the digits of its number in these sizes
HYBRID_AXES = ("data", "pipe", "sharding", "sep", "expert", "model")
#: axes the port does not run yet (``ROADMAP.md`` §1 item 1i: the expert
#: axis is the JAX package's MoE axis)
_NOT_PORTED = ("expert",)

_hybrid = threading.local()


class HybridMesh:
    """One rank's view of a training mesh over ``HYBRID_AXES``.

    The JAX mesh is one controller over a device array and XLA inserts the
    collectives; here each rank (a process, or a thread in tests and on
    one card) holds this view: the axis sizes, its global ``rank``, its
    coordinates (``model`` innermost: rank = the digits of its coordinates
    in the axis sizes, JAX's ``devices.reshape(dims)`` order), and one
    process group per axis, over the ranks that differ from it only along
    that axis, plus a ``world`` group and, with a ``sep`` axis, a
    ``data_sep`` group (the ranks that differ only along ``data`` and
    ``sep``: those holding different tokens of the same parameters, over
    which losses are summed and gradients averaged; its rank is ``data *
    sep_size + sep``; without a sep axis it is the data group). Every
    group is built when the mesh is, on ``store`` (a ``HashStore`` for
    threads, a ``TCPStore`` across processes), in one fixed order on every
    rank; ``timeout`` (seconds) bounds every collective.

    For the tensor-parallel layers it reads as a serving mesh's model
    axis: ``model_parallel``, ``model_rank`` and ``group`` (the model
    group). ``expert`` above 1 raises ``NotImplementedError`` (MoE,
    ``ROADMAP.md`` §1 item 1i)."""

    def __init__(self, axis_dims: Dict[str, int], *, rank: int,
                 backend: str, store, timeout: float = 60.0):
        unknown = sorted(set(axis_dims) - set(HYBRID_AXES))
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the axes are "
                             f"{HYBRID_AXES}")
        dims = {a: int(axis_dims.get(a, 1)) for a in HYBRID_AXES}
        bad = {a: n for a, n in dims.items() if n < 1}
        if bad:
            raise ValueError(f"mesh axis sizes must be >= 1, got {bad}")
        _refuse_unported(dims)
        if backend not in collective.BACKENDS:
            raise ValueError(f"name the mesh's backend: one of "
                             f"{collective.BACKENDS}, got {backend!r}")
        self.dims = dims
        self.world_size = math.prod(dims.values())
        if not 0 <= int(rank) < self.world_size:
            raise ValueError(f"rank {rank} is outside a mesh of "
                             f"{self.world_size} ranks {dims}")
        self.rank = int(rank)
        digits = np.unravel_index(self.rank, [dims[a] for a in HYBRID_AXES])
        self.coords = {a: int(d) for a, d in zip(HYBRID_AXES, digits)}
        self.backend = backend
        self.timeout = float(timeout)
        self.world = collective.new_group(backend, store, self.rank,
                                          self.world_size, timeout,
                                          prefix="world/")
        self._groups = {}
        for axis in HYBRID_AXES:
            rest = "/".join(f"{a}{self.coords[a]}" for a in HYBRID_AXES
                            if a != axis)
            self._groups[axis] = collective.new_group(
                backend, store, self.coords[axis], dims[axis], timeout,
                prefix=f"{axis}/{rest}/")
        if dims["sep"] > 1:
            # without a sep axis the data group is this group
            rest = "/".join(f"{a}{self.coords[a]}" for a in HYBRID_AXES
                            if a not in ("data", "sep"))
            self._groups["data_sep"] = collective.new_group(
                backend, store, self.coords["data"] * dims["sep"]
                + self.coords["sep"], dims["data"] * dims["sep"], timeout,
                prefix=f"data_sep/{rest}/")

    @property
    def shape(self) -> dict:
        """Axis sizes, every axis of ``HYBRID_AXES``."""
        return dict(self.dims)

    def axis_size(self, axis: str) -> int:
        return self.dims[axis]

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def get_group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis`` (``"world"``: every rank; ``"data_sep"``: along
        ``data`` and ``sep``, the data group without a sep axis)."""
        if axis == "world":
            return self.world
        if axis == "data_sep" and axis not in self._groups:
            return self._groups["data"]
        return self._groups[axis]

    @property
    def model_parallel(self) -> int:
        return self.dims["model"]

    @property
    def model_rank(self) -> int:
        return self.coords["model"]

    @property
    def group(self):
        """The model group (the group a serving mesh names ``group``)."""
        return self._groups["model"]

    def close(self) -> None:
        """Shut the groups down, newest first (the same order on every
        rank), and drop them; the mesh runs no collective afterwards. Call
        it on the rank's own thread: an NCCL group destroyed elsewhere, or
        only at the interpreter's exit, takes the process down."""
        groups = [self.world, *self._groups.values()]
        self.world = None
        self._groups = {}
        for g in reversed(groups):
            if g is not None:
                g.shutdown()

    def __repr__(self) -> str:
        axes = {a: n for a, n in self.dims.items() if n > 1}
        return (f"HybridMesh({axes or {'data': 1}}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _refuse_unported(dims: Dict[str, int]) -> None:
    late = {a: int(dims.get(a, 1)) for a in _NOT_PORTED
            if int(dims.get(a, 1)) > 1}
    if late:
        raise NotImplementedError(
            f"mesh axes {late}: expert parallelism (MoE on the expert "
            "axis) is not ported yet; see ROADMAP.md §1 item 1i")


def _env_int(names, default):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def _world(world: Optional[int], rank: Optional[int]) -> Tuple:
    """The world size and rank: the arguments, else
    ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID`` (None / 0)."""
    world = int(world) if world is not None else _env_int(
        ("PADDLE_TRAINERS_NUM",), None)
    rank = int(rank) if rank is not None else _env_int(
        ("PADDLE_TRAINER_ID",), 0)
    return world, rank


def _backend_store(world: int, rank: int, backend: Optional[str], store,
                   timeout: float):
    """The backend and store of a mesh of ``world`` ranks: the arguments,
    else ``PADDLE_DISTRI_BACKEND`` and ``PADDLE_MASTER`` ("host:port", the
    ``TCPStore`` that rank 0 serves); a one-rank mesh makes its own
    ``HashStore``. The backend is never picked for the caller."""
    backend = backend or os.environ.get("PADDLE_DISTRI_BACKEND")
    if backend is None:
        raise ValueError("name the mesh's backend (backend='nccl' or "
                         "'gloo', or PADDLE_DISTRI_BACKEND)")
    if store is not None:
        return backend, store
    if world == 1:
        return backend, dist.HashStore()
    master = os.environ.get("PADDLE_MASTER")
    if not master:
        raise ValueError(f"a mesh of {world} ranks needs a store: pass "
                         "store= (a HashStore shared by thread ranks) or "
                         "set PADDLE_MASTER")
    host, port = master.rsplit(":", 1)
    return backend, dist.TCPStore(
        host, int(port), world, rank == 0,
        timeout=datetime.timedelta(seconds=float(timeout)))


def build_mesh(axis_dims: Dict[str, int], *, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               backend: Optional[str] = None, store=None,
               timeout: float = 60.0) -> HybridMesh:
    """This rank's view of a mesh of ``axis_dims`` (axis -> size, absent
    axes 1; ``paddle_tpu/distributed/mesh.py:34``). The sizes must
    multiply to the world size (when one is given or in the
    environment). Every rank calls it with its own ``rank``."""
    _refuse_unported(axis_dims)
    world, rank = _world(world_size, rank)
    total = math.prod(int(n) for n in axis_dims.values())
    if world is not None and total != world:
        raise ValueError(f"mesh axis dims {dict(axis_dims)} multiply to "
                         f"{total}, but the world has {world} ranks")
    backend, store = _backend_store(total, rank, backend, store, timeout)
    return HybridMesh(axis_dims, rank=rank, backend=backend, store=store,
                      timeout=timeout)


def init_hybrid_mesh(dp: int = 1, mp: int = 1, pp: int = 1,
                     sharding: int = 1, sep: int = 1, expert: int = 1, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     backend: Optional[str] = None, store=None,
                     timeout: float = 60.0) -> HybridMesh:
    """Build this rank's hybrid mesh and make it the calling thread's
    (``paddle_tpu/distributed/mesh.py:188``): when the degrees do
    not multiply to the world size and ``dp`` is 1, the data axis takes
    the rest of the world (the JAX auto-fill)."""
    _refuse_unported({"pipe": pp, "sep": sep, "expert": expert})
    world, rank = _world(world_size, rank)
    rest = mp * pp * sharding * sep * expert
    if world is not None and dp * rest != world:
        if dp == 1 and world % rest == 0:
            dp = world // rest
        else:
            raise ValueError(f"degrees {dp * rest} != world size {world}")
    backend, store = _backend_store(dp * rest, rank, backend, store, timeout)
    mesh = HybridMesh({"data": dp, "pipe": pp, "sharding": sharding,
                       "sep": sep, "expert": expert, "model": mp},
                      rank=rank, backend=backend, store=store,
                      timeout=timeout)
    set_hybrid_mesh(mesh)
    return mesh


def set_hybrid_mesh(mesh: Optional[HybridMesh]) -> None:
    """Make ``mesh`` the calling thread's training mesh (each rank thread
    holds its own; a process rank installs it on its main thread)."""
    _hybrid.mesh = mesh


def get_hybrid_mesh() -> Optional[HybridMesh]:
    """The calling thread's training mesh, or None."""
    return getattr(_hybrid, "mesh", None)


def clear_hybrid_mesh() -> None:
    set_hybrid_mesh(None)


class HybridCommunicateGroup:
    """The fleet topology queries over one rank's :class:`HybridMesh`
    (``paddle_tpu/distributed/mesh.py:119``): degrees from its sizes, ranks
    from its coordinates."""

    def __init__(self, mesh: HybridMesh):
        self._mesh = mesh
        self._shape = mesh.shape

    @property
    def mesh(self) -> HybridMesh:
        return self._mesh

    def get_parallel_mode(self) -> str:
        if self._shape["model"] > 1 or self._shape["pipe"] > 1:
            return "hybrid"
        if self._shape["sharding"] > 1:
            return "sharding_parallel"
        return "data_parallel"

    def get_data_parallel_world_size(self) -> int:
        return self._shape["data"]

    def get_model_parallel_world_size(self) -> int:
        return self._shape["model"]

    def get_pipe_parallel_world_size(self) -> int:
        return self._shape["pipe"]

    def get_sharding_parallel_world_size(self) -> int:
        return self._shape["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self._shape["sep"]

    def get_expert_parallel_world_size(self) -> int:
        return self._shape["expert"]

    def get_data_parallel_rank(self) -> int:
        return self._mesh.axis_rank("data")

    def get_model_parallel_rank(self) -> int:
        return self._mesh.axis_rank("model")

    def get_stage_id(self) -> int:
        return self._mesh.axis_rank("pipe")

    def get_sharding_parallel_rank(self) -> int:
        return self._mesh.axis_rank("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._mesh.axis_rank("sep")

    def topology(self) -> dict:
        return dict(self._shape)
