"""The serving mesh of the port (counterpart of
``paddle_tpu/distributed/mesh.py:57 serving_mesh``, ``set_mesh`` /
``get_mesh`` / ``clear_mesh`` ``:84-100`` and ``axis_size``).

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
import threading
from typing import Optional, Tuple

import torch.distributed as dist

from . import collective

__all__ = ["ServingMesh", "serving_mesh", "set_mesh", "get_mesh",
           "clear_mesh", "axis_size", "LAUNCHES"]

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
