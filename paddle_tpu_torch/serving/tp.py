"""Tensor-parallel serving: rank 0 drives, the other ranks follow.

This part has no JAX counterpart. The JAX engine is one controller over a
device mesh (``paddle_tpu/serving/engine.py:56-71``); the port runs one
process per rank on the model axis, each with its own shard of the weights
and of the KV arena (:mod:`paddle_tpu_torch.distributed.mesh`).

* **Rank 0** keeps ``ServingAPI``, the scheduler and every host decision:
  admission, deadlines, shedding, preemption, the prefix cache, the tiers,
  the block tables. Its engine holds a :class:`Leader`.
* **The followers** each hold a :class:`~.engine.ServingEngine` of their
  own over the same ``ServingConfig`` (their mesh is their rank's) and run
  :func:`follow`: they apply rank 0's operations to their own shards, in
  rank 0's order, and replay the same programs, so that the collectives
  inside those programs meet.
* Before each engine operation that touches device state, rank 0 sends
  that operation's host data over a control channel (a pipe to a process,
  a queue to a thread): each program run with its static buffers' values
  and the changed rows of its resident buffers (``"run"``, the program's
  definition -- its step function's name and buffer specs -- with its
  first run), a tier restore (``"restore"``: the keys and destination
  blocks; each rank restores its own rows from its own tier, after a
  ``"probe"`` that every rank holds them), a tier spill or write-through
  (``"tier"``), a rebuild, an adapter's registration, and ``"close"``.
  A copy-on-write is a program run like any other.
* **Start.** The engine, made on a mesh with ``model_parallel > 1`` in
  rank 0, starts the followers before it shards its own model. With
  ``launch="process"`` it writes the (already quantized) whole model, and
  a draft model, once to a file it owns (``torch.save``; each follower
  loads it with ``mmap=True``, as ``gateway.procpool`` does) and spawns one
  process per rank; ``close()`` removes the file. With ``launch="thread"``
  each follower is a thread with a deep copy of the whole model (tests on
  the CPU).
* **Failure.** A follower that dies, or fails an operation (it reports
  the error and stops), fails rank 0's next operation with
  :class:`FollowerDiedError`, a ``ServingDeviceError``: the pending
  requests fail through the supervisor's existing path (a rebuild on a
  mesh with a dead rank raises the same error, and the requests fail).
  Nothing waits without bound: the model group's collectives carry the
  mesh's timeout, and every control receive on rank 0 does too.
"""
from __future__ import annotations

import copy
import dataclasses
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
import weakref
from typing import List, Optional

import torch

from ..core import resilience
from ..distributed import collective

__all__ = ["Leader", "FollowerDiedError", "follow", "warm",
           "scale_digest"]

#: thread followers' tier stores, per rank, by rank 0's store: the
#: engines of one process that share rank 0's store share these too
_thread_stores: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class FollowerDiedError(resilience.ServingDeviceError):
    """A follower rank died or failed an operation: the mesh cannot run a
    program any more. Raised on rank 0 at its next operation."""


def warm(mesh, device: torch.device) -> None:
    """One all-reduce over the model group on ``device``, on every rank at
    construction: NCCL makes its communicator at the first collective,
    which must not land inside a CUDA-graph capture."""
    t = torch.zeros(1, dtype=torch.float32, device=device)
    collective.all_reduce(t, mesh.group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ channels


class _PipeEnd:
    """One end of a ``multiprocessing`` pipe: whole pickled messages."""

    def __init__(self, conn):
        self.conn = conn

    def send(self, blob: bytes) -> None:
        self.conn.send_bytes(blob)

    def recv(self, timeout: Optional[float] = None):
        if timeout is not None and not self.conn.poll(timeout):
            raise TimeoutError(f"no message within {timeout} s")
        return pickle.loads(self.conn.recv_bytes())

    def poll(self) -> bool:
        return self.conn.poll(0)

    def close(self) -> None:
        self.conn.close()


class _QueueEnd:
    """One end of a pair of queues (a thread follower)."""

    def __init__(self, inbox: queue.Queue, outbox: queue.Queue):
        self.inbox, self.outbox = inbox, outbox

    def send(self, blob: bytes) -> None:
        self.outbox.put(blob)

    def recv(self, timeout: Optional[float] = None):
        try:
            return pickle.loads(self.inbox.get(timeout=timeout))
        except queue.Empty:
            raise TimeoutError(f"no message within {timeout} s") from None

    def poll(self) -> bool:
        return not self.inbox.empty()

    def close(self) -> None:
        pass


class _Follower:
    """Rank 0's handle on one follower: its channel and its process or
    thread."""

    def __init__(self, rank: int, end, worker):
        self.rank = rank
        self.end = end
        self.worker = worker
        self.error: Optional[str] = None

    def alive(self) -> bool:
        return self.worker.is_alive()


# --------------------------------------------------------------- rank 0


class Leader:
    """Rank 0's side of a mesh of ``model_parallel > 1``: starts the
    followers over ``model`` (whole, quantized if the engine quantizes)
    and ``config``, and sends them every operation. The engine makes it
    before it shards its own model and connects the model group after."""

    def __init__(self, model, config, mesh, device: torch.device,
                 draft=None):
        self.mesh = mesh
        self.timeout = float(mesh.timeout)
        self._defined = set()
        self._weights_dir: Optional[str] = None
        self.followers: List[_Follower] = []
        self.closed = False
        mesh.open()
        conf = dataclasses.replace(config, mesh=None, draft_model=None,
                                   tier_store=None)
        if mesh.launch == "thread":
            self._start_threads(model, draft, conf, config, device)
        else:
            self._start_processes(model, draft, conf, device)

    def _start_threads(self, model, draft, conf, config, device) -> None:
        store = config.tier_store
        for rank in range(1, self.mesh.model_parallel):
            to_f, from_f = queue.Queue(), queue.Queue()
            own = None
            if store is not None:
                # each rank's rows in a host store of its own, sized as
                # rank 0's and shared as rank 0's is
                from .tiered import HostKVCache

                per_rank = _thread_stores.setdefault(store, {})
                own = per_rank.setdefault(rank, HostKVCache(
                    max_bytes=store.max_bytes, disk_dir=""))
            t = threading.Thread(
                target=_thread_main,
                args=(copy.deepcopy(model), copy.deepcopy(draft),
                      dataclasses.replace(conf, tier_store=own),
                      self.mesh.peer(rank), device,
                      _QueueEnd(to_f, from_f)),
                name=f"tp-follower-{rank}", daemon=True)
            t.start()
            self.followers.append(_Follower(rank, _QueueEnd(from_f, to_f),
                                            t))

    def _start_processes(self, model, draft, conf, device) -> None:
        from .gateway import worker

        self._weights_dir = tempfile.mkdtemp(prefix="paddle-tp-")
        path = os.path.join(self._weights_dir, "model.pt")
        torch.save({"model": model, "draft": draft}, path)
        payload = worker.encode_payload(conf, device, model_file=path)
        ctx = multiprocessing.get_context("spawn")
        for rank in range(1, self.mesh.model_parallel):
            mine, theirs = ctx.Pipe(duplex=True)
            index = self.mesh_device(rank, device)
            p = dict(payload, device={"type": device.type, "index": index})
            proc = ctx.Process(target=_process_main,
                               args=(p, self.mesh.peer(rank), theirs),
                               name=f"tp-follower-{rank}", daemon=True)
            proc.start()
            theirs.close()
            self.followers.append(_Follower(rank, _PipeEnd(mine), proc))

    def mesh_device(self, rank: int, device: torch.device):
        """The device index follower ``rank`` takes: one card per rank
        under NCCL (which refuses two ranks on one card), the engine's own
        card under gloo."""
        if device.type != "cuda":
            return None
        if self.mesh.backend == "nccl":
            return (device.index or 0) + rank
        return device.index

    # ------------------------------------------------------------ sends

    def check(self) -> None:
        """Raise :class:`FollowerDiedError` if a follower is dead or has
        reported a failure."""
        for f in self.followers:
            while f.error is None and f.end.poll():
                try:
                    msg = f.end.recv()
                except (EOFError, OSError):
                    f.error = "its channel closed (the process died)"
                    break
                if msg[0] == "error":
                    f.error = msg[1]
            if f.error is not None:
                raise FollowerDiedError(f"tensor-parallel rank {f.rank} "
                                        f"failed: {f.error}")
            if not f.alive():
                raise FollowerDiedError(f"tensor-parallel rank {f.rank} "
                                        "died")

    def send(self, *msg) -> None:
        """Send one operation to every follower (pickled once)."""
        if self.closed:
            raise FollowerDiedError("the mesh's followers are closed")
        self.check()
        blob = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        for f in self.followers:
            try:
                f.end.send(blob)
            except (OSError, ValueError) as e:
                raise FollowerDiedError(f"tensor-parallel rank {f.rank}'s "
                                        f"channel broke: {e}") from e

    def ask(self, *msg) -> list:
        """Send an operation that every follower answers; their answers,
        each within the mesh's timeout."""
        self.send(*msg)
        out = []
        for f in self.followers:
            deadline = time.monotonic() + self.timeout
            while True:
                try:
                    reply = f.end.recv(timeout=0.05)
                except TimeoutError:  # an OSError: caught before them
                    if not f.alive():
                        raise FollowerDiedError(
                            f"tensor-parallel rank {f.rank} died") from None
                    if time.monotonic() > deadline:
                        raise FollowerDiedError(
                            f"tensor-parallel rank {f.rank} did not answer "
                            f"{msg[0]!r} within {self.timeout} s") from None
                    continue
                except (EOFError, OSError) as e:
                    raise FollowerDiedError(f"tensor-parallel rank {f.rank}'s "
                                            f"channel closed: {e!r}") from e
                if reply[0] == "error":
                    f.error = reply[1]
                    raise FollowerDiedError(f"tensor-parallel rank {f.rank} "
                                            f"failed: {f.error}")
                out.append(reply[1])
                break
        return out

    def wait_ready(self) -> list:
        """Each follower's boot report, once its engine is built."""
        return self.ask("ready")

    def run(self, prog, values: dict) -> None:
        """Mirror one program run: its values, the changed rows of its
        resident buffers (read before the run flushes them) and, at its
        first run, its definition."""
        defn = None if prog.key in self._defined else prog.definition
        rows = {name: buf.dirty_rows() for name, buf in prog.resident.items()}
        self.send("run", prog.key, defn, values, rows)
        self._defined.add(prog.key)

    def probe(self, keys: List[bytes]) -> int:
        """How many leading ``keys`` every follower's tier holds."""
        if not keys:
            return 0
        return min(self.ask("probe", keys))

    def tier_op(self, kind: str, key: bytes, block: int) -> None:
        """Mirror a tier write (``"spill"`` or ``"write_through"``) of
        ``block`` under ``key``: each follower writes its own rows."""
        self.send("tier", kind, key, int(block))

    def stats(self) -> list:
        """Each follower's engine report (:func:`_report`)."""
        return self.ask("stats")

    def close(self) -> None:
        """Stop the followers (each within the mesh's timeout, then
        killed) and remove the weights file. Idempotent."""
        if self.closed:
            return
        self.closed = True
        blob = pickle.dumps(("close",))
        for f in self.followers:
            try:
                f.end.send(blob)
            except (OSError, ValueError):
                pass
        for f in self.followers:
            f.worker.join(self.timeout)
            if isinstance(f.worker, multiprocessing.process.BaseProcess):
                if f.worker.is_alive():
                    f.worker.kill()
                    f.worker.join(5.0)
                f.end.close()
        if self._weights_dir is not None:
            shutil.rmtree(self._weights_dir, ignore_errors=True)
            self._weights_dir = None


# ------------------------------------------------------------ followers


def _thread_main(model, draft, config, mesh, device, end) -> None:
    from .engine import ServingEngine

    try:
        engine = ServingEngine(model, dataclasses.replace(
            config, mesh=mesh, draft_model=draft), device=device)
    # analysis: allow(broad-except) -- a boot can fail anyhow; rank 0 must
    # get the error, not wait for a rank that never came up
    except Exception as e:
        end.send(pickle.dumps(("error", f"boot: {e!r}")))
        return
    follow(engine, end)


def _process_main(payload: dict, mesh, conn) -> None:
    from .engine import ServingEngine
    from .gateway import worker

    end = _PipeEnd(conn)
    try:
        device = worker._apply_runtime_config(payload)
        saved = torch.load(payload["model_file"], map_location="cpu",
                           mmap=True, weights_only=False)
        draft = saved["draft"]
        config = dataclasses.replace(
            worker.b64_loads(payload["config"]), mesh=mesh,
            draft_model=None if draft is None else draft.to(device))
        engine = ServingEngine(saved["model"].to(device), config,
                               device=device)
    # analysis: allow(broad-except) -- as in _thread_main
    except Exception as e:
        end.send(pickle.dumps(("error", f"boot: {e!r}")))
        return
    follow(engine, end)


def _report(engine) -> dict:
    """What a follower tells rank 0 of itself: its rank, device, launch
    counts, the bytes of its weights and of its arena, and its programs."""
    from ..ops import paged_attention
    from ..ops import sampling as sampling_ops

    model = engine._model
    return {"rank": engine.mesh.rank, "pid": os.getpid(),
            "device": str(engine.device),
            "launches": {**paged_attention.launches,
                         **sampling_ops.launches},
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in list(model.parameters())
                                + list(model.buffers())),
            "arena_bytes": engine.arena.bytes_total(),
            "local_heads": int(engine.arena.pools[0][0].shape[2]),
            "scale_digest": scale_digest(engine.arena),
            "programs": sorted(map(str, engine._graphs.programs)),
            "graphs": engine._graphs.graph_count(),
            "modules": sorted(m for m in __import__("sys").modules
                              if m == "jax" or m.startswith("jax.")
                              or m == "paddle_tpu"
                              or m.startswith("paddle_tpu."))}


def scale_digest(arena) -> Optional[str]:
    """A digest of an int8 arena's scale pools (every layer's) over its
    allocatable blocks, equal on every rank of a mesh; None for a
    full-precision arena. Scratch block 0 is left out: idle lanes and
    padded positions all write there, on the card in no fixed order, and
    nothing reads it."""
    if not arena.quantized:
        return None
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for entry in arena.pools:
        for t in entry[2:]:
            h.update(t[1:].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def follow(engine, end) -> None:
    """A follower's loop: apply rank 0's operations to ``engine`` in order
    until ``"close"`` or the channel's end. A failed operation is reported
    and ends the loop (rank 0's next operation raises)."""
    from ..ops import paged_attention
    from ..ops import sampling as sampling_ops

    try:
        while True:
            try:
                msg = end.recv()
            except (EOFError, OSError):
                return  # rank 0 went away
            op = msg[0]
            if op == "close":
                return
            try:
                if op == "run":
                    engine._follow_run(*msg[1:])
                elif op == "ready" or op == "stats":
                    end.send(pickle.dumps(("ok", _report(engine))))
                elif op == "reset_launches":
                    paged_attention.reset_launches()
                    sampling_ops.reset_launches()
                elif op == "probe":
                    end.send(pickle.dumps(("ok", engine._tier_held(msg[1]))))
                elif op == "restore":
                    engine._follow_restore(msg[1], msg[2])
                elif op == "tier":
                    kind, key, blk = msg[1:]
                    getattr(engine.tier, kind)(
                        key, lambda b=blk: engine.arena.read_block(b))
                elif op == "rebuild":
                    engine.rebuild()
                elif op == "lora":
                    getattr(engine.lora, msg[1])(*msg[2:])
                else:
                    raise ValueError(f"unknown operation {op!r}")
            # analysis: allow(broad-except) -- reported to rank 0, whose
            # next operation fails; this rank stops
            except Exception as e:
                end.send(pickle.dumps(("error", f"{op}: {e!r}")))
                return
    finally:
        engine.close()
