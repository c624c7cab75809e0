"""Step programs of the serving engine: the counterpart of the JAX engine's
``jax.jit`` sites (``paddle_tpu/serving/engine.py`` ``_get_step``,
``_get_prefill``, ``_get_prefix_prefill``).

One :class:`StepProgram` per key (the decode step, or one prefill bucket)
owns the key's static input buffers on the device and its step function.
Every piece of per-request state reaches the step as data in those
buffers, refilled in place before each run, so admit/retire churn never
builds a program again.

* On a CUDA device the first run of a key warms the step up once, eagerly,
  on the capture stream, with inputs that write only to scratch block 0 (the
  warm-up allocates what the kernels keep, such as the decode workspace,
  outside any capture), then captures it as a ``torch.cuda.CUDAGraph``.
  Every run, the first included, copies the host values into the static
  buffers from pinned staging (``non_blocking``) and replays the graph.
  All of an engine's graphs share one memory pool. A failed capture or
  replay raises: there is no eager route on the card.
* On the CPU the same step function runs eagerly over the same buffers,
  through the same bookkeeping. So does an engine on the card whose
  tensor-parallel mesh cannot be captured (``capture=False``: a gloo
  group), its host values staged through pinned memory as for a replay.

Every device call of an engine's programs -- staging copies, resident
flushes, replays, reads -- runs on the engine's own stream, the one current
where the engine was made (:meth:`StepGraphs.on_stream`), whichever thread
calls: PyTorch's current stream is per thread. Engines may each have their
own (a gateway pool makes each replica under a stream of its own), and
their replays then run side by side on the card. A graph bakes in the
workspaces its kernels keep per stream, sound only for launches in order
on one stream: cuBLAS's (one per stream it ran on) and the decode
kernel's. So an engine on a stream of its own warms up and captures on
that stream, and its graphs hold its own cuBLAS workspace; an engine on
the default stream, where no capture can run, warms up and captures on
one side stream for the process, whose workspace its graphs share with
every such engine's, all replaying in order on the default stream. A
program is built under ``paged_attention.workspace_stream`` of the
engine's stream, so the graph bakes in that stream's decode workspace
wherever its capture ran. A capture runs in ``"thread_local"`` error
mode, so that another thread's CUDA calls while a background pump
captures (the caller's own model calls, another replica's replays)
neither fail nor invalidate the capture; a capture stream is a
non-blocking pool stream, so such work never joins it. Warm-ups and
captures of every engine of the process take one lock
(:data:`_BUILD_LOCK`): engines may share the side stream, and each build
measures the launch counters it moved.

A :class:`ResidentBuffer` is a static buffer that a run does not refill:
the decode step's ``[S, vocab]`` constraint mask, of which a step changes a
few rows at most. The host keeps its mirror and marks the rows it changes;
each run of a program that holds it first copies those rows to the device,
on the stream the replay runs on, then replays. So a step copies the rows
that changed, never the whole mask.

Launch counters (``paged_attention.launches``) promise one count per kernel
launch. A capture launches nothing and a replay calls no Python, so the
program measures how far each counter moved while it captured, takes that
back out, and credits the same amount on every replay
(:class:`LaunchCredit`). The warm-up launches for real and counts as it is.
A credit takes the build lock too, so that another engine's capture never
measures it, and two replicas' credits never lose one another's.

A run's outputs live in the shared pool: another graph of the engine may
reuse their memory once it replays. :meth:`StepProgram.run` refuses to
start while an earlier run's outputs are unread, and :meth:`StepProgram.read`
refuses outputs that another run has overwritten. The read is a blocking
device-to-host copy; the next run's host writes into pinned staging
depend on it, since that copy is queued after the previous run's
host-to-device copies on the same stream.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["StepGraphs", "StepProgram", "LaunchCredit", "CudaGraphs",
           "ResidentBuffer"]

#: one process-wide lock around every engine's warm-up and capture, and
#: around every launch credit. The warm-ups and captures share the side
#: stream, and a capture measures how far the launch counters moved while
#: it ran, so no other engine may build, or credit a replay, meanwhile.
#: Replays themselves take no lock: replicas replay concurrently, each on
#: its own stream; only their counter bookkeeping is serialised
_BUILD_LOCK = threading.RLock()


class LaunchCredit:
    """Launch counters (dicts of name -> count) around a capture:
    :meth:`capture` measures how far they moved while the body ran and
    takes it back out (nothing launched); :meth:`replay` credits that
    movement once per replay."""

    def __init__(self, counters: Sequence[dict]):
        self._counters = tuple(counters)
        self.moved: Tuple[Dict[str, int], ...] = tuple({} for _ in
                                                      self._counters)

    def capture(self, body: Callable[[], object]):
        before = [dict(c) for c in self._counters]
        try:
            return body()
        finally:
            self.moved = tuple({k: c[k] - b.get(k, 0) for k in c
                                if c[k] != b.get(k, 0)}
                               for c, b in zip(self._counters, before))
            for c, moved in zip(self._counters, self.moved):
                for k, n in moved.items():
                    c[k] -= n

    def replay(self) -> None:
        with _BUILD_LOCK:
            for c, moved in zip(self._counters, self.moved):
                for k, n in moved.items():
                    c[k] += n


class CudaGraphs:
    """The CUDA side of an engine's programs: warm-up and capture into one
    shared graph pool, whose growth over the captures is ``pool_bytes``
    (the reserved bytes' increase, measured from an emptied cache).

    Warm-ups and captures run on the engine's ``stream`` when it is a
    stream of its own, else on ``torch.cuda.graph``'s capture stream, one
    side stream for the process: cuBLAS keeps a workspace per stream for
    good (32 MiB on an H100), and a graph replays with the one of the
    stream it was captured on, so the graphs of engines that replay side by
    side must be captured on streams of their own, while a fresh stream
    per warm-up would pin one workspace for each of PyTorch's 32 pooled
    streams. Warming up on the capture stream makes its workspace before
    the first capture. Engines of the process take turns
    (:data:`_BUILD_LOCK`, held by :meth:`StepProgram._build`)."""

    def __init__(self, device: torch.device, stream=None):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.pool_bytes = 0
        default = torch.cuda.default_stream(device)
        self._own = stream if stream is not None and stream != default \
            else None

    def _capture_stream(self):
        if self._own is not None:
            return self._own
        graph_ctx = torch.cuda.graph
        if graph_ctx.default_capture_stream is None:
            graph_ctx.default_capture_stream = torch.cuda.Stream(self.device)
        return graph_ctx.default_capture_stream

    def warmup(self, fn: Callable[[], object]) -> None:
        side = self._capture_stream()
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)

    def capture(self, fn: Callable[[], object]):
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              stream=self._capture_stream(),
                              capture_error_mode="thread_local"):
            out = fn()
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - before
        return graph, out

    def close(self) -> None:
        self.pool = None
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()


class ResidentBuffer:
    """A static buffer whose rows the host changes between runs: ``host``
    is its numpy mirror (the truth), ``tensor`` the device buffer the
    programs read. :meth:`set_row` changes a row of the mirror and marks it;
    :meth:`flush`, which every run of a program holding the buffer calls
    before its step, copies the marked rows to the device in order on the
    current stream -- through pinned staging on CUDA, so the copies are
    asynchronous and the replay after them reads the new rows. The staging
    rows are rewritten only at the next flush, after the previous run's
    outputs were read (a blocking copy that follows the earlier copies).
    ``attr`` names the attribute of its owner (the engine or its
    speculative decoder) that holds it: a tensor-parallel follower binds
    its own buffer of that name to a program rank 0 defines."""

    def __init__(self, device, shape: Tuple[int, ...], dtype: torch.dtype,
                 fill, attr: Optional[str] = None):
        self.attr = attr
        device = torch.device(device)
        self.tensor = torch.full(shape, fill, dtype=dtype, device=device)
        staging = torch.full(shape, fill, dtype=dtype,
                             pin_memory=device.type == "cuda")
        self._staging = staging if device.type == "cuda" else None
        self.host = (staging if device.type == "cuda"
                     else self.tensor).numpy().copy()
        self._dirty = set()

    def set_row(self, row: int, values) -> None:
        self.host[row] = values
        self._dirty.add(int(row))

    def dirty_rows(self):
        """The rows the next flush copies: ``(row ids, their values)``
        (what a tensor-parallel rank 0 sends its followers)."""
        rows = sorted(self._dirty)
        return rows, self.host[rows].copy()

    def fill_all(self, value) -> None:
        """Set every row of the mirror to ``value`` and mark them all, so
        the next flush writes the whole buffer."""
        self.host[...] = value
        self._dirty.update(range(self.host.shape[0]))

    def flush(self) -> None:
        for row in sorted(self._dirty):
            if self._staging is None:
                self.tensor[row] = torch.as_tensor(self.host[row])
            else:
                self._staging[row].numpy()[...] = self.host[row]
                self.tensor[row].copy_(self._staging[row], non_blocking=True)
        self._dirty.clear()


class StepProgram:
    """One key's program: its static input buffers, their host staging,
    the step function and, on CUDA, its captured graph. ``resident``
    buffers (name -> :class:`ResidentBuffer`) join the step's inputs but are
    not refilled by :meth:`run`; their marked rows are flushed before each
    run."""

    def __init__(self, owner: "StepGraphs", key, fn: Callable,
                 on_build: Callable[[], None], specs: Dict[str, tuple],
                 resident: Optional[Dict[str, ResidentBuffer]] = None,
                 site: str = "engine"):
        self.key = key
        self._owner, self._fn, self._on_build = owner, fn, on_build
        #: what the program was made from, as a tensor-parallel follower
        #: makes it again: the step function's site and name, the buffer
        #: specs and the resident buffers' attribute names
        self.definition = (site, fn.__name__, dict(specs),
                           {name: buf.attr
                            for name, buf in (resident or {}).items()})
        dev = owner.device
        self._warm = {name: (spec[2] if len(spec) > 2 else 0)
                      for name, spec in specs.items()}
        self.buffers = {name: torch.zeros(spec[0], dtype=spec[1], device=dev)
                        for name, spec in specs.items()}
        self._resident = dict(resident or {})
        # what the host writes: pinned staging on CUDA (copied into the
        # buffers before a replay, or before an uncaptured run), the
        # buffers themselves on the CPU
        pin = dev.type == "cuda"
        self._host = ({name: torch.zeros(spec[0], dtype=spec[1],
                                         pin_memory=pin)
                       for name, spec in specs.items()}
                      if pin else self.buffers)
        self._credit = LaunchCredit(owner.counters)
        self.graph = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.built = False

    def _build(self) -> None:
        from ..ops.paged_attention import workspace_stream

        backend = self._owner.backend
        if backend is not None:
            for name, buf in self.buffers.items():
                buf.fill_(self._warm[name])
            step = lambda: self._fn(**self.buffers,  # noqa: E731
                                    **self._inputs())
            # the graph replays on the engine's stream: the decode kernel's
            # kept workspace is that stream's, wherever the capture runs
            with _BUILD_LOCK, workspace_stream(self._owner.stream):
                backend.warmup(step)
                self.graph, self.outputs = self._credit.capture(
                    lambda: backend.capture(step))
        self.built = True
        self._on_build()

    @property
    def resident(self) -> Dict[str, ResidentBuffer]:
        return self._resident

    def _inputs(self) -> Dict[str, torch.Tensor]:
        return {name: res.tensor for name, res in self._resident.items()}

    def run(self, **values) -> Tuple[torch.Tensor, ...]:
        """Fill the static buffers with ``values`` (host arrays, by
        buffer name; every buffer must be given, the resident ones not),
        flush the resident buffers' marked rows, and run the step: replay
        its graph on CUDA (building it on the first run), the step function
        on the CPU. Returns the step's outputs, valid until another run of
        this engine; read them with :meth:`read`."""
        owner = self._owner
        owner.check_open()
        if owner.pending is not None:
            raise RuntimeError(f"step program {owner.pending.key!r}: its "
                               "outputs were not read before another run")
        if set(values) != set(self.buffers):
            raise ValueError(f"step program {self.key!r} takes "
                             f"{sorted(self.buffers)}, got {sorted(values)}")
        with owner.on_stream():
            if not self.built:
                self._build()
            for name, value in values.items():
                self._host[name].numpy()[...] = value
            for res in self._resident.values():
                res.flush()
            if self._host is not self.buffers:
                for name, buf in self.buffers.items():
                    buf.copy_(self._host[name], non_blocking=True)
            if self.graph is None:
                self.outputs = self._fn(**self.buffers, **self._inputs())
            else:
                self.graph.replay()
                self._credit.replay()
        owner.pending = self
        return self.outputs

    def read(self) -> Tuple[np.ndarray, ...]:
        """The last run's outputs on the host (one blocking device-to-host
        copy each); raises if another run has overwritten them."""
        if self._owner.pending is not self:
            raise RuntimeError(f"step program {self.key!r}: no unread run "
                               "(another run of the engine overwrote its "
                               "outputs, or it never ran)")
        with self._owner.on_stream():
            host = tuple(t.to("cpu", copy=True).numpy()
                         for t in self.outputs)
        self._owner.pending = None
        return host


class StepGraphs:
    """An engine's step programs, one per key, made on first use. On a CUDA
    device they are captured graphs sharing one pool (:class:`CudaGraphs`);
    on the CPU, eager runs. ``counters`` are the launch counters the
    captures must account (:class:`LaunchCredit`)."""

    def __init__(self, device, counters: Sequence[dict] = (),
                 backend: Optional[CudaGraphs] = None, capture: bool = True):
        self.device = torch.device(device)
        self.counters = tuple(counters)
        # the engine's one stream: the current stream of the thread that
        # made the engine (None on the CPU)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        if backend is None and capture and self.device.type == "cuda":
            backend = CudaGraphs(self.device, self.stream)
        self.backend = backend
        self.programs: Dict[object, StepProgram] = {}
        self.pending: Optional[StepProgram] = None
        self.closed = False

    def on_stream(self):
        """Context in which device work runs on the engine's stream,
        whichever thread enters it (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def check_open(self) -> None:
        if self.closed:
            raise RuntimeError("the engine's step programs are closed")

    def program(self, key, fn: Callable, on_build: Callable[[], None],
                resident: Optional[Dict[str, ResidentBuffer]] = None,
                site: str = "engine", **specs: tuple) -> StepProgram:
        """The program of ``key``, made on first use over static buffers
        ``specs`` (name -> ``(shape, dtype[, warm-up value])``; the warm-up
        value defaults to 0) and the ``resident`` buffers, which keep their
        contents through the warm-up. ``fn(**buffers)`` returns a tuple of
        output tensors; ``fn`` is a method of ``site`` (``"engine"`` or
        ``"spec"``, its speculative decoder). ``on_build`` runs once the
        program is built: after its capture on CUDA, at its first run on
        the CPU."""
        self.check_open()
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = StepProgram(self, key, fn, on_build,
                                                    specs, resident, site)
        return prog

    def graph_count(self) -> int:
        return sum(p.graph is not None for p in self.programs.values())

    @property
    def pool_bytes(self) -> int:
        return getattr(self.backend, "pool_bytes", 0)

    def close(self) -> None:
        """Drop every program, graph and buffer, then the pool; later runs
        raise. Idempotent."""
        if self.closed:
            return
        self.closed = True
        self.pending = None
        for prog in self.programs.values():
            if prog.graph is not None:
                prog.graph.reset()
            prog.graph = prog.outputs = None
            prog.buffers = prog._host = prog._resident = {}
        self.programs.clear()
        if self.backend is not None:
            self.backend.close()
