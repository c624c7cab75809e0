"""The worker process of the process replica pool (counterpart of
``paddle_tpu/serving/gateway/worker.py``).

One worker process owns one whole serving stack -- model, engine,
scheduler, supervisor, :class:`~..api.ServingAPI` -- on its device, and
serves it to the parent gateway over a loopback socket of length-prefixed
JSON frames. A segfault, an out-of-memory kill, a wedged call or a sticky
CUDA error ends one process and its CUDA context, never the gateway and the
other replicas.

Boot (driven by ``procpool.WorkerHandle.spawn``):

1. the parent binds a loopback listener and starts :func:`worker_main` in a
   process of the ``spawn`` start method (CUDA cannot fork);
2. the worker applies the parent's runtime configuration from the spawn
   payload before anything is built: the device (type and index; a CUDA
   worker without that card fails its boot with
   :class:`DeviceUnavailableError` and never falls back to the CPU), the
   TF32 switches of cuBLAS and cuDNN (token parity across a re-route
   depends on them), torch's CPU thread count and the flag snapshot;
3. it dials back, loads the model -- from the weights file the parent wrote
   once (``torch.load(mmap=True)``, then onto its device) or from a
   zero-argument factory shipped by reference -- builds the API and sends a
   ``hello`` frame with its pid, slots and vocabulary, or the typed boot
   error. The kernels come from the build directory on disk: a worker
   never runs ``nvcc`` on its boot clock when the parent built them;
4. the main thread serves the calls (``submit`` / ``poll`` / ``cancel`` /
   ``drain`` / ``stats`` / ``reset_launches`` / ``register_adapter`` /
   ``inject_fault`` / ``hang`` / ``shutdown``) while a heartbeat thread
   pushes a frame every ``FLAGS_gateway_heartbeat_interval`` seconds with
   the outstanding count, the crash-loop breaker and the telemetry spans
   recorded since the last frame (:func:`~..telemetry.events_since`; the
   parent ingests them, so one trace reads as one timeline across
   processes).

A :class:`~paddle_tpu_torch.core.resilience.PreemptionGuard` turns SIGTERM
into a drain. An EOF from the parent (closed or dead) tears the engine
down and ends the process. A step error that is a sticky CUDA error
(:func:`is_sticky_device_error`: any CUDA error but
``torch.OutOfMemoryError``) fails the requests it reached, as an in-process
replica does; the worker then refuses new submissions with the retriable
``RequestDrainedError``, lets the parent collect those failures, and exits
with :data:`STICKY_EXIT`, so that the parent re-routes its other streams and
respawns it on a fresh context.

Wire format: a 4-byte big-endian length, then UTF-8 JSON, at most
:data:`_MAX_FRAME` bytes (a malformed frame is a :class:`FrameError`: the
parent ejects the worker with ``WorkerProtocolError``). A request frame
carries ``id``; its answer echoes it with ``ok`` and a payload or a typed
``error`` (:func:`encode_error` / :func:`decode_error` keep the serving
error taxonomy across the boundary). Sampling parameters travel as dicts,
constraint walkers and adapters as base64 pickle: the channel is a
loopback socket between a parent and the worker it spawned from the same
tree.
"""
from __future__ import annotations

import base64
import json
import os
import pickle
import socket
import struct
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import flags, resilience
from .. import metrics, telemetry
from ..supervisor import CrashLoopError

#: the cap on one frame: a submit carries a prompt and a journal, a poll's
#: answer a few token tails and spans; a garbage length prefix fails at once
#: instead of waiting for gigabytes that never come
_MAX_FRAME = 8 << 20

#: the exit code of a worker whose CUDA context a sticky error poisoned
STICKY_EXIT = 86

_SHUTDOWN = object()  # a handler asks the serve loop to end


class FrameError(ValueError):
    """The byte stream is not a well-formed frame: cut short, an oversized
    or zero length prefix, or a payload that is not a JSON object. The
    connection cannot be resynchronised past one of these."""


class DeviceUnavailableError(RuntimeError):
    """The worker's payload names a CUDA device this process cannot take
    (no CUDA, or no card of that index): the boot fails, and the worker
    never runs on another device instead."""


# ------------------------------------------------------------------ framing


def send_frame(sock: socket.socket, obj: dict,
               lock: Optional[threading.Lock] = None) -> None:
    """Write ``obj`` as one length-prefixed frame. ``lock`` orders writers
    (answers and heartbeats share the worker's socket), so frames never
    interleave."""
    data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(data) > _MAX_FRAME:
        raise FrameError(f"frame of {len(data)} bytes exceeds the "
                         f"{_MAX_FRAME}-byte cap")
    frame = struct.pack(">I", len(data)) + data
    if lock is None:
        sock.sendall(frame)
    else:
        with lock:
            sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes, or None at a clean EOF on a frame boundary; an EOF
    inside the read is a :class:`FrameError`."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise FrameError(
                    f"truncated frame: EOF after {len(buf)}/{n} bytes")
            return None
        buf += chunk
    return buf


def recv_frame(sock: socket.socket,
               max_frame: int = _MAX_FRAME) -> Optional[dict]:
    """One frame as a dict, or None at a clean EOF. Raises
    :class:`FrameError` for a cut frame, an oversized or zero length
    prefix, or a payload that is not a JSON object."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack(">I", head)
    if length == 0 or length > max_frame:
        raise FrameError(f"bad frame length {length} "
                         f"(cap {max_frame} bytes)")
    body = _recv_exact(sock, length)
    if body is None:
        raise FrameError("truncated frame: EOF before payload")
    try:
        msg = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"unparseable frame payload: {e}") from e
    if not isinstance(msg, dict):
        raise FrameError(f"frame payload is {type(msg).__name__}, "
                         "expected an object")
    return msg


# ------------------------------------------------------- error round-trip

#: the serving errors that keep their meaning across the boundary: the shed
#: classes stay "try the next replica" in ``ReplicaPool._route``, the
#: transient ones re-routable in ``_is_reroutable``, validation a client
#: error. Any other type decodes as RuntimeError, which is not re-routable:
#: an unknown worker failure fails its request instead of bouncing on
_ERROR_TYPES: Dict[str, type] = {
    "QueueOverloadError": resilience.QueueOverloadError,
    "RequestDrainedError": resilience.RequestDrainedError,
    "DeadlineExceededError": resilience.DeadlineExceededError,
    "ServingDeviceError": resilience.ServingDeviceError,
    "ArenaCorruptError": resilience.ArenaCorruptError,
    "CrashLoopError": CrashLoopError,
    "DeviceUnavailableError": DeviceUnavailableError,
    "ValueError": ValueError,
    "KeyError": KeyError,
    "RuntimeError": RuntimeError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
}


def encode_error(exc: BaseException) -> dict:
    return {"type": type(exc).__name__, "message": str(exc)}


def decode_error(obj: Any) -> BaseException:
    if not isinstance(obj, dict):
        return RuntimeError(f"worker error (malformed): {obj!r}")
    name = str(obj.get("type", "RuntimeError"))
    message = str(obj.get("message", ""))
    klass = _ERROR_TYPES.get(name, RuntimeError)
    try:
        return klass(f"{message} [worker {name}]"
                     if klass is RuntimeError and name != "RuntimeError"
                     else message)
    except TypeError:
        return RuntimeError(f"{name}: {message}")


def is_sticky_device_error(exc: BaseException) -> bool:
    """True for a CUDA error that poisons the process's context for good
    (an illegal address, a failed launch): every CUDA error but
    ``torch.OutOfMemoryError``, which is transient."""
    if isinstance(exc, torch.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def b64_dumps(obj: Any) -> str:
    return base64.b64encode(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)).decode("ascii")


def b64_loads(data: str) -> Any:
    # a trusted channel: spawn arguments and a loopback socket between this
    # process and the worker it spawned from the same tree
    return pickle.loads(base64.b64decode(data))


# ------------------------------------------------------------ spawn payload


def encode_payload(config, device: torch.device, *, model_file=None,
                   factory=None, max_queue: Optional[int] = None,
                   hb_interval: Optional[float] = None) -> dict:
    """The spawn arguments :func:`worker_main` boots from, a few kilobytes:
    where the model comes from (the path of the weights file the parent
    wrote, or a zero-argument factory pickled by reference), the
    replicas' ``ServingConfig`` and queue bound, and the parent's runtime
    configuration (:func:`_apply_runtime_config`)."""
    if (model_file is None) == (factory is None):
        raise ValueError("a worker boots from a weights file or a factory")
    return {
        "model_file": model_file,
        "factory": None if factory is None else b64_dumps(factory),
        "config": b64_dumps(config),
        "max_queue": max_queue,
        "device": {"type": device.type, "index": device.index},
        "tf32_matmul": bool(torch.backends.cuda.matmul.allow_tf32),
        "tf32_cudnn": bool(torch.backends.cudnn.allow_tf32),
        # six test workers each spawning two: one thread a CPU worker
        "threads": (1 if device.type == "cpu"
                    else int(torch.get_num_threads())),
        "flags": flags.all_flags(),
        "hb_interval": hb_interval,
    }


def _apply_runtime_config(payload: dict) -> torch.device:
    """Pin the worker's runtime to the parent's before the model is built:
    the TF32 switches, the CPU thread count, the flags, and the device,
    which a CUDA worker must be able to take (else
    :class:`DeviceUnavailableError`)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(payload["tf32_matmul"])
    torch.backends.cudnn.allow_tf32 = bool(payload["tf32_cudnn"])
    torch.set_num_threads(max(1, int(payload["threads"])))
    for name, value in (payload.get("flags") or {}).items():
        try:
            flags.set_flags({name: value})
        except (KeyError, TypeError, ValueError):
            continue  # a flag this tree does not know: skip it
    spec = payload["device"]
    if spec["type"] == "cpu":
        return torch.device("cpu")
    index = 0 if spec["index"] is None else int(spec["index"])
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise DeviceUnavailableError(
            f"this worker process cannot take cuda:{index} (CUDA "
            f"{'available' if torch.cuda.is_available() else 'unavailable'}"
            f", {torch.cuda.device_count()} devices); it does not fall "
            "back to the CPU")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _load_model(payload: dict, device: torch.device):
    path = payload.get("model_file")
    if path:
        model = torch.load(path, map_location="cpu", mmap=True,
                           weights_only=False)
    else:
        model = b64_loads(payload["factory"])()
    return model.to(device)


def _build_api(payload: dict, device: torch.device):
    from ..api import ServingAPI

    model = _load_model(payload, device)
    return ServingAPI(model, b64_loads(payload["config"]), device=device,
                      max_queue=payload.get("max_queue"), background=True)


# -------------------------------------------------------------- the server


class _WorkerServer:
    """One worker's call loop and heartbeat pusher over one socket.

    Calls are handled on the main thread alone, so ``reqs`` takes no lock;
    the write lock orders answers against heartbeats. ``hung`` is the
    ``worker_hang`` fault: heartbeats stop and frames go unanswered while
    the socket stays open, so that the parent must classify it by
    heartbeat age, not by a reset."""

    def __init__(self, idx: int, sock: socket.socket,
                 wlock: threading.Lock, api, hb_interval: float):
        self.idx = int(idx)
        self.sock = sock
        self.wlock = wlock
        self.api = api
        self.hb_interval = float(hb_interval)
        self.reqs: Dict[str, Any] = {}  # rid -> scheduler.Request
        self.stop = threading.Event()
        self.hung = False
        #: the sticky CUDA error that poisoned this process's context
        self.sticky: Optional[BaseException] = None
        self._span_lock = threading.Lock()
        self._span_seq = -1
        api.scheduler.on_error = self._on_error

    def send(self, obj: dict) -> None:
        send_frame(self.sock, obj, self.wlock)

    def take_spans(self):
        """Spans recorded since the last frame that carried some (the
        heartbeat and the poll answer both do; each span ships once)."""
        with self._span_lock:
            events = telemetry.events_since(self._span_seq)
            if events:
                self._span_seq = max(e[0] for e in events)
        return events

    # ------------------------------------------------------ sticky errors

    def _on_error(self, exc: BaseException) -> None:
        """A request failure a step caused (the scheduler calls it on the
        pump thread, after failing the requests the error reached). A
        sticky CUDA error ends the process: once the parent has collected
        the failed requests (or a grace of ten heartbeats, at least 2 s,
        has passed), the worker exits with :data:`STICKY_EXIT` without
        touching the device again."""
        if self.sticky is not None or not is_sticky_device_error(exc):
            return
        self.sticky = exc
        resilience.bump("worker.sticky_errors")
        threading.Thread(target=self._exit_when_collected,
                         name=f"worker-{self.idx}-sticky-exit",
                         daemon=True).start()

    def _exit_when_collected(self) -> None:
        deadline = time.monotonic() + max(2.0, 10 * self.hb_interval)
        while self.reqs and time.monotonic() < deadline:
            time.sleep(0.005)
        with self.wlock:  # no frame is cut in half by the exit
            try:
                self.sock.close()
            except OSError:
                pass
            os._exit(STICKY_EXIT)

    # ------------------------------------------------------------- threads

    def heartbeat_loop(self) -> None:
        while not self.stop.wait(self.hb_interval):
            if self.hung:
                continue
            try:
                self.send({"hb": True, "ts": time.time(),
                           "pid": os.getpid(),
                           "outstanding": self.api.outstanding(),
                           "breaker_open":
                               bool(self.api.supervisor.breaker_open),
                           "spans": self.take_spans()})
            except OSError:
                return  # the parent went away; the main loop sees EOF too

    def serve(self) -> None:
        hb = threading.Thread(target=self.heartbeat_loop,
                              name=f"worker-{self.idx}-hb", daemon=True)
        hb.start()
        try:
            while True:
                try:
                    msg = recv_frame(self.sock)
                except (FrameError, OSError):
                    break  # a corrupt stream or a dead parent
                if msg is None:
                    break  # a clean EOF: the parent closed (or died)
                if self.hung:
                    continue  # wedged: read and never answer
                cid = msg.get("id")
                try:
                    result = self.handle(msg)
                # analysis: allow(broad-except) -- the call contract: any
                # handler failure goes back as a typed error frame; an
                # unanswered call would hold the parent until its deadline
                except Exception as e:
                    if cid is not None:
                        self.send({"id": cid, "ok": False,
                                   "error": encode_error(e)})
                    continue
                if result is _SHUTDOWN:
                    if cid is not None:
                        self.send({"id": cid, "ok": True})
                    break
                if cid is not None:
                    self.send({"id": cid, "ok": True, **result})
        finally:
            self.stop.set()
            try:
                self.api.close()
            # analysis: allow(broad-except) -- the exit path: a dying
            # engine must not keep the process alive
            except Exception:
                pass
            try:
                self.sock.close()
            except OSError:
                pass

    # ------------------------------------------------------------ handlers

    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise ValueError(f"unknown worker op: {op!r}")
        return handler(msg)

    def _op_submit(self, msg: dict) -> dict:
        from ..sampling import SamplingParams

        if self.sticky is not None:
            # retriable: the router tries the next replica
            raise resilience.RequestDrainedError(
                f"worker {self.idx}'s CUDA context is poisoned "
                f"({self.sticky}); it exits for a respawn")
        rid = str(msg["rid"])
        sampling = msg.get("sampling")
        if sampling is not None:
            sampling = SamplingParams(**sampling)
        constraint = msg.get("constraint")
        if constraint is not None:
            constraint = b64_loads(constraint)
        req = self.api.submit(
            np.asarray(msg["prompt"], np.int64),
            max_new_tokens=int(msg.get("max_new_tokens", 32)),
            stop_token_id=msg.get("stop_token_id"),
            timeout=msg.get("timeout"),
            request_id=str(msg.get("request_id", "")),
            priority=int(msg.get("priority", 0)),
            journal=msg.get("journal"),
            shed=bool(msg.get("shed", True)),
            sampling=sampling, constraint=constraint,
            adapter=int(msg.get("adapter", 0)),
            trace_id=str(msg.get("trace_id", "")))
        self.reqs[rid] = req
        return {"rid": rid}

    def _op_poll(self, msg: dict) -> dict:
        # acknowledged reap: a finished request is dropped only when the
        # parent's next poll lists it in ``done`` (it applied the terminal
        # state). Dropping it on send would lose the terminal entry when
        # the answer outlives the parent's poll deadline; acks are
        # idempotent, and a lost one ships the entry again
        for rid in (msg.get("done") or ()):
            self.reqs.pop(str(rid), None)
        out = {}
        for rid, offset in (msg.get("reqs") or {}).items():
            req = self.reqs.get(rid)
            if req is None:
                continue  # acknowledged earlier, or never submitted
            entry = {"state": req.state,
                     "tokens": [int(t) for t in req.tokens[int(offset):]]}
            if req.finished and req.error is not None:
                entry["error"] = encode_error(req.error)
            out[rid] = entry
        return {"reqs": out, "spans": self.take_spans(),
                "breaker_open": bool(self.api.supervisor.breaker_open),
                "outstanding": self.api.outstanding()}

    def _op_cancel(self, msg: dict) -> dict:
        req = self.reqs.get(str(msg.get("rid")))
        if req is not None:
            req.cancel()
        return {}

    def _op_drain(self, msg: dict) -> dict:
        # blocks up to the grace; heartbeats go on from their own thread, so
        # the watchdog never takes a draining worker for a hung one
        self.api.drain(float(msg.get("grace", 0.0)),
                       reason=str(msg.get("reason", "worker drain")))
        return {}

    def _op_stats(self, msg: dict) -> dict:
        # this PROCESS's counters, JSON scalars only: the serving metrics,
        # the build counters, what the engine ran and built, and the launch
        # counts of the kernels it went through
        from ...core import compile_cache
        from ...ops import paged_attention, sampling

        def scalars(d):
            return {k: v for k, v in d.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}

        eng = self.api.engine
        out = {"pid": os.getpid(),
               "outstanding": self.api.outstanding(),
               "breaker_open": bool(self.api.supervisor.breaker_open),
               "drain_count": int(self.api.drain_count),
               "metrics": scalars(metrics.stats()),
               "compile": scalars(compile_cache.stats()),
               "engine": {"decode_steps": eng.decode_steps,
                          "prefills": eng.prefills,
                          "prefill_chunks": eng.prefill_chunks,
                          "suffix_prefills": eng.suffix_prefills,
                          "decode_traces": eng.decode_traces,
                          "prefill_traces": sum(eng.prefill_traces.values()),
                          "prefix_prefill_traces":
                              sum(eng.prefix_prefill_traces.values())},
               "launches": {**paged_attention.launches,
                            **sampling.launches},
               "imports": sorted(m for m in ("jax", "paddle_tpu")
                                 if m in sys.modules)}
        if eng.device.type == "cuda":
            out["memory_allocated"] = int(
                torch.cuda.memory_allocated(eng.device))
        return out

    def _op_reset_launches(self, msg: dict) -> dict:
        from ...ops import paged_attention, sampling

        paged_attention.reset_launches()
        sampling.reset_launches()
        return {}

    def _op_register_adapter(self, msg: dict) -> dict:
        adapter = b64_loads(msg["adapter"])
        name = msg.get("name")
        return {"adapter_id":
                int(self.api.register_adapter(adapter, name=name))}

    def _op_inject_fault(self, msg: dict) -> dict:
        # arm a fault in this process's registry (FLAGS_fault_injection
        # must be on here, as in the parent's snapshot): the way a test
        # makes a step fail inside a worker
        err = msg.get("error")
        resilience.inject_fault(str(msg["kind"]),
                                times=int(msg.get("times", 1)),
                                after=int(msg.get("after", 0)),
                                exc=None if err is None
                                else decode_error(err))
        return {}

    def _op_hang(self, msg: dict) -> dict:
        # the worker_hang fault: stop heartbeating, swallow every later
        # frame, hold the socket
        self.hung = True
        return {}

    def _op_shutdown(self, msg: dict) -> dict:
        return _SHUTDOWN


# ------------------------------------------------------------------- main


def worker_main(host: str, port: int, idx: int, payload: dict) -> None:
    """The spawned process's entry: apply the runtime configuration, dial
    the parent, build the serving stack, say hello (or send the typed boot
    error), then serve calls until shutdown, EOF or a corrupt frame."""
    sock = socket.create_connection((str(host), int(port)), timeout=30.0)
    sock.settimeout(None)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    wlock = threading.Lock()
    try:
        device = _apply_runtime_config(payload)
        api = _build_api(payload, device)
    # analysis: allow(broad-except) -- a boot can fail anyhow (a device it
    # cannot take, a bad file, engine sizing): the parent needs the typed
    # error in the hello frame, not a bare exit code
    except Exception as e:
        try:
            send_frame(sock, {"hello": False, "pid": os.getpid(),
                              "error": encode_error(e)}, wlock)
        finally:
            sock.close()
        return
    guard = resilience.PreemptionGuard(install=True)
    api.bind_preemption_guard(guard)
    hb_interval = payload.get("hb_interval")
    if hb_interval is None:
        hb_interval = flags.flag("gateway_heartbeat_interval")
    send_frame(sock, {"hello": True, "pid": os.getpid(),
                      "num_slots": int(api.engine.num_slots),
                      "vocab": int(api.engine.vocab),
                      "device": str(device)}, wlock)
    _WorkerServer(idx, sock, wlock, api, float(hb_interval)).serve()
