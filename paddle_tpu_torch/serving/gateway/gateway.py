"""HTTP/SSE streaming front door over a :class:`~.router.ReplicaPool`
(counterpart of ``paddle_tpu/serving/gateway/gateway.py``).

Stdlib only (``http.server``): a :class:`Gateway` binds a
``ThreadingHTTPServer`` whose handler threads are plain pool consumers; the
pool's replicas pump themselves on background threads, so a slow SSE
reader never stalls decoding.

Endpoints (JSON bodies and answers; token ids, not text: tokenization is
the client's contract with its model):

* ``POST /v1/submit`` -- ``{"prompt": [ids], "max_new_tokens",
  "stop_token_id", "tenant", "priority", "timeout", "request_id"}`` ->
  ``{"request_id": ...}``. Admission runs the tenant gates and the router
  here. Optional decode-scenario fields: ``temperature`` / ``top_k`` /
  ``top_p`` / ``seed`` make a ``SamplingParams`` (absent: the tenant's
  default, else greedy); ``adapter`` picks the adapter row (absent: the
  tenant's, 0: the base model); ``choices``, a list of token-id lists,
  constrains the output to one of them (a ``TrieConstraint``); ``grammar``,
  ``{"regex": ...}`` or ``{"json_schema": {...}}`` with a ``token_table``
  (token id -> string), compiles to a ``TokenDFA`` here. ``choices`` and
  ``grammar`` exclude each other.
* ``GET /v1/stream/<request_id>?offset=N`` -- Server-Sent Events: one
  ``data: {"token": t}`` event per generated token (re-routes are
  invisible: the journal keeps the stream token for token), then ``event:
  done`` with the final state, or ``event: error`` with the error taxonomy
  below. ``offset=N`` resumes after the first N tokens, with no duplicate
  and no gap across re-routes and, with the write-ahead log, across a
  restart of the gateway.
* ``POST /v1/stream`` -- submit and stream in one round trip (the main
  path; body as ``/v1/submit``).
* ``GET /v1/result/<request_id>?timeout=S`` -- block until the request
  ends; prompt + tokens.
* ``POST /v1/cancel/<request_id>`` -- flag the request; its slot frees at
  the next step boundary.
* ``GET /healthz`` -- readiness: ``{"status": "ok"|"recovering"|
  "draining"|"unhealthy", ...}``, 503 with ``Retry-After`` while the WAL
  replay runs, while draining or with no healthy replica (and the pool's
  ``wal`` map beside the status when it has a log).
* ``GET /livez`` -- liveness: 200 while the gateway is open (through a
  replay too), 503 once closed.
* ``GET /v1/stats`` -- the pool and tenant snapshot beside the
  process-global ``serving.metrics`` counters and the compile counters.
* ``GET /v1/metrics`` -- the same in the Prometheus text format
  (``telemetry.prometheus_text(pool=)``): every counter and gauge, the
  latency histograms pool-merged and per replica (``replica="<idx>"``),
  replica health and tenant goodput. A pure read of snapshots.
* ``GET /v1/trace/<request_id>`` -- one request's span timeline
  (``FLAGS_serving_telemetry``), by gateway request id or trace id.

Error taxonomy (retriable errors carry ``Retry-After``):
``QuotaExceededError`` -> 429 (with the gate's retry-after),
``QueueOverloadError`` -> 429, ``RequestDrainedError`` /
:class:`~.router.NoHealthyReplicaError` -> 503,
``DeadlineExceededError`` -> 504, :class:`DuplicateRequestError` (a
``request_id`` already in flight, one the WAL recovered among them) -> 409,
validation (``ValueError``, bad JSON) -> 400, an unknown id -> 404. With
the write-ahead log, a submit of an id whose stream ended before the
restart is no error: its cached result is the answer, with ``"cached":
true``, and ``/v1/result`` and ``/v1/stream`` answer such an id from the
cache too (exactly once: no second decode).

**Shutdown is a drain, not a kill**: :meth:`Gateway.install_preemption_guard`
binds a ``core.resilience.PreemptionGuard``, and SIGTERM becomes a
gateway-wide ``pool.drain(grace)``: new submissions get 503, streams in
flight finish within the grace, stragglers fail with the retriable
``RequestDrainedError``; then the HTTP server stops.
"""
from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ...core import flags, resilience
from .. import metrics, telemetry
from .router import NoHealthyReplicaError, ReplicaPool, RoutedRequest

_logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

#: completed requests kept findable by id (late /v1/stream attaches) before
#: the registry starts pruning finished entries
_REGISTRY_SOFT_CAP = 1024


class DuplicateRequestError(ValueError):
    """The client's ``request_id`` names a stream already in flight (maybe
    accepted by the previous incarnation and recovered from the WAL): 409.
    An id whose stream has ended may be used again; one that ended before
    a restart is answered from the result cache instead."""


def _status_for(exc: BaseException):
    """(http_status, retry_after_or_None) for the serving error taxonomy."""
    if isinstance(exc, resilience.QuotaExceededError):
        return 429, max(0.01, exc.retry_after)
    if isinstance(exc, resilience.QueueOverloadError):
        return 429, 0.5
    if isinstance(exc, (resilience.RequestDrainedError,
                        NoHealthyReplicaError)):
        return 503, 1.0
    if isinstance(exc, resilience.DeadlineExceededError):
        return 504, None
    if isinstance(exc, DuplicateRequestError):
        return 409, None  # before ValueError: a dup id is a conflict
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return 400, None
    return 500, None


class _Server(ThreadingHTTPServer):
    """The front door's listener. socketserver's listen backlog of 5 lets
    a burst of clients overflow the accept queue while the accept thread
    waits for the interpreter behind busy handler threads, and a connect
    past it can be reset or never complete; the system's own limit holds
    the burst until it is accepted."""

    daemon_threads = True
    request_queue_size = socket.SOMAXCONN


class Gateway:
    """One HTTP/SSE front door over one :class:`ReplicaPool`.

    ``port=0`` binds an ephemeral port (tests); default comes from
    ``FLAGS_gateway_port``. The pool should run ``background=True`` —
    handler threads only consume."""

    def __init__(self, pool: ReplicaPool, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.pool = pool
        port = int(flags.flag("gateway_port")) if port is None else int(port)
        handler = _make_handler(self)
        self._httpd = _Server((host, port), handler)
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None
        self._watcher: Optional[threading.Thread] = None
        self._guard = None
        self._guard_grace: Optional[float] = None
        self._lock = threading.Lock()
        self._requests = {}  # request_id -> RoutedRequest
        self._results = {}   # request_id -> WAL-recovered terminal result
        self._recovered_done = False  # set once the pool's replay settled
        self._closed = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Gateway":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gateway-http", daemon=True)
        self._thread.start()
        _logger.info("serving gateway listening on http://%s:%d",
                     self.host, self.port)
        return self

    def install_preemption_guard(self, guard=None,
                                 grace: Optional[float] = None) -> "Gateway":
        """Bind SIGTERM/SIGINT (default: a fresh installed
        :class:`core.resilience.PreemptionGuard`) to a gateway-wide drain:
        a watcher thread polls the guard and, once preemption is requested,
        drains the pool within ``grace`` (default
        ``FLAGS_serving_drain_grace``) and stops the HTTP server."""
        if guard is None:
            guard = resilience.PreemptionGuard()
        self._guard = guard
        self._guard_grace = grace
        self.pool.bind_preemption_guard(guard, grace)
        self._watcher = threading.Thread(target=self._watch_guard,
                                         name="gateway-guard", daemon=True)
        self._watcher.start()
        return self

    def _watch_guard(self) -> None:
        while not self._closed:
            g = self._guard
            if g is not None and g.requested():
                _logger.warning("preemption requested (%s): draining "
                                "gateway", g.reason or "signal")
                self.drain(self._guard_grace)
                return
            if self._closed:
                return
            threading.Event().wait(0.05)

    def drain(self, grace: Optional[float] = None) -> None:
        """Gateway-wide graceful shutdown: the pool drains every replica
        (in-flight streams finish within ``grace``), new submissions see
        503, then the HTTP listener stops."""
        self.pool.drain(grace)
        self._shutdown_http()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.pool.close()
        self._shutdown_http()

    def _shutdown_http(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass  # already closed / socket torn down by the peer
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------- requests

    def _sync_recovered(self) -> None:
        """Fold the pool's WAL-recovered state into the registry: the
        resubmitted streams join ``_requests`` (a duplicate id is refused,
        ``/v1/stream`` attaches across the restart), the replayed terminal
        results join the cache ``/v1/result`` answers from. Called from the
        lookups, idempotent, and syncing while the replay runs."""
        pool = self.pool
        if self._recovered_done or getattr(pool, "wal", None) is None:
            return
        done = not pool.recovering  # read before the pull: a flag cleared
        # after it could hide a late resubmission for good
        live = pool.recovered_live()
        results = pool.recovered_results()
        with self._lock:
            for rr in live:
                self._requests.setdefault(rr.request_id, rr)
            for rid, res in results.items():
                self._results.setdefault(rid, res)
            if done:
                self._recovered_done = True

    def _cached(self, request_id: str):
        """The WAL-recovered terminal result of ``request_id``, if any:
        what a client retrying across the crash gets instead of a second
        decode."""
        if not request_id:
            return None
        self._sync_recovered()
        with self._lock:
            return self._results.get(request_id)

    def _submit(self, body: dict) -> RoutedRequest:
        if "prompt" not in body:
            raise ValueError("body must carry 'prompt': [token ids]")
        rid = str(body.get("request_id", ""))
        if rid:
            self._sync_recovered()
            with self._lock:
                prev = self._requests.get(rid)
            if prev is not None and not prev.finished:
                # replacing the registry entry would leave the first
                # stream unreachable (and uncancellable) by id; across a
                # restart a retried id must attach to the recovered
                # stream, never start a second decode
                raise DuplicateRequestError(
                    f"request_id {rid!r} is already in flight; pick a "
                    f"unique id or omit it for a generated one")
        prompt = np.asarray(body["prompt"], np.int64).reshape(-1)
        sampling = None
        if any(k in body for k in ("temperature", "top_k", "top_p",
                                   "seed")):
            from ..sampling import SamplingParams

            # a client sending top_k/top_p/seed WITHOUT temperature is
            # asking to sample: default temperature 1.0 (neutral scale),
            # not 0 — temperature<=0 would silently ignore the truncation
            # and return greedy. Explicit temperature 0 still means greedy.
            # seed absent -> None: the router pins fresh entropy per
            # request (two unseeded clients must not share a stream)
            sampling = SamplingParams(
                temperature=float(body.get("temperature", 1.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                seed=(None if body.get("seed") is None
                      else int(body["seed"])))
        constraint = None
        if body.get("choices") is not None:
            from ..constrain import TrieConstraint

            stop = body.get("stop_token_id")
            constraint = TrieConstraint(
                [[int(t) for t in c] for c in body["choices"]],
                vocab_size=self.pool.vocab_size(),
                stop_token_id=None if stop is None else int(stop))
        if body.get("grammar") is not None:
            if constraint is not None:
                raise ValueError("pass either choices or grammar, "
                                 "not both")
            from ..constrain import TokenDFA

            g = body["grammar"]
            if not isinstance(g, dict):
                raise ValueError("grammar must be an object")
            table = g.get("token_table")
            if not isinstance(table, dict) or not table:
                raise ValueError("grammar.token_table (token id -> "
                                 "string) is required")
            token_table = {int(k): str(v) for k, v in table.items()}
            stop = g.get("stop_token_id", body.get("stop_token_id"))
            stop = None if stop is None else int(stop)
            if g.get("regex") is not None:
                constraint = TokenDFA.from_regex(
                    str(g["regex"]), token_table,
                    vocab_size=self.pool.vocab_size(),
                    stop_token_id=stop)
            elif g.get("json_schema") is not None:
                constraint = TokenDFA.from_json_schema(
                    g["json_schema"], token_table,
                    vocab_size=self.pool.vocab_size(),
                    stop_token_id=stop)
            else:
                raise ValueError(
                    'grammar needs a "regex" or "json_schema" key')
        # the constraint's client spec rides into the WAL: a recovered
        # stream builds the same walker from it (the automaton itself is
        # derived state, never journaled)
        constraint_spec = None
        if constraint is not None:
            constraint_spec = {"choices": body.get("choices"),
                               "grammar": body.get("grammar"),
                               "stop_token_id": body.get("stop_token_id")}
        rr = self.pool.submit(
            prompt,
            max_new_tokens=int(body.get("max_new_tokens", 32)),
            stop_token_id=(None if body.get("stop_token_id") is None
                           else int(body["stop_token_id"])),
            tenant=str(body.get("tenant", "default")),
            timeout=(None if body.get("timeout") is None
                     else float(body["timeout"])),
            request_id=str(body.get("request_id", "")),
            priority=(None if body.get("priority") is None
                      else int(body["priority"])),
            sampling=sampling, constraint=constraint,
            adapter=(None if body.get("adapter") is None
                     else int(body["adapter"])),
            constraint_spec=constraint_spec)
        # the commit barrier: the answer is the client's receipt, so the
        # ACCEPTED record is synced before it leaves (submit only buffers
        # it, and the pump's batched commit may lag by a sweep: the window
        # a SIGKILL would erase an acknowledged stream in). A sweep that
        # covered it already makes this commit a no-op, so a burst of
        # submits shares one sync
        wal = getattr(self.pool, "wal", None)
        if wal is not None:
            wal.commit()
        with self._lock:
            self._requests[rr.request_id] = rr
            if len(self._requests) > _REGISTRY_SOFT_CAP:
                for rid in [rid for rid, r in self._requests.items()
                            if r.finished][:len(self._requests) // 2]:
                    del self._requests[rid]
        metrics.bump("gateway.http_submits")
        return rr

    def _get(self, request_id: str) -> Optional[RoutedRequest]:
        self._sync_recovered()
        with self._lock:
            return self._requests.get(request_id)


def _make_handler(gw: Gateway):
    class _Handler(BaseHTTPRequestHandler):
        # HTTP/1.0 + Connection: close — SSE bodies are delimited by EOF,
        # so no chunked-encoding dance; fine for a loopback/LB front door
        protocol_version = "HTTP/1.0"
        # every SSE event is a small write: without TCP_NODELAY, Nagle's
        # algorithm holds one until the previous one is acknowledged
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # route to logging, not stderr
            _logger.debug("%s " + fmt, self.address_string(), *args)

        # ------------------------------------------------------- plumbing

        def _json(self, status: int, payload: dict,
                  retry_after=None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", f"{retry_after:.2f}")
            self.end_headers()
            self.wfile.write(body)

        def _error(self, exc: BaseException) -> None:
            status, retry = _status_for(exc)
            if status == 500:
                _logger.exception("gateway internal error")
            self._json(status, {"error": type(exc).__name__,
                                "message": str(exc),
                                "retriable": retry is not None},
                       retry_after=retry)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0) or 0)
            if n == 0:
                return {}
            try:
                return json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                raise ValueError(f"invalid JSON body: {e}") from e

        def _tail(self, prefix: str, parsed) -> str:
            """id from the path (`/v1/x/<id>`) or `?id=` query."""
            path = parsed.path
            if path.startswith(prefix) and len(path) > len(prefix):
                return path[len(prefix):].strip("/")
            q = parse_qs(parsed.query)
            return (q.get("id") or q.get("request_id") or [""])[0]

        # ------------------------------------------------------ endpoints

        def do_GET(self):
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/healthz":
                    return self._healthz()
                if parsed.path == "/livez":
                    return self._livez()
                if parsed.path == "/v1/stats":
                    return self._stats()
                if parsed.path == "/v1/metrics":
                    return self._metrics()
                if parsed.path.startswith("/v1/trace"):
                    return self._trace(self._tail("/v1/trace/", parsed))
                if parsed.path.startswith("/v1/stream"):
                    rid = self._tail("/v1/stream/", parsed)
                    q = parse_qs(parsed.query)
                    # ?offset=N: resume after N tokens (no duplicate,
                    # no gap across re-routes)
                    offset = max(0, int((q.get("offset") or [0])[0]))
                    rr = gw._get(rid)
                    if rr is None:
                        res = gw._cached(rid)
                        if res is not None:
                            return self._sse_cached(rid, res, offset)
                        return self._json(
                            404, {"error": "NotFound",
                                  "message": f"unknown request {rid!r}"})
                    return self._sse(rr, offset=offset)
                if parsed.path.startswith("/v1/result"):
                    rid = self._tail("/v1/result/", parsed)
                    rr = gw._get(rid)
                    if rr is None:
                        res = gw._cached(rid)
                        if res is not None:
                            # a terminal id of the previous incarnation:
                            # its tokens from the cache (the prompt died
                            # with that process)
                            return self._json(200, {
                                "request_id": rid, "state": res["state"],
                                "tokens": [int(t)
                                           for t in res["tokens"]],
                                "cached": True})
                        return self._json(
                            404, {"error": "NotFound",
                                  "message": f"unknown request {rid!r}"})
                    q = parse_qs(parsed.query)
                    timeout = float((q.get("timeout") or [30.0])[0])
                    try:
                        out = gw.pool.result(rr, timeout=timeout)
                    except RuntimeError as e:
                        if rr.state != "CANCELLED":
                            raise
                        # a client-driven cancel is a terminal STATE, not a
                        # server fault: report it as one instead of a 500
                        return self._json(200, {
                            "request_id": rr.request_id, "state": rr.state,
                            "tokens": [int(t) for t in rr.tokens()],
                            "message": str(e)})
                    return self._json(200, {
                        "request_id": rr.request_id, "state": rr.state,
                        "output_ids": [int(t) for t in out],
                        "tokens": [int(t) for t in rr.tokens()]})
                self._json(404, {"error": "NotFound",
                                 "message": self.path})
            # analysis: allow(broad-except) — THE taxonomy boundary:
            # every error maps to an HTTP status, never a stack dump
            except Exception as e:
                self._error(e)

        def do_POST(self):
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/v1/submit":
                    body = self._body()
                    res = gw._cached(str(body.get("request_id", "")))
                    if res is not None:
                        # a retry of an id that ended before the restart:
                        # the recovered result, never a second decode
                        return self._json(200, {
                            "request_id": str(body["request_id"]),
                            "state": res["state"],
                            "tokens": [int(t) for t in res["tokens"]],
                            "cached": True})
                    rr = gw._submit(body)
                    return self._json(200, {"request_id": rr.request_id,
                                            "tenant": rr.tenant,
                                            "state": rr.state})
                if parsed.path == "/v1/stream":
                    body = self._body()
                    res = gw._cached(str(body.get("request_id", "")))
                    if res is not None:
                        return self._sse_cached(str(body["request_id"]),
                                                res)
                    return self._sse(gw._submit(body))
                if parsed.path.startswith("/v1/cancel"):
                    rid = (self._tail("/v1/cancel/", parsed)
                           or str(self._body().get("request_id", "")))
                    rr = gw._get(rid)
                    if rr is None:
                        return self._json(
                            404, {"error": "NotFound",
                                  "message": f"unknown request {rid!r}"})
                    rr.cancel()
                    return self._json(200, {"request_id": rr.request_id,
                                            "cancelled": True})
                self._json(404, {"error": "NotFound",
                                 "message": self.path})
            # analysis: allow(broad-except) — THE taxonomy boundary:
            # every error maps to an HTTP status, never a stack dump
            except Exception as e:
                self._error(e)

        def _healthz(self):
            # READINESS: 200 only while routing is live; 503 with a
            # Retry-After while the WAL replay runs, while draining or with
            # no healthy replica (/livez is the liveness half)
            gw._sync_recovered()
            stats = gw.pool.stats()
            recovering = bool(stats.get("recovering"))
            ok = (not stats["draining"] and not gw._closed
                  and not recovering and stats["replicas_healthy"] > 0)
            status = ("ok" if ok else
                      "recovering" if recovering else
                      "draining" if stats["draining"] else "unhealthy")
            payload = {"status": status,
                       "replicas_healthy": stats["replicas_healthy"],
                       "replicas_total": stats["replicas_total"]}
            if "wal" in stats:
                payload["wal"] = stats["wal"]
            self._json(200 if ok else 503, payload,
                       retry_after=None if ok else 1.0)

        def _livez(self):
            # LIVENESS: the listener answers; false only once the gateway
            # is closed (an orchestrator restarts on liveness and holds
            # traffic on readiness)
            alive = not gw._closed
            self._json(200 if alive else 503,
                       {"status": "alive" if alive else "closed"},
                       retry_after=None if alive else 1.0)

        def _stats(self):
            from ...core import compile_cache

            snap = {k: v for k, v in metrics.stats().items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
            # this process's build counters (decode_compiles frozen after
            # the first wave is the no-rebuild contract, read over HTTP)
            comp = {k: v for k, v in compile_cache.stats().items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}
            self._json(200, {"pool": gw.pool.stats(), "serving": snap,
                             "compile": comp})

        def _metrics(self):
            body = telemetry.prometheus_text(pool=gw.pool).encode()
            self.send_response(200)
            # the Prometheus text exposition content type (format 0.0.4)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _trace(self, rid: str):
            if not rid:
                return self._json(400, {
                    "error": "ValueError",
                    "message": "GET /v1/trace/<request_id>"})
            rr = gw._get(rid)
            # the tail is either a gateway request id or a raw trace id
            trace_id = rr.trace_id if rr is not None else rid
            events = telemetry.trace(trace_id)
            if not events and rr is None:
                return self._json(404, {
                    "error": "NotFound",
                    "message": f"no trace for {rid!r} (unknown id, "
                               "FLAGS_serving_telemetry off, or the span "
                               "ring already dropped it)"})
            self._json(200, {"trace_id": trace_id,
                             "enabled": telemetry.enabled(),
                             "events": events})

        def _sse_headers(self) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            metrics.bump("gateway.http_streams")

        def _sse_cached(self, rid: str, res: dict, offset: int = 0) -> None:
            """SSE over a WAL-recovered terminal result: the tokens past
            ``offset``, then the done event (what a client that was
            mid-stream at the crash reattaches to when its stream ended
            during or after the replay)."""
            self._sse_headers()
            try:
                for tok in res["tokens"][offset:]:
                    self.wfile.write(
                        b"data: " + json.dumps({"token": int(tok)}).encode()
                        + b"\n\n")
                self.wfile.write(
                    b"event: done\ndata: " + json.dumps(
                        {"state": res["state"],
                         "tokens": len(res["tokens"]),
                         "cached": True}).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass  # the client left again: the result stays cached

        def _sse(self, rr: RoutedRequest, offset: int = 0) -> None:
            self._sse_headers()
            try:
                for i, tok in enumerate(gw.pool.stream(rr)):
                    if i < offset:
                        continue  # resume: the client already holds these
                    self.wfile.write(
                        b"data: " + json.dumps({"token": int(tok)}).encode()
                        + b"\n\n")
                    self.wfile.flush()
            except (ConnectionError, BrokenPipeError, OSError):
                # the CLIENT hung up mid-stream: cancel the request so the
                # backend stops decoding output nobody will receive (frees
                # the slot next step, stops charging the tenant) — and do
                # not try to write anything else to the dead socket
                rr.cancel()
                metrics.bump("gateway.client_disconnects")
                try:
                    # drive the handle to its terminal state so the tenant
                    # concurrency slot is released NOW, not whenever the
                    # next submit's reap sweep happens past it
                    gw.pool.result(rr, timeout=5.0)
                except Exception:
                    # analysis: allow(broad-except) — best-effort wait:
                    # cancelled/failed either way; reap backstops
                    pass
                return
            # analysis: allow(broad-except) — the SSE error frame must
            # carry ANY failure's taxonomy status to the client
            except Exception as e:
                status, retry = _status_for(e)
                payload = {"error": type(e).__name__, "message": str(e),
                           "status": status, "retriable": retry is not None}
                if retry is not None:
                    payload["retry_after"] = round(retry, 2)
                try:
                    self.wfile.write(b"event: error\ndata: "
                                     + json.dumps(payload).encode() + b"\n\n")
                    self.wfile.flush()
                except OSError:
                    pass  # socket died while reporting: nothing left to do
                return
            done = {"state": rr.state,
                    "tokens": len(rr.tokens()),
                    "reroutes": rr.reroutes}
            try:
                self.wfile.write(b"event: done\ndata: "
                                 + json.dumps(done).encode() + b"\n\n")
                self.wfile.flush()
            except OSError:
                pass  # client left after the last token: stream is complete

    return _Handler


def serve(model, replicas: Optional[int] = None,
          tenants=None, host: str = "127.0.0.1",
          port: Optional[int] = None, guard: bool = True,
          **pool_kw) -> Gateway:
    """One call to a running front door: a background
    :class:`ReplicaPool` over ``model`` (``pool_kw``: its other arguments,
    ``ServingConfig`` fields among them), the HTTP listener, and the
    SIGTERM drain guard. Returns the running :class:`Gateway` (``.port``
    is the bound port).

    With ``FLAGS_gateway_process_replicas`` the replicas are worker
    processes (:class:`~.procpool.ProcessReplicaPool`; ``model`` an
    instance or a zero-argument factory importable by module path). With
    ``FLAGS_gateway_wal`` the pool journals to a :class:`~.wal.GatewayWAL`
    on ``FLAGS_gateway_wal_dir``, opened (and replayed) before the pool
    exists; ``/healthz`` answers 503 "recovering" until the replayed
    streams are back on replicas. A ``wal=`` in ``pool_kw`` is used as
    given."""
    pool_cls = ReplicaPool
    if flags.flag("gateway_process_replicas"):
        from .procpool import ProcessReplicaPool as pool_cls
    wal = pool_kw.pop("wal", None)
    if wal is None and flags.flag("gateway_wal"):
        from .wal import GatewayWAL

        wal = GatewayWAL(str(flags.flag("gateway_wal_dir")))
    pool = pool_cls(model, replicas=replicas, tenants=tenants,
                    background=True, wal=wal, **pool_kw)
    gw = Gateway(pool, host=host, port=port).start()
    if guard:
        gw.install_preemption_guard()
    return gw
