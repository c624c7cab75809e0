"""Request-lifecycle tracing and latency histograms (counterpart of
``paddle_tpu/serving/telemetry.py``; the same code, host-side).

* :class:`Histogram` (JAX ``:120``): a fixed-log-bucket latency histogram,
  the same 96 buckets (1 us growing by 1.25x), so its percentiles equal
  the JAX package's on the same samples. ``record`` is one ``bisect`` and
  three GIL-atomic increments; histograms are always on.
* :class:`TraceLog` (``:296``): a bounded ring of typed span events keyed
  by a ``trace_id`` minted at submit and carried through ``Request``, its
  preemption re-queue and its supervisor replay, so one id names a
  request's whole life. Span collection is gated by
  ``FLAGS_serving_telemetry``.
* :func:`prometheus_text` (``:491``; with ``pool=`` a gateway
  ``ReplicaPool``'s per-replica quantiles and its replica and tenant
  series) and :func:`chrome_events` (``:424``).

Everything here stays outside captured code: a timestamp is taken around a
step program's run, never inside its step function (a ``time.*`` read or a
``float()`` there would run once, at capture -- the capture lint's
``traced-cast`` rule). The TTFT and inter-token percentiles are
``core.memory_stats`` providers (``paddle_tpu/serving/telemetry.py:556``).

Histogram keys (all in SECONDS): ``latency.ttft`` (submit to the first
emitted token), ``latency.inter_token`` (gap between consecutive tokens of
one stream), ``latency.queue_wait`` (enqueue to admission),
``latency.prefill`` (one prefill or chunk program run and its read),
``latency.decode_step`` (one decode program run and its read),
``latency.spec_verify`` (one run of the speculative step and its read),
``latency.spec_step`` (a whole speculative iteration, its fallback lanes'
decode step included), ``latency.restore`` (restoring one spilled chain
from the tiered KV cache: the tier lookups and the restore program's run),
``latency.spill`` (making one evicted block tier-resident),
``latency.e2e`` (submit to FINISHED). Counters (``serving.metrics``):
``telemetry.spans`` and ``telemetry.spans_dropped`` (ring overflow,
oldest first).
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterable, List, Optional

from ..core import flags
from . import metrics

#: the histogram and counter namespaces this module emits (see the
#: module docstring)
DOCUMENTED_NAMESPACES = (
    "latency",
    "telemetry",
)

# ------------------------------------------------------------- span taxonomy
# The JAX package's whole taxonomy: the port emits SUBMITTED through
# FIRST_TOKEN, PREEMPTED, REPLAYED, RESTORED, DRAINED, FINISHED and FAILED;
# the others belong to the gateway and disaggregation slices.

SUBMITTED = "SUBMITTED"          # accepted by the front door (api/gateway)
QUEUED = "QUEUED"                # enqueued in a scheduler's waiting list
ADMITTED = "ADMITTED"            # slot + block reservation claimed
PREFILL_CHUNK = "PREFILL_CHUNK"  # one chunked-prefill call advanced
FIRST_TOKEN = "FIRST_TOKEN"      # first token of the stream emitted
PREEMPTED = "PREEMPTED"          # victim evicted mid-decode, re-queued
REPLAYED = "REPLAYED"            # supervisor rebuild re-admitted the journal
REROUTED = "REROUTED"            # gateway moved the stream to another replica
RESTORED = "RESTORED"            # tier-restore scatter landed for this admit
HANDOFF = "HANDOFF"              # prefill->decode pool handoff (disagg)
PREFETCHED = "PREFETCHED"        # restore-ahead planner pre-restored the chain
RECOVERED = "RECOVERED"          # WAL replay resubmitted the journaled stream
DRAINED = "DRAINED"              # failed by a drain (retriable)
FINISHED = "FINISHED"            # terminal: complete output delivered
FAILED = "FAILED"                # terminal: error or cancellation

#: every event kind a well-formed trace may contain, in no particular
#: order
SPAN_KINDS = (SUBMITTED, QUEUED, ADMITTED, PREFILL_CHUNK, FIRST_TOKEN,
              PREEMPTED, REPLAYED, REROUTED, RESTORED, HANDOFF, PREFETCHED,
              RECOVERED, DRAINED, FINISHED, FAILED)


def mint_trace_id() -> str:
    """A fresh trace id (``t`` + 12 hex chars): process-unique and safe to
    carry across processes (uuid4 entropy, not a counter) — the id must
    survive a future multi-process fleet's re-routes."""
    return "t" + uuid.uuid4().hex[:12]


def enabled() -> bool:
    """Span collection on? (``FLAGS_serving_telemetry``; histograms are
    always on.)"""
    return bool(flags.flag("serving_telemetry"))


# ---------------------------------------------------------------- histograms

#: fixed log-spaced bucket upper bounds in seconds: 1 us growing by 1.25x
#: per bucket, ~96 buckets to ~1.4e3 s. Shared by every Histogram, so
#: ``merge`` is pure element-wise addition and a percentile is never off
#: by more than one bucket width (~+25%) from the true sample.
_BUCKET_START = 1e-6
_BUCKET_FACTOR = 1.25
_BUCKET_COUNT = 96
BUCKET_BOUNDS = tuple(_BUCKET_START * _BUCKET_FACTOR ** i
                      for i in range(_BUCKET_COUNT))

_lock = threading.Lock()  # registry creation only — never the record path


class Histogram:
    """Fixed-log-bucket latency histogram (seconds).

    ``record`` is the hot path: one ``bisect`` over the shared bounds and
    three GIL-atomic increments — no lock, the ``metrics.bump`` contract.
    Snapshots taken concurrently may be off by the in-flight record (all
    counters are monotone, same as every other stats surface here)."""

    __slots__ = ("counts", "n", "total")

    def __init__(self, counts: Optional[List[int]] = None,
                 n: int = 0, total: float = 0.0):
        # one overflow bucket past the last bound
        self.counts = (list(counts) if counts is not None
                       else [0] * (_BUCKET_COUNT + 1))
        self.n = int(n)
        self.total = float(total)

    def record(self, value: float) -> None:
        """One sample (seconds). Negative clock skew clamps to 0."""
        v = value if value > 0.0 else 0.0
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
        self.n += 1
        self.total += v

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile (0..100) in seconds; 0.0 when
        empty. Exact to within one bucket's width."""
        total = self.n
        if total <= 0:
            return 0.0
        rank = max(1.0, (float(p) / 100.0) * total)
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= rank:
                lo = BUCKET_BOUNDS[i - 1] if i > 0 else 0.0
                hi = (BUCKET_BOUNDS[i] if i < _BUCKET_COUNT
                      else BUCKET_BOUNDS[-1] * _BUCKET_FACTOR)
                frac = (rank - (cum - c)) / c
                return lo + frac * (hi - lo)
        return BUCKET_BOUNDS[-1] * _BUCKET_FACTOR

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def merge(self, other: "Histogram") -> "Histogram":
        """Element-wise sum — cross-replica / cross-run aggregation."""
        return Histogram([a + b for a, b in zip(self.counts, other.counts)],
                         self.n + other.n, self.total + other.total)

    def minus(self, before: "Histogram") -> "Histogram":
        """This histogram minus an earlier snapshot (per-run deltas)."""
        return Histogram(
            [max(0, a - b) for a, b in zip(self.counts, before.counts)],
            max(0, self.n - before.n), max(0.0, self.total - before.total))

    def snapshot(self) -> "Histogram":
        return Histogram(self.counts, self.n, self.total)

    def buckets(self) -> List[tuple]:
        """``[(upper_bound_seconds, cumulative_count), ...]`` for the
        non-empty prefix — Prometheus ``_bucket`` rendering."""
        out, cum = [], 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            bound = (BUCKET_BOUNDS[i] if i < _BUCKET_COUNT
                     else float("inf"))
            out.append((bound, cum))
        return out


class HistogramSet:
    """One named histogram registry — the process-global default plus one
    per engine (the per-replica view ``/v1/metrics`` labels by replica
    index). :func:`observe` records into the global set and any extra
    sets in the same call, so pool-merged numbers never lose an ejected
    replica's samples."""

    def __init__(self) -> None:
        self._h: Dict[str, Histogram] = {}

    def get(self, name: str) -> Histogram:
        h = self._h.get(name)
        if h is None:
            with _lock:
                h = self._h.setdefault(name, Histogram())
        return h

    def peek(self, name: str) -> Optional[Histogram]:
        return self._h.get(name)

    def items(self):
        return sorted(self._h.items())

    def snapshot(self) -> Dict[str, Histogram]:
        with _lock:
            return {k: v.snapshot() for k, v in self._h.items()}

    def clear(self) -> None:
        with _lock:
            self._h.clear()


_global = HistogramSet()


def observe(name: str, seconds: float, *sets: Optional[HistogramSet]) -> None:
    """Record one duration sample into the process-global histogram named
    ``name`` and into each extra :class:`HistogramSet` (an engine's
    per-replica set). The ONLY write path for histogram samples — literal
    keys here are lint-checked against :data:`DOCUMENTED_NAMESPACES`."""
    v = float(seconds)
    _global.get(name).record(v)
    for s in sets:
        if s is not None:
            s.get(name).record(v)


def histograms() -> Dict[str, Histogram]:
    """Snapshot of the process-global histograms (pool-merged view: every
    engine's samples land here too). The ``metrics.histograms()`` alias
    keeps the one-stop stats surface."""
    return _global.snapshot()


def histogram(name: str) -> Histogram:
    """One merged histogram by name (empty histogram when never recorded)."""
    return _global.peek(name) or Histogram()


def reset_histograms() -> None:
    """Clear the process-global set (tests / ``reset_stats`` epilogues).
    Per-engine sets are owned by their engines and reset with them."""
    _global.clear()


def histograms_delta(before: Dict[str, Histogram]) -> Dict[str, Histogram]:
    """Current global histograms minus an earlier :func:`histograms`
    snapshot — the per-run delta the profiler and benches report."""
    out = {}
    for name, h in histograms().items():
        prev = before.get(name)
        d = h.minus(prev) if prev is not None else h
        if d.n:
            out[name] = d
    return out


def percentile_table(hists: Optional[Dict[str, Histogram]] = None,
                     unit_ms: bool = True) -> str:
    """The human percentile table (count, p50, p95, p99 and mean of every
    non-empty histogram)."""
    hists = histograms() if hists is None else hists
    rows = [(n, h) for n, h in sorted(hists.items()) if h.n]
    if not rows:
        return ""
    scale = 1e3 if unit_ms else 1.0
    unit = "ms" if unit_ms else "s"
    lines = ["%-28s %8s %10s %10s %10s %10s" % (
        "histogram", "count", f"p50({unit})", f"p95({unit})",
        f"p99({unit})", f"mean({unit})")]
    for name, h in rows:
        lines.append("%-28s %8d %10.3f %10.3f %10.3f %10.3f" % (
            name, h.n, h.percentile(50) * scale, h.percentile(95) * scale,
            h.percentile(99) * scale, h.mean() * scale))
    return "\n".join(lines)


# ------------------------------------------------------------------- tracing


class TraceLog:
    """Bounded ring buffer of span events. Append is a deque push under
    the GIL; overflow drops oldest-first and is counted
    (``telemetry.spans_dropped``). Events carry a process-wide monotone
    ``seq`` so a trace's ordering is exact even when wall clocks tie."""

    def __init__(self, capacity: Optional[int] = None):
        cap = (int(flags.flag("serving_trace_events"))
               if capacity is None else int(capacity))
        self._buf: deque = deque(maxlen=max(16, cap))
        self._seq = itertools.count()

    def append(self, trace_id: str, kind: str, detail: dict) -> None:
        buf = self._buf
        if len(buf) == buf.maxlen:
            metrics.bump("telemetry.spans_dropped")
        buf.append((next(self._seq), trace_id, kind, time.time(), detail))
        metrics.bump("telemetry.spans")

    def trace(self, trace_id: str) -> List[dict]:
        """This trace's events, oldest first, as dicts."""
        out = [{"seq": seq, "trace_id": tid, "event": kind,
                "ts": ts, **detail}
               for seq, tid, kind, ts, detail in list(self._buf)
               if tid == trace_id]
        out.sort(key=lambda e: e["seq"])
        return out

    def events(self) -> List[dict]:
        """Every buffered event (oldest first)."""
        return [{"seq": seq, "trace_id": tid, "event": kind,
                 "ts": ts, **detail}
                for seq, tid, kind, ts, detail in list(self._buf)]

    def ingest(self, trace_id: str, kind: str, ts: float,
               detail: dict) -> None:
        """Append one event recorded elsewhere (another process's ring on
        this host): its wall-clock ``ts`` is kept, its ordering ``seq`` is
        stamped here, so ``trace()`` reads one timeline in arrival
        order."""
        buf = self._buf
        if len(buf) == buf.maxlen:
            metrics.bump("telemetry.spans_dropped")
        buf.append((next(self._seq), trace_id, kind, ts, detail))
        metrics.bump("telemetry.spans")

    def clear(self) -> None:
        self._buf.clear()


_tracelog: Optional[TraceLog] = None


def _log() -> TraceLog:
    global _tracelog
    log = _tracelog
    if log is None:
        with _lock:
            log = _tracelog
            if log is None:
                log = _tracelog = TraceLog()
    return log


def span(trace_id: str, kind: str, **detail) -> None:
    """Record one lifecycle event for ``trace_id``. No-op (one flag read)
    unless ``FLAGS_serving_telemetry`` is on — the gate keeps the span
    path off the default hot path entirely; histograms don't come through
    here and stay always-on."""
    if not trace_id or not enabled():
        return
    _log().append(trace_id, kind, detail)


def trace(trace_id: str) -> List[dict]:
    """All buffered events of one trace, ordered."""
    log = _tracelog
    return log.trace(trace_id) if log is not None else []


def trace_events() -> List[dict]:
    """Every buffered span event (ordered by seq)."""
    log = _tracelog
    return log.events() if log is not None else []


def events_since(after_seq: int) -> List[list]:
    """Raw span tuples ``[seq, trace_id, kind, ts, detail]`` with
    ``seq > after_seq``: what one process ships to another (JSON-safe:
    the span() call sites record scalars and short strings). The caller
    tracks the highest seq it has seen to ship each span once."""
    log = _tracelog
    if log is None:
        return []
    return [[seq, tid, kind, ts, detail]
            for seq, tid, kind, ts, detail in list(log._buf)
            if seq > after_seq]


def ingest(events) -> None:
    """Fold span tuples from :func:`events_since` (another process's
    ring) into this process's TraceLog. Gated by
    ``FLAGS_serving_telemetry`` like :func:`span`; malformed entries are
    dropped."""
    if not events or not enabled():
        return
    log = _log()
    for ev in events:
        try:
            _, tid, kind, ts, detail = ev
            log.ingest(str(tid), str(kind), float(ts), dict(detail))
        except (TypeError, ValueError):
            continue


def reset_tracelog() -> None:
    global _tracelog
    with _lock:
        _tracelog = None


# ---------------------------------------------------------- chrome trace JSON


def chrome_events(events: Iterable[dict]) -> List[dict]:
    """Convert span-event dicts (:meth:`TraceLog.events`) into Chrome
    trace-event objects (the ``chrome://tracing`` / Perfetto JSON array
    format, ``ts``/``dur`` in microseconds). Each
    trace becomes one ``tid`` lane: consecutive events render as complete
    ("X") slices named by the phase they start, the terminal event as an
    instant ("i") marker."""
    by_trace: Dict[str, List[dict]] = {}
    for ev in events:
        by_trace.setdefault(str(ev.get("trace_id", "?")), []).append(ev)
    out: List[dict] = []
    for tid_idx, (trace_id, evs) in enumerate(sorted(by_trace.items())):
        evs.sort(key=lambda e: (e.get("seq", 0), e.get("ts", 0.0)))
        out.append({"ph": "M", "name": "thread_name", "pid": 0,
                    "tid": tid_idx, "args": {"name": trace_id}})
        for i, ev in enumerate(evs):
            ts_us = float(ev.get("ts", 0.0)) * 1e6
            args = {k: v for k, v in ev.items()
                    if k not in ("seq", "trace_id", "event", "ts")}
            args["trace_id"] = trace_id
            if i + 1 < len(evs):
                dur = max(0.0,
                          float(evs[i + 1].get("ts", 0.0)) * 1e6 - ts_us)
                out.append({"ph": "X", "name": ev.get("event", "?"),
                            "cat": "serving", "pid": 0, "tid": tid_idx,
                            "ts": ts_us, "dur": dur, "args": args})
            else:
                out.append({"ph": "i", "s": "t",
                            "name": ev.get("event", "?"),
                            "cat": "serving", "pid": 0, "tid": tid_idx,
                            "ts": ts_us, "args": args})
    return out


# ------------------------------------------------------- prometheus rendering


def _prom_name(key: str, prefix: str = "paddle_serving_") -> str:
    return prefix + key.replace(".", "_").replace("-", "_")


def _prom_value(v) -> Optional[str]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return repr(float(v)) if isinstance(v, float) else str(v)


def _hist_lines(lines: List[str], name: str, h: Histogram,
                replica: str) -> None:
    base = _prom_name(name, prefix="paddle_") + "_seconds"
    if replica == "pool":
        lines.append(f"# TYPE {base} histogram")
        cum = 0
        for bound, cum in h.buckets():
            le = "+Inf" if bound == float("inf") else f"{bound:.9g}"
            lines.append(
                f'{base}_bucket{{replica="pool",le="{le}"}} {cum}')
        lines.append(f'{base}_bucket{{replica="pool",le="+Inf"}} {h.n}')
        lines.append(f'{base}_sum{{replica="pool"}} {h.total!r}')
        lines.append(f'{base}_count{{replica="pool"}} {h.n}')
    for q in (50, 95, 99):
        lines.append(
            f'{base}_quantile{{replica="{replica}",quantile="0.{q}"}} '
            f'{h.percentile(q)!r}')


def prometheus_text(pool=None) -> str:
    """The serving stats in the Prometheus text exposition format (``GET
    /v1/metrics``): every ``serving.metrics`` counter and gauge, and every
    latency histogram (cumulative buckets, sum, count and p50/p95/p99).
    With ``pool`` (a gateway ``ReplicaPool``) also each live replica's
    quantiles labelled ``replica="<idx>"``, its health row
    (``paddle_gateway_replica_*``; a process pool's workers also
    ``paddle_gateway_worker_pid`` / ``_heartbeat_age_ms`` / ``_restarts``)
    and each tenant's accounting (``paddle_tenant_*``). A pure read of the
    snapshots."""
    lines: List[str] = []
    gauges = metrics.gauges()
    stats = metrics.stats()
    for key in sorted(stats):
        val = _prom_value(stats[key])
        if val is None:
            continue
        name = _prom_name(key)
        lines.append(f"# TYPE {name} "
                     f"{'gauge' if key in gauges else 'counter'}")
        lines.append(f"{name} {val}")
    for name, h in sorted(histograms().items()):
        if h.n:
            _hist_lines(lines, name, h, replica="pool")
    if pool is not None:
        for rep in pool.replicas():
            # a process replica's histograms live in its worker
            hists = rep.api.engine.hists
            if hists is None:
                continue
            for name, h in sorted(hists.snapshot().items()):
                if h.n:
                    _hist_lines(lines, name, h, replica=str(rep.idx))
        snap = pool.stats()
        for row in snap["replicas"]:
            for key in ("healthy", "outstanding", "generation",
                        "ejections"):
                val = _prom_value(int(row[key]))
                lines.append(f'paddle_gateway_replica_{key}'
                             f'{{replica="{row["idx"]}"}} {val}')
            # a process pool's rows carry each worker's pid, heartbeat age
            # and restarts
            for key in ("pid", "heartbeat_age_ms", "restarts"):
                if key in row:
                    val = _prom_value(row[key])
                    if val is not None:
                        lines.append(f'paddle_gateway_worker_{key}'
                                     f'{{replica="{row["idx"]}"}} {val}')
        for tenant, row in sorted(snap["tenants"].items()):
            for key in ("admitted", "shed", "completed", "failed",
                        "inflight", "tokens_out", "tokens_per_sec"):
                val = _prom_value(row[key])
                if val is not None:
                    lines.append(
                        f'paddle_tenant_{key}{{tenant="{tenant}"}} {val}')
    return "\n".join(lines) + "\n"


# ------------------------------------------------- shared observability hooks


def _register_providers() -> None:
    """Headline latency percentiles (milliseconds) on the
    ``core.memory_stats`` surface, beside the serving counters that
    ``metrics._register_providers`` put there."""
    from ..core import memory_stats

    for stat, name, q in (
            ("serving.ttft_p50_ms", "latency.ttft", 50),
            ("serving.ttft_p99_ms", "latency.ttft", 99),
            ("serving.inter_token_p50_ms", "latency.inter_token", 50),
            ("serving.inter_token_p99_ms", "latency.inter_token", 99)):
        memory_stats.register_stat_provider(
            stat, lambda n=name, p=q: round(
                histogram(n).percentile(p) * 1e3, 3))


_register_providers()
