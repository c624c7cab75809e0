"""The gateway's write-ahead request log (counterpart of
``paddle_tpu/serving/gateway/wal.py``): accepted streams that survive a
crash of the gateway's own process.

The pool journals each accepted stream's lifecycle to an append-only log on
disk; a gateway restarted on the same directory replays it. Terminal
requests land in a bounded result cache (``/v1/result`` answers once across
the crash); live requests resubmit seeded with their journals through the
router's ``_route(journal=...)``, so they resume token for token and build
no program.

Record framing (the discipline of ``tiered.DiskTier``)::

    u32 LE body length | u32 LE crc32(body) | body (compact JSON, utf-8)

appended to segment files ``wal-<seq>.log``. A crash can tear only the
unsynced tail of the active segment: replay stops a segment at the first
short or crc-failing record and counts it (``wal.torn_tail``), so every
record behind the last ``commit()`` is read back. Appends only buffer;
``commit()`` is one flush and one fsync, run once per pump iteration, so a
submit never waits on the disk.

Record kinds (``"t"``):

* ``A``, ACCEPTED: request id, tenant, prompt, sampling (its seed pinned by
  ``materialized()``), the constraint's client spec (``choices`` /
  ``grammar``: walkers are built again on replay), adapter, priority,
  trace id.
* ``E``, EMITTED: one stream's new tokens since its last record (one record
  per stream per pump iteration, not per token).
* ``M``, MOVE: a placement move (``REROUTE`` / ``HANDOFF``). Replay folds a
  ``HANDOFF`` into the stream's phase (``decode``), which disaggregated
  serving reads; this package writes ``REROUTE`` only.
* ``T``, TERMINAL: the final state and the last tokens.
* ``R``, RESULT carried forward: a compacted summary (state and every
  token) written again before a fully terminal segment is deleted, so that
  replay never brings back a finished stream whose ACCEPTED record outlived
  its TERMINAL one.

``commit()`` rotates the active segment once it passes
``FLAGS_gateway_wal_segment_bytes``; a sealed segment is deleted
(compaction) once every request with records in it is terminal, its
carries made durable first. The result cache keeps
``FLAGS_gateway_wal_results`` results; older ones are forgotten by
compaction.

Counters (``serving.metrics``): ``wal.records`` / ``accepted`` /
``emitted_tokens`` / ``terminals`` / ``commits`` / ``rotations`` /
``compactions`` / ``carried`` / ``torn_tail`` / ``replayed`` /
``replayed_live`` / ``replayed_results``; gauges ``wal.segments`` /
``wal.bytes``. ``wal.torn_tail`` is mirrored into ``core.resilience``.

The bytes of a segment equal the JAX package's for the same sequence of
calls (``tests/test_torch_gateway_wal.py``), so each package replays the
other's log.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set

from ...core import flags, resilience
from .. import metrics

_logger = logging.getLogger("paddle_tpu_torch.serving.gateway")

_HDR = struct.Struct("<II")
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"
#: bound on one record (the prompt and journal of a 100k-token stream are
#: about 1 MiB of JSON); a length past it is a torn tail
_MAX_RECORD = 32 * 1024 * 1024


def _seg_path(dirpath: str, seq: int) -> str:
    return os.path.join(dirpath, f"{_SEG_PREFIX}{seq:08d}{_SEG_SUFFIX}")


def _seg_seq(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def build_constraint(spec: Optional[dict], vocab_size: int):
    """The constraint walker of a journaled client spec, built as the
    gateway's ``_submit`` builds it, so that a recovered constrained stream
    resumes against the same automaton."""
    if not spec:
        return None
    stop = spec.get("stop_token_id")
    stop = None if stop is None else int(stop)
    if spec.get("choices") is not None:
        from ..constrain import TrieConstraint

        return TrieConstraint([[int(t) for t in c]
                               for c in spec["choices"]],
                              vocab_size=int(vocab_size),
                              stop_token_id=stop)
    g = spec.get("grammar")
    if g:
        from ..constrain import TokenDFA

        table = {int(k): str(v) for k, v in g["token_table"].items()}
        gstop = g.get("stop_token_id", stop)
        gstop = None if gstop is None else int(gstop)
        if g.get("regex") is not None:
            return TokenDFA.from_regex(str(g["regex"]), table,
                                       vocab_size=int(vocab_size),
                                       stop_token_id=gstop)
        if g.get("json_schema") is not None:
            return TokenDFA.from_json_schema(g["json_schema"], table,
                                             vocab_size=int(vocab_size),
                                             stop_token_id=gstop)
    return None


class GatewayWAL:
    """One gateway's write-ahead request log over one directory.

    Thread-safe: appends come from the submit, finalize and re-route paths
    of any thread, ``commit()`` from the pool's pump. One lock covers the
    buffered file and the per-segment bookkeeping; ``commit()`` flushes
    under it but syncs outside it, under a second lock that rotation,
    compaction and ``close`` hold too (so the file cannot close under a
    sync in flight). An append never waits on the disk."""

    def __init__(self, dirpath: str, segment_bytes: Optional[int] = None,
                 result_cap: Optional[int] = None):
        if not dirpath:
            raise ValueError("GatewayWAL needs a directory "
                             "(FLAGS_gateway_wal_dir)")
        self.dir = str(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        self._segment_bytes = int(
            flags.flag("gateway_wal_segment_bytes")
            if segment_bytes is None else segment_bytes)
        self._result_cap = max(1, int(
            flags.flag("gateway_wal_results")
            if result_cap is None else result_cap))
        # re-entrant: the replay helpers take it and are reached from
        # terminal(), which holds it already
        self._lock = threading.RLock()
        #: orders syncs, rotation, compaction and close without blocking
        #: appends (lock order: _commit_lock, then _lock)
        self._commit_lock = threading.Lock()
        self._dirty = False
        self._closed = False
        self._live: "OrderedDict[str, dict]" = OrderedDict()
        self._results: "OrderedDict[str, dict]" = OrderedDict()
        self._terminal: Set[str] = set()
        #: the segments holding records of each request id: compaction never
        #: deletes a segment whose TERMINAL a surviving ACCEPTED would outlive
        self._rid_segments: Dict[str, Set[int]] = {}
        self._sealed: List[int] = []          # sealed segments, oldest first
        self._seg_rids: Dict[int, Set[str]] = {}
        # replay what an earlier incarnation left, then open a fresh active
        # segment past it
        seqs = sorted(s for s in (_seg_seq(n) for n in os.listdir(self.dir))
                      if s is not None)
        replayed = 0
        for seq in seqs:
            replayed += self._replay_segment(seq)
        self._sealed = list(seqs)
        self._replayed = replayed
        self._seq = (seqs[-1] + 1) if seqs else 0
        self._active_path = _seg_path(self.dir, self._seq)
        self._fh = open(self._active_path, "ab")
        self._refresh_gauges()

    # ------------------------------------------------------------ replay

    def _replay_segment(self, seq: int) -> int:
        """Fold one segment's records into the recovered state; a torn tail
        ends the segment at the last good record (counted and logged, never
        raised: recovery always comes up)."""
        path = _seg_path(self.dir, seq)
        with self._lock:
            rids = self._seg_rids.setdefault(seq, set())
        n = 0
        try:
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        if hdr:
                            self._torn(path, "short header")
                        break
                    length, crc = _HDR.unpack(hdr)
                    if length > _MAX_RECORD:
                        self._torn(path, f"absurd length {length}")
                        break
                    body = f.read(length)
                    if len(body) < length:
                        self._torn(path, "short body")
                        break
                    if zlib.crc32(body) & 0xFFFFFFFF != crc:
                        self._torn(path, "crc mismatch")
                        break
                    try:
                        rec = json.loads(body)
                    except ValueError:
                        self._torn(path, "bad json")
                        break
                    self._fold(rec, seq, rids)
                    n += 1
        except OSError as e:
            _logger.warning("WAL segment %s unreadable (%s); skipped",
                            path, e)
        return n

    def _torn(self, path: str, why: str) -> None:
        metrics.bump("wal.torn_tail")
        resilience.bump("wal.torn_tail")
        _logger.warning("WAL %s: torn tail (%s); replay truncated there",
                        path, why)

    def _fold(self, rec: dict, seq: int, rids: Set[str]) -> None:
        with self._lock:
            rid = rec.get("rid")
            if not rid:
                return
            kind = rec.get("t")
            rids.add(rid)
            self._rid_segments.setdefault(rid, set()).add(seq)
            if kind == "A":
                rec["toks"] = []
                rec["phase"] = "prefill"
                self._live[rid] = rec
                self._terminal.discard(rid)
                self._results.pop(rid, None)
            elif kind == "E":
                entry = self._live.get(rid)
                if entry is not None:
                    entry["toks"].extend(int(t) for t in rec.get("toks", ()))
            elif kind == "M":
                entry = self._live.get(rid)
                if entry is not None and rec.get("kind") == "HANDOFF":
                    entry["phase"] = "decode"
            elif kind == "T":
                entry = self._live.pop(rid, None)
                toks = list(entry["toks"]) if entry is not None else []
                # a compaction tombstone carries "toks": None (its result
                # left the bounded cache): terminal, with no result
                toks.extend(int(t) for t in rec.get("toks") or ())
                self._terminal.add(rid)
                if entry is not None or rec.get("toks") is not None:
                    self._remember_result(rid, rec.get("state", "FAILED"),
                                          toks)
            elif kind == "R":
                self._live.pop(rid, None)
                self._terminal.add(rid)
                self._remember_result(rid, rec.get("state", "FAILED"),
                                      [int(t) for t in rec.get("toks", ())])

    def _remember_result(self, rid: str, state: str, toks) -> None:
        with self._lock:
            self._results.pop(rid, None)
            self._results[rid] = {"state": state, "tokens": list(toks)}
            while len(self._results) > self._result_cap:
                self._results.popitem(last=False)

    def recover(self) -> dict:
        """The replayed state, handed once to the restarting pool:
        ``{"live": [accepted record...], "results": {rid: {state,
        tokens}}}``. A live record carries its token journal (``toks``) and
        its phase."""
        with self._lock:
            live = list(self._live.values())
            self._live = OrderedDict()
            results = dict(self._results)
            replayed, self._replayed = self._replayed, 0
        if replayed:
            metrics.bump("wal.replayed", replayed)
            metrics.bump("wal.replayed_live", len(live))
            metrics.bump("wal.replayed_results", len(results))
        return {"live": live, "results": results}

    # ------------------------------------------------------------ append

    def _append(self, rec: dict) -> None:
        body = json.dumps(rec, separators=(",", ":")).encode()
        frame = _HDR.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF) + body
        rid = rec["rid"]
        with self._lock:
            if self._closed:
                return
            self._fh.write(frame)
            self._dirty = True
            self._seg_rids.setdefault(self._seq, set()).add(rid)
            self._rid_segments.setdefault(rid, set()).add(self._seq)
        metrics.bump("wal.records")

    def accepted(self, rr, constraint_spec: Optional[dict] = None) -> None:
        """Journal one admitted stream: everything replay needs to make its
        ``RoutedRequest`` again (the seed pinned by ``materialized()``, the
        constraint as its client spec)."""
        rec = {
            "t": "A",
            "rid": rr.request_id,
            "tenant": rr.tenant,
            "prompt": [int(t) for t in rr.prompt],
            "mnt": int(rr.max_new_tokens),
            "stop": (None if rr.stop_token_id is None
                     else int(rr.stop_token_id)),
            "prio": int(rr.priority),
            "adapter": int(rr.adapter),
            "samp": (None if rr.sampling is None
                     else dataclasses.asdict(rr.sampling)),
            "cspec": constraint_spec or None,
            "tid": rr.trace_id,
        }
        self._append(rec)
        metrics.bump("wal.accepted")

    def emitted(self, rid: str, toks) -> None:
        toks = [int(t) for t in toks]
        if not toks:
            return
        self._append({"t": "E", "rid": rid, "toks": toks})
        metrics.bump("wal.emitted_tokens", len(toks))

    def moved(self, rid: str, kind: str) -> None:
        self._append({"t": "M", "rid": rid, "kind": str(kind)})

    def terminal(self, rid: str, state: str, tail, tokens) -> None:
        """Journal a terminal state: ``tail`` is the tokens past the last
        EMITTED record, ``tokens`` the whole stream (for the result cache a
        restarted ``/v1/result`` answers from)."""
        self._append({"t": "T", "rid": rid, "state": str(state),
                      "toks": [int(t) for t in tail]})
        with self._lock:
            self._terminal.add(rid)
            self._remember_result(rid, str(state), tokens)
        metrics.bump("wal.terminals")

    # ----------------------------------------------------- commit / seal

    def commit(self) -> None:
        """The pump iteration's barrier: one flush and fsync for every
        append since the last commit, then rotation and compaction, the
        only place the log syncs or touches segment files. The fsync runs
        with the append lock released (a record appended meanwhile leaves
        the log dirty for the next commit)."""
        with self._commit_lock:
            with self._lock:
                if self._closed:
                    return
                dirty = self._dirty
                if dirty:
                    self._fh.flush()
                    self._dirty = False
                fd = self._fh.fileno()
            if dirty:
                os.fsync(fd)  # _commit_lock keeps the file open under us
                metrics.bump("wal.commits")
            with self._lock:
                if self._closed:
                    return
                try:
                    rotate = self._fh.tell() >= self._segment_bytes
                except (OSError, ValueError):
                    rotate = False
            if rotate:
                self._rotate()
            self._compact()
        self._refresh_gauges()

    def _rotate(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._sealed.append(self._seq)
            self._seq += 1
            self._active_path = _seg_path(self.dir, self._seq)
            self._fh = open(self._active_path, "ab")
            self._dirty = False
        metrics.bump("wal.rotations")

    def _compact(self) -> None:
        """Delete sealed segments whose every request is terminal, oldest
        first. Before a delete, each such request is carried into the
        active segment: an ``R`` summary while its result is cached, a
        token-free ``T`` tombstone when an earlier surviving segment still
        holds its ACCEPTED record (without it, the next replay would bring
        the stream back as live). The carries are synced before the
        unlink."""
        while True:
            with self._lock:
                if self._closed or not self._sealed:
                    return
                seq = self._sealed[0]
                rids = self._seg_rids.get(seq, set())
                if any(r not in self._terminal for r in rids):
                    return  # oldest first: the later segments are newer
                self._sealed.pop(0)
                self._seg_rids.pop(seq, None)
                carries = []
                for rid in rids:
                    segs = self._rid_segments.get(rid)
                    if segs is not None:
                        segs.discard(seq)
                    res = self._results.get(rid)
                    if res is not None:
                        carries.append({"t": "R", "rid": rid,
                                        "state": res["state"],
                                        "toks": res["tokens"]})
                        self._rid_segments.setdefault(rid, set())
                    elif segs:
                        # records of rid survive elsewhere: keep it terminal
                        # on replay without growing the log again
                        carries.append({"t": "T", "rid": rid,
                                        "state": "FAILED", "toks": None})
                    else:
                        # no record of rid anywhere: its terminal membership
                        # has nothing left to guard
                        self._rid_segments.pop(rid, None)
                        self._terminal.discard(rid)
            for rec in carries:
                self._append(rec)
                metrics.bump("wal.carried")
            if carries:
                # durable before the old segment goes: a crash between the
                # two would forget an acknowledged terminal result
                with self._lock:
                    if self._closed:
                        return
                    self._fh.flush()
                    self._dirty = False
                    fd = self._fh.fileno()
                os.fsync(fd)
                metrics.bump("wal.commits")
            try:
                os.unlink(_seg_path(self.dir, seq))
            except OSError:
                pass  # already gone: the delete is the point
            metrics.bump("wal.compactions")

    def close(self) -> None:
        """The last fsync. Idempotent; the pool calls it after its terminal
        sweep and before it reaps worker processes, so a clean shutdown
        leaves no record that looks live."""
        with self._commit_lock, self._lock:
            if self._closed:
                return
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
            except (OSError, ValueError):
                pass  # interpreter teardown may have closed the file already
            self._closed = True
        self._refresh_gauges()

    # ------------------------------------------------------------- stats

    def _refresh_gauges(self) -> None:
        with self._lock:
            segments = len(self._sealed) + (0 if self._closed else 1)
            total = 0
            for seq in list(self._sealed) + [self._seq]:
                try:
                    total += os.path.getsize(_seg_path(self.dir, seq))
                except OSError:
                    pass
        metrics.set_gauge("wal.segments", segments)
        metrics.set_gauge("wal.bytes", total)

    def stats(self) -> dict:
        with self._lock:
            return {
                "dir": self.dir,
                "segments": len(self._sealed) + (0 if self._closed else 1),
                "active_seq": self._seq,
                "terminal": len(self._terminal),
                "results_cached": len(self._results),
                "closed": self._closed,
            }
