"""Request-lifecycle chrome-trace spans on the profiler's clock.  Port
of ``mxnet_tpu/obs/trace.py``.

The serving engine's telemetry lands in the SAME dump as the
profiler's op events (one trace, one clock):

* **clock**: ``profiler.now_us()`` (``time.perf_counter`` in us), the
  clock every profiler event uses.  The serving engine records
  ``Request.submit_t`` / ``token_times`` with ``time.perf_counter()``,
  so lifecycle timestamps convert with a bare ``* 1e6``.
* **pid/tid**: the op events' ``pid``; op events use real thread ids
  as ``tid``, request rows ``tid = REQ_TID_BASE + rid`` with a
  thread-name metadata event (``ph: "M"``) naming the row ``req <rid>``,
  so chrome://tracing shows one swimlane per request beside the
  operator lanes.
* **gating**: spans are emitted only while ``profiler.is_recording()``;
  the metrics registry does not depend on the profiler.  The engine
  collects one step's spans in a plain list and hands them over in one
  locked append.

Span vocabulary (cat ``serving``): ``admission_wait`` (submit or
preemption to slot admission, X span), ``prefill[a:b)`` (one chunked
prefill step over input rows a..b), ``decode`` (one decode step's
slice on this request's row), ``spec_verify`` (a step verifying this
request's drafts), and the instants ``first_token``, ``preempt``,
``resume`` and ``retire``.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional

from .. import profiler

__all__ = ["RequestTraceEmitter", "REQ_TID_BASE",
           "SpanBuffer", "MergedTraceEmitter", "LANE_PID_BASE"]

# Request swimlane tids start far above OS thread ids (Linux pids/tids
# top out at ~4M; this keeps the spaces visibly disjoint in a dump).
REQ_TID_BASE = 1 << 24

# Merged-trace lanes get synthetic chrome pids above any
# real Linux pid, one per remote process/transport lane, so the ONE
# router-side dump shows each worker as its own process group without
# colliding with the router's real-pid op/request lanes.
LANE_PID_BASE = 1 << 23


class RequestTraceEmitter:
    """Batched emitter of per-request lifecycle events.

    One per serving engine.  All ``add_*`` methods append into an
    internal list; ``flush()`` hands the batch to the profiler (a
    no-op returning False while the profiler is not recording — the
    batch is dropped, never retained, so an engine that runs for hours
    without a profiler session holds no trace memory).
    """

    def __init__(self):
        self._pid = os.getpid()
        self._pending: List[dict] = []
        self._batch_rids: set = set()   # rids touched in this batch
        self._named: set = set()        # rids named in the CURRENT trace
        self._gen = -1                  # profiler dump generation seen

    def add_span(self, rid: int, name: str, t0_s: float, t1_s: float,
                 args: Optional[dict] = None):
        """Complete span from perf_counter seconds t0_s..t1_s."""
        ev = {"name": name, "ph": "X", "ts": t0_s * 1e6,
              "dur": max(0.0, (t1_s - t0_s) * 1e6), "pid": self._pid,
              "tid": REQ_TID_BASE + rid, "cat": "serving"}
        if args:
            ev["args"] = args
        self._pending.append(ev)
        self._batch_rids.add(rid)

    def add_instant(self, rid: int, name: str, t_s: float,
                    args: Optional[dict] = None):
        ev = {"name": name, "ph": "i", "ts": t_s * 1e6,
              "pid": self._pid, "tid": REQ_TID_BASE + rid, "s": "t",
              "cat": "serving"}
        if args:
            ev["args"] = args
        self._pending.append(ev)
        self._batch_rids.add(rid)

    def flush(self) -> bool:
        """Hand the batch to the profiler; drop it either way.

        Swimlane metadata is decided here, not at add time: each
        dump() starts a new trace file (``profiler.events_generation``
        bumps), and every trace needs its own thread_name events or
        later dumps show raw tids instead of "req N" lanes."""
        if not self._pending:
            return False
        gen = profiler.events_generation()
        if gen != self._gen:
            self._gen = gen
            self._named.clear()
        meta = [{"name": "thread_name", "ph": "M", "pid": self._pid,
                 "tid": REQ_TID_BASE + rid,
                 "args": {"name": "req %d" % rid}}
                for rid in sorted(self._batch_rids - self._named)]
        ok = profiler.record_events(meta + self._pending)
        self._pending = []
        self._batch_rids = set()
        if ok:
            self._named.update(e["tid"] - REQ_TID_BASE for e in meta)
        else:
            # profiler not recording: nothing landed — a later session
            # must re-emit all lane metadata
            self._named.clear()
        return ok


class SpanBuffer:
    """Worker-side span staging for cross-process shipping.

    A disagg worker cannot hand spans to a profiler — the recording
    session lives in the router process.  Instead it stages compact
    wire-friendly span dicts here and ships the drained batch to the
    router on the stats tick (the ``spans`` wire kind); the router
    corrects each worker's clock by its handshake ping-pong offset and
    folds everything into ONE merged chrome trace
    (:class:`MergedTraceEmitter`).

    Wire shape (plain JSON-able dicts, ``perf_counter`` seconds):

    * span:    ``{"rid", "name", "ph": "X", "t0", "t1", "cat",
      "trace_id"?, "args"?}``
    * instant: ``{"rid", "name", "ph": "i", "t", "cat",
      "trace_id"?, "args"?}``

    Bounded by ``cap`` (default ``MXNET_SERVE_SPANS``, 512); over it
    new entries are dropped and counted — a stalled router must not
    grow worker memory.  ``cap == 0`` disables collection outright
    (every ``add`` is one attribute test; the tracing-off serving path
    stays bit-identical).  The emit path is hot: memory-only appends
    under the lock, no blocking calls.
    """

    def __init__(self, cap: Optional[int] = None):
        if cap is None:
            try:
                cap = int(os.environ.get("MXNET_SERVE_SPANS", 512))
            except ValueError:
                cap = 512
        self.cap = max(0, int(cap))
        self.enabled = self.cap > 0
        self.dropped = 0
        self._mu = threading.Lock()
        self._buf: List[dict] = []

    def span(self, rid: int, name: str, t0_s: float, t1_s: float,
             trace_id: Optional[str] = None, cat: str = "serving",
             args: Optional[dict] = None):
        if not self.enabled:
            return
        ev = {"rid": int(rid), "name": name, "ph": "X",
              "t0": float(t0_s), "t1": float(t1_s), "cat": cat}
        if trace_id is not None:
            ev["trace_id"] = trace_id
        if args:
            ev["args"] = args
        with self._mu:
            if len(self._buf) >= self.cap:
                self.dropped += 1
            else:
                self._buf.append(ev)

    def instant(self, rid: int, name: str, t_s: float,
                trace_id: Optional[str] = None, cat: str = "serving",
                args: Optional[dict] = None):
        if not self.enabled:
            return
        ev = {"rid": int(rid), "name": name, "ph": "i",
              "t": float(t_s), "cat": cat}
        if trace_id is not None:
            ev["trace_id"] = trace_id
        if args:
            ev["args"] = args
        with self._mu:
            if len(self._buf) >= self.cap:
                self.dropped += 1
            else:
                self._buf.append(ev)

    def drain(self) -> List[dict]:
        """Take the staged batch (empty list when nothing staged)."""
        if not self.enabled:
            return []
        with self._mu:
            buf, self._buf = self._buf, []
        return buf


class MergedTraceEmitter:
    """Router-side merge of many processes onto one corrected
    timeline.

    Spans shipped by workers (:class:`SpanBuffer` wire dicts) and
    instants recovered from a victim's flight recorder land here,
    each under a *lane* — a worker name, or the shared ``transport``
    lane for cross-process transfer spans.  Every lane becomes a
    synthetic chrome process (``pid = LANE_PID_BASE + k`` with a
    ``process_name`` metadata event) so the single router dump shows
    router op/request lanes (real pid) next to per-worker and
    transport swimlanes.

    Clock model: all processes stamp ``time.perf_counter()``.  On one
    host that is the shared ``CLOCK_MONOTONIC``, so offsets measured
    by the handshake ping-pong are ~0 — the correction
    ``t_router = t_worker - offset`` is an identity there and becomes
    load-bearing exactly when workers move off-host.

    Same flush contract as :class:`RequestTraceEmitter`: batches are
    handed to the profiler and dropped either way; lane/request
    metadata re-emits per dump generation.  Thread-safe: the router's
    recv threads (one per worker) and the failover path all feed it —
    it carries its OWN lock so none of them needs the router lock to
    emit (memory-only staging under the lock; the profiler hand-off
    in ``flush`` is itself a locked list append on the profiler
    side).
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._pending: List[dict] = []
        self._lane_pids = {}            # lane name -> synthetic pid
        self._batch = set()             # (pid, rid) touched this batch
        self._batch_lanes = set()       # lane names touched this batch
        self._named = set()             # (pid, rid) named this trace
        self._named_lanes = set()
        self._gen = -1

    def _lane_pid(self, lane: str) -> int:
        pid = self._lane_pids.get(lane)
        if pid is None:
            pid = LANE_PID_BASE + len(self._lane_pids)
            self._lane_pids[lane] = pid
        return pid

    def add(self, lane: str, span: dict, offset_s: float = 0.0):
        """Stage one wire span under ``lane``, correcting its times
        by the lane process's clock offset (worker minus router)."""
        try:
            rid = int(span.get("rid", 0))
        except (TypeError, ValueError):
            rid = 0
        ev = {"name": str(span.get("name", "?")),
              "tid": REQ_TID_BASE + rid,
              "cat": str(span.get("cat", "serving"))}
        args = dict(span.get("args") or {})
        if span.get("trace_id") is not None:
            args["trace_id"] = span["trace_id"]
        if args:
            ev["args"] = args
        try:
            if span.get("ph") == "i":
                ev["ph"] = "i"
                ev["s"] = "t"
                ev["ts"] = (float(span["t"]) - offset_s) * 1e6
            else:
                t0 = float(span["t0"]) - offset_s
                t1 = float(span["t1"]) - offset_s
                ev["ph"] = "X"
                ev["ts"] = t0 * 1e6
                ev["dur"] = max(0.0, (t1 - t0) * 1e6)
        except (KeyError, TypeError, ValueError):
            return                      # malformed wire span: drop
        with self._mu:
            pid = self._lane_pid(lane)
            ev["pid"] = pid
            self._pending.append(ev)
            self._batch.add((pid, rid))
            self._batch_lanes.add(lane)

    def add_flight(self, lane: str, event: dict,
                   offset_s: float = 0.0):
        """Stage one recovered flight-recorder event as an instant on
        ``lane``: the post-mortem tail folded into the live trace."""
        args = {k: v for k, v in event.items()
                if k not in ("kind", "t", "seq", "rid")}
        args["seq"] = event.get("seq")
        self.add(lane, {"rid": event.get("rid", 0),
                        "name": "flight:%s" % event.get("kind", "?"),
                        "ph": "i", "t": event.get("t", 0.0),
                        "cat": "flight", "args": args}, offset_s)

    def flush(self) -> bool:
        """Hand the staged batch to the profiler; drop it either way
        (same generation-keyed metadata dance as
        :class:`RequestTraceEmitter.flush`).  The profiler hand-off
        happens under the emitter lock — ``record_events`` is a
        memory-only locked append on the profiler side, never a
        blocking call."""
        with self._mu:
            if not self._pending:
                return False
            gen = profiler.events_generation()
            if gen != self._gen:
                self._gen = gen
                self._named.clear()
                self._named_lanes.clear()
            meta = [{"name": "process_name", "ph": "M",
                     "pid": self._lane_pids[lane],
                     "args": {"name": lane}}
                    for lane in sorted(self._batch_lanes
                                       - self._named_lanes)]
            meta += [{"name": "thread_name", "ph": "M", "pid": pid,
                      "tid": REQ_TID_BASE + rid,
                      "args": {"name": "req %d" % rid}}
                     for pid, rid in sorted(self._batch
                                            - self._named)]
            ok = profiler.record_events(meta + self._pending)
            self._pending = []
            batch, self._batch = self._batch, set()
            lanes, self._batch_lanes = self._batch_lanes, set()
            if ok:
                self._named.update(batch)
                self._named_lanes.update(lanes)
            else:
                self._named.clear()
                self._named_lanes.clear()
            return ok
