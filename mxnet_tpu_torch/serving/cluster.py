"""Multi-replica serving cluster: an SLO-aware router over N engines.
Port of the in-process half of ``mxnet_tpu/serving/cluster.py``
(``ServingCluster``); the disaggregated cluster of worker processes
(``DisaggServingCluster``, ``run_worker``) is not ported yet.

The cluster owns N replicas (threads in this process, one
``ServingEngine`` and one prefix cache each) and gives clients one
asynchronous ``submit()``/``result()`` API.

* **Routing**: least-loaded, with **prefix affinity**.  The router keys
  each prompt's full-page prefix chains (``prefix_cache.chain_keys``)
  and sends a request whose prefix was recently routed somewhere back
  to that replica, as long as that replica's waiting queue is within
  ``affinity_slack`` of the shallowest, so a shared system prompt is
  prefilled once per replica it lands on, not once per request.
  Affinity never overrides health or a drained replica.
* **Admission**: the waiting set (router inboxes and engine queues) is
  bounded by ``max_queue``; ``submit()`` raises
  :class:`ClusterOverloaded`, with a ``retry_after_s`` hint, past it.
  A per-request ``ttl_s`` expires requests still waiting past their
  deadline (:class:`RequestExpired` from ``result()``); a request that
  started decoding is never expired.
* **Failover**: a replica whose worker raises fails itself over; a
  replica that stalls past ``watchdog_s`` while holding work is failed
  over by the monitor thread.  Either way its waiting and in-flight
  requests go to survivors with their committed tokens as prompt
  extension, the engine's recompute-exact resume, so under f32 greedy
  the output is token-identical to an undisturbed run.  A stalled
  replica's late step is fenced: a completion is matched against the
  request's current (replica, engine rid) under the cluster lock.
* **Drain and scale**: ``drain_replica(i)`` stops routing to a replica,
  reroutes its waiting requests, lets its in-flight ones finish and
  parks its worker; ``add_replica``/``remove_replica`` are the
  autoscaler's actuation (``serving/autoscaler.py``), the latter with a
  checked zero-leak contract; ``close()`` drains everything.

On the card, where the reference compiles one step program that every
replica shares, each replica captures its own CUDA graph over its own
KV pool, on its own stream:

* the weights are prepared once (``models/gpt.py prepare_params``) and
  every replica's engine, one added later included, holds the same
  device tensors, so a replica adds only its pool and step buffers;
* each replica runs its engine (scheduling, the pinned copies, the
  graph's replay and the token read-back events) on a CUDA stream of
  its own, so replicas do not serialise on the default stream;
* every replica is warmed (its graph captured) before any worker starts,
  and a replica added under load captures while the others replay: a
  capture runs in ``thread_local`` error mode and the launch counters
  keep other threads' replays aside until it ends (``_graphs.py``).

Clock: ``time.perf_counter`` throughout, the serving trace clock.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import profiler, resolve_device
from ..models import gpt as G
from .engine import ServingEngine
from .prefix_cache import chain_keys

__all__ = ["ServingCluster", "ClusterRequest", "ClusterOverloaded",
           "RequestExpired", "RequestCancelled", "ClusterClosed",
           "ClusterFailed"]

# rid blocks: replica i gives engine rids in [i*RID_BLOCK, ...), so
# request ids and trace lanes stay unique across the cluster
RID_BLOCK = 1 << 20


def _env_default(name, fallback, cast=float):
    """An operational limit's default from a ``MXNET_SERVE_*``
    variable: an explicit constructor argument wins, the variable only
    replaces the built-in default."""
    v = os.environ.get(name)
    if v is None or v == "":
        return fallback
    try:
        return cast(v)
    except ValueError:
        raise ValueError("%s=%r: expected %s"
                         % (name, v, cast.__name__))


class ClusterOverloaded(RuntimeError):
    """submit() refused: the bounded admission queue is full.

    ``retry_after_s`` estimates the time until the queue drains below
    the bound at the cluster's recent completion rate (an HTTP 429's
    Retry-After); it is also set on the ``cluster_retry_after_s`` gauge
    at each rejection."""

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestExpired(RuntimeError):
    """The request's TTL elapsed before it started decoding."""


class RequestCancelled(RuntimeError):
    """The request was cancelled through ``cancel(rid)`` before it
    finished; its slot and pages were released at once."""


class ClusterClosed(RuntimeError):
    """The cluster is closed (or lost every replica)."""


class ClusterFailed(RuntimeError):
    """No healthy replica remained to finish the request."""


class ClusterRequest:
    """Front-end request record.  ``committed`` accumulates tokens
    from failed-over incarnations; the live incarnation's engine
    request holds the rest."""
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id",
                 "deadline", "state", "replica", "engine_rid",
                 "committed", "output", "error", "done_evt",
                 "submit_t", "first_token_t", "token_times",
                 "affinity_keys", "failovers", "delivered",
                 "stream", "listeners", "cancel_req", "trace_id")

    def __init__(self, rid, prompt, max_new_tokens, eos_id, deadline,
                 affinity_keys, trace_id=None):
        self.rid = rid
        # a caller's trace context, by default one derived from the rid
        self.trace_id = trace_id if trace_id is not None \
            else "rid%d" % rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline = deadline
        self.state = "queued"   # queued|running|done|expired|failed|cancelled
        self.replica: Optional[int] = None
        self.engine_rid: Optional[int] = None
        self.committed: List[int] = []
        self.output: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done_evt = threading.Event()
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        # each token's commit time across ALL incarnations
        self.token_times: List[float] = []
        self.affinity_keys = affinity_keys
        self.failovers = 0
        self.delivered = False
        # the published token stream: what every attach_stream listener
        # has been handed, across incarnations; always a prefix of
        # committed + the live engine request's generated tokens, so a
        # failover resumes it with no gap and no repeat
        self.stream: List[int] = []
        self.listeners: List = []
        self.cancel_req = False


class _Replica:
    __slots__ = ("idx", "engine", "thread", "inbox", "wake",
                 "in_flight", "heartbeat", "alive", "draining", "dead",
                 "error", "drained_evt", "stream")

    def __init__(self, idx, engine, stream=None):
        self.idx = idx
        self.engine = engine
        # the CUDA stream the replica's engine runs on (None on the CPU)
        self.stream = stream
        self.thread: Optional[threading.Thread] = None
        self.inbox: "collections.deque[ClusterRequest]" = \
            collections.deque()
        self.wake = threading.Event()
        self.in_flight: Dict[int, ClusterRequest] = {}
        self.heartbeat = time.perf_counter()
        self.alive = True
        self.draining = False
        self.dead = False
        self.error: Optional[BaseException] = None
        self.drained_evt = threading.Event()

    @property
    def load(self):
        return len(self.inbox) + len(self.in_flight)

    @property
    def waiting(self):
        # inbox + engine-queued (advisory: admission control, not
        # correctness); a dead replica's abandoned engine queue does not
        # count against the admission budget
        if self.dead:
            return 0
        return len(self.inbox) + len(self.engine._queue)


class _ClusterObs:
    """Router-level instrument bundle (as the engine's ``_EngineObs``)."""

    _seq = [0]

    def __init__(self, registry=None):
        from .. import obs as O
        if registry is None:
            registry = O.MetricsRegistry(
                labels={"cluster": str(self._seq[0])})
            self._seq[0] += 1
            O.register_engine_registry(registry)
        self.registry = registry
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.submitted = c("cluster_requests_submitted_total",
                           "requests accepted by cluster submit()")
        self.rejected = c("cluster_requests_rejected_total",
                          "submissions refused by backpressure")
        self.expired = c("cluster_requests_expired_total",
                         "requests whose TTL elapsed while waiting")
        self.cancelled = c("cluster_cancelled_total",
                           "requests cancelled via cancel(rid) — "
                           "client disconnects propagated by the "
                           "HTTP front door, plus chaos 'cancel' "
                           "actions")
        self.completed = c("cluster_requests_completed_total",
                           "requests finished across all replicas")
        self.failovers = c("cluster_failovers_total",
                           "replica failures (raise or watchdog "
                           "stall) drained to survivors")
        self.resubmitted = c("cluster_requests_resubmitted_total",
                             "requests resubmitted after a replica "
                             "failure (recompute-exact resume)")
        self.routed_affinity = c("cluster_routed_affinity_total",
                                 "routing decisions won by prefix "
                                 "affinity")
        self.routed_least = c("cluster_routed_least_loaded_total",
                              "routing decisions by least-loaded")
        self.g_healthy = g("cluster_replicas_healthy",
                           "replicas accepting traffic")
        self.g_waiting = g("cluster_queue_depth",
                           "waiting requests (inboxes + engine "
                           "queues)")
        self.g_in_flight = g("cluster_in_flight",
                             "requests holding an engine slot or "
                             "engine queue entry")
        self.g_retry_after = g("cluster_retry_after_s",
                               "last Retry-After hint handed to a "
                               "rejected submit() (queue excess / "
                               "recent drain rate)")
        self.scale_ups = c("cluster_scale_ups_total",
                           "replicas added (add_replica)")
        self.scale_downs = c("cluster_scale_downs_total",
                             "replicas drained and released "
                             "(remove_replica)")
        self.h_ttft = h("cluster_ttft_ms",
                        help="cluster submit() -> first committed "
                             "token (any incarnation)")
        from ..obs import RequestTraceEmitter
        self.trace = RequestTraceEmitter()


class ServingCluster:
    """N in-process ``ServingEngine`` replicas behind one router.

    The engine sizing arguments (``num_slots``, ``page_size`` …) apply
    to EVERY replica.  ``prefix_cache`` defaults on (prefix-affinity
    routing exists for it); each replica has its own cache, so a shared
    prefix is prefilled once per replica.  ``spec_K``/``spec_drafter``/
    ``spec_ngram``, ``overlap`` and ``tier_bytes`` pass through to each
    replica; failover is unchanged by them, since committed tokens are
    committed tokens however many a step produced.  The whole engine
    configuration is kept once (``_engine_kwargs``), so a resubmission
    lands on a replica set up as the one that died.  ``kernel``, ``tp``
    and ``mesh`` go to the engines, which refuse them (not ported).
    ``device``: None means the CUDA device, ``"cpu"`` runs the engines'
    plain versions.
    """

    def __init__(self, params, cfg, *, replicas=2, num_slots,
                 page_size=16, num_pages=None, pages_per_slot=None,
                 prefill_chunk=8, kv_int8=False, prefix_cache=True,
                 metrics=None, registry=None, max_queue=None,
                 watchdog_s=None, default_ttl_s=None,
                 affinity_slack=None,
                 affinity_capacity=4096, retain_results=4096,
                 kernel=None, spec_K=0, spec_drafter="ngram",
                 spec_ngram=2, tp=1, mesh=None, tier_bytes=None,
                 overlap=None, device=None):
        if replicas < 1:
            raise ValueError("ServingCluster: replicas must be >= 1")
        self.num_slots = num_slots
        self.page_size = page_size
        # operational limits: explicit argument > MXNET_SERVE_* variable
        # > built-in default
        if max_queue is None:
            max_queue = _env_default("MXNET_SERVE_MAX_QUEUE", 256,
                                     int)
        if watchdog_s is None:
            watchdog_s = _env_default("MXNET_SERVE_WATCHDOG_S", 30.0)
        if default_ttl_s is None:
            default_ttl_s = _env_default("MXNET_SERVE_TTL_S", None)
        self.max_queue = int(max_queue)
        self.watchdog_s = float(watchdog_s)
        self.default_ttl_s = default_ttl_s
        self.prefix_enabled = bool(prefix_cache)
        # affinity may leave the favoured replica at most this many
        # WAITING requests deeper than the shallowest queue: a hot
        # prefix must not build a queue behind one replica while others
        # idle (hit ratio bought with TTFT)
        self.affinity_slack = (max(1, num_slots // 4)
                               if affinity_slack is None
                               else int(affinity_slack))
        self._lock = threading.RLock()
        self._closed = False
        self._next_rid = 0
        self.requests: Dict[int, ClusterRequest] = {}
        # terminal requests are retained (rid order) up to this many,
        # then the delivered ones are dropped
        self._retain = int(retain_results)
        self._terminal: "collections.deque[int]" = collections.deque()
        # prefix-chain key -> replica idx (LRU-capped)
        self._affinity: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._affinity_cap = int(affinity_capacity)
        if metrics is None:
            metrics = registry is not None or \
                os.environ.get("MXNET_SERVING_METRICS", "0") == "1"
        self._obs = _ClusterObs(registry) if metrics else None
        self.device = resolve_device(device)
        # the weights, prepared once: every replica's engine (one added
        # later too) takes these tensors as they are (prepare_params is
        # idempotent), so a replica adds its pool and buffers only
        with torch.inference_mode():
            params = G.prepare_params(params, cfg, self.device)
        self._engine_kwargs = dict(
            num_slots=num_slots, page_size=page_size,
            num_pages=num_pages, pages_per_slot=pages_per_slot,
            prefill_chunk=prefill_chunk, kv_int8=kv_int8,
            prefix_cache=prefix_cache, metrics=bool(metrics),
            kernel=kernel, spec_K=spec_K, spec_drafter=spec_drafter,
            spec_ngram=spec_ngram, tp=tp, mesh=mesh,
            tier_bytes=tier_bytes, overlap=overlap, device=self.device)
        self._params, self._cfg = params, cfg
        self._rid_blocks = replicas       # next replica's rid block
        # recent completion times: the drain rate behind
        # ClusterOverloaded.retry_after_s
        self._completions: "collections.deque[float]" = \
            collections.deque(maxlen=256)
        # set by an attaching Autoscaler: the zero-replica state is then
        # recoverable (it scales back up below min_size), so requests
        # stranded by the last replica's death PARK here instead of
        # failing, and add_replica reroutes them
        self.scaler_attached = False
        self._orphans: "collections.deque[ClusterRequest]" = \
            collections.deque()
        self.replicas: List[_Replica] = []
        self._streams_building = set()
        # every replica warmed (on the card: its step graph captured)
        # BEFORE any worker or the watchdog starts: a first step slower
        # than watchdog_s would read as a stall
        for i in range(replicas):
            self.replicas.append(self._build_replica(i, i))
        # submit()-side validation limit, kept once (replica 0's engine
        # may be released by a later scale-down)
        self._max_seq = self.replicas[0].engine.max_seq
        for rep in self.replicas:
            self._start(rep)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="serving-cluster-monitor")
        self._monitor.start()
        # publish the healthy count now: an autoscaler attached to an
        # idle fresh cluster would otherwise read healthy=0 and scale up
        if self._obs is not None:
            with self._lock:
                self._sync_gauges_locked()

    def _on(self, stream):
        """The replica's stream made current (nothing on the CPU)."""
        return contextlib.nullcontext() if stream is None \
            else torch.cuda.stream(stream)

    def _new_stream(self):
        """A CUDA stream no replica runs on (torch hands out streams from
        a pool, round robin), or None on the CPU."""
        if self.device.type != "cuda":
            return None
        with self._lock:
            taken = {r.stream.cuda_stream for r in self.replicas
                     if r.stream is not None and r.engine is not None}
            taken |= self._streams_building
            for _ in range(64):
                stream = torch.cuda.Stream(self.device)
                if stream.cuda_stream not in taken:
                    self._streams_building.add(stream.cuda_stream)
                    return stream
        raise RuntimeError("ServingCluster: no free CUDA stream")

    def _build_replica(self, idx, block):
        """A warmed replica with engine rids from rid block ``block``,
        built, warmed and captured on a stream of its own."""
        stream = self._new_stream()
        try:
            with self._on(stream):
                eng = ServingEngine(self._params, self._cfg,
                                    rid_start=block * RID_BLOCK,
                                    **self._engine_kwargs)
                self._warm_engine(eng)
        finally:
            if stream is not None:
                with self._lock:
                    self._streams_building.discard(stream.cuda_stream)
        return _Replica(idx, eng, stream)

    def _start(self, rep):
        rep.thread = threading.Thread(
            target=self._worker, args=(rep,), daemon=True,
            name="serving-replica-%d" % rep.idx)
        rep.thread.start()

    @staticmethod
    def _warm_engine(eng):
        """Run an engine's first step (its capture) outside the serving
        clock, then zero the warm-up's footprint from its stats."""
        wid = eng.submit(np.ones(1, np.int32), 1)
        eng.run()
        del eng.requests[wid]
        for k in eng.stats:
            eng.stats[k] = type(eng.stats[k])()
        if eng.metrics_enabled:
            eng.reset_metrics()

    # ------------------------------------------------------- intake --
    def submit(self, prompt, max_new_tokens, eos_id=None, ttl_s=None,
               trace_id=None):
        """Queue a request; returns its cluster rid at once.  Raises
        :class:`ClusterOverloaded` when the bounded admission queue is
        full and :class:`ClusterClosed` after close()."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        # validated here, in the caller's thread, with the engine's own
        # rules: a request the engines would refuse must fail submit(),
        # not a replica's worker later
        if prompt.size < 1:
            raise ValueError("submit: empty prompt")
        if max_new_tokens < 1:
            raise ValueError("submit: max_new_tokens must be >= 1")
        total = prompt.size + int(max_new_tokens)
        if total > self._max_seq:
            raise ValueError(
                "submit: %d tokens > replica max_seq %d"
                % (total, self._max_seq))
        if total > self._cfg.max_len:
            raise ValueError("submit: %d tokens > cfg.max_len=%d"
                             % (total, self._cfg.max_len))
        keys = chain_keys(prompt, self.page_size) \
            if self.prefix_enabled else []
        with self._lock:
            if self._closed:
                raise ClusterClosed("submit() after close()")
            if not self._healthy():
                if self.scaler_attached:
                    # the autoscaler restores min capacity: refuse
                    # retryably, with a recovery-based hint (the
                    # queue-drain formula would read ~1 ms on a shallow
                    # queue while a scale-up takes far longer)
                    hint = max(0.05, self.watchdog_s / 4.0)
                    if self._obs is not None:
                        self._obs.rejected.inc()
                        self._obs.g_retry_after.set(hint)
                    raise ClusterOverloaded(
                        "no healthy replicas (self-heal pending); "
                        "retry after %.3fs" % hint,
                        retry_after_s=hint)
                raise ClusterClosed("no healthy replicas")
            waiting = sum(r.waiting for r in self.replicas)
            if waiting >= self.max_queue:
                hint = self._retry_after_locked(waiting)
                if self._obs is not None:
                    self._obs.rejected.inc()
                    self._obs.g_retry_after.set(hint)
                raise ClusterOverloaded(
                    "admission queue full (%d waiting >= max_queue "
                    "%d); retry after %.3fs"
                    % (waiting, self.max_queue, hint),
                    retry_after_s=hint)
            if ttl_s is None:
                ttl_s = self.default_ttl_s
            deadline = None if ttl_s is None \
                else time.perf_counter() + float(ttl_s)
            cr = ClusterRequest(self._next_rid, prompt,
                                int(max_new_tokens), eos_id, deadline,
                                keys, trace_id=trace_id)
            self._next_rid += 1
            self.requests[cr.rid] = cr
            rep = self._route_locked(cr)
            rep.inbox.append(cr)
            cr.replica = rep.idx
            if self._obs is not None:
                self._obs.submitted.inc()
                self._sync_gauges_locked()
            rep.wake.set()
        return cr.rid

    def result(self, rid, timeout=None):
        """Block until the request finishes; returns the full token
        array (prompt + generated).  Raises :class:`RequestExpired`,
        :class:`RequestCancelled` or :class:`ClusterFailed` by its end,
        TimeoutError on timeout."""
        cr = self.requests.get(rid)
        if cr is None:
            raise KeyError(
                "result(%d): unknown rid (already collected and "
                "purged past retain_results?)" % rid)
        if not cr.done_evt.wait(timeout):
            raise TimeoutError("result(%d): still running" % rid)
        with self._lock:
            cr.delivered = True
            self._purge_locked()
        if cr.state == "done":
            return cr.output
        if cr.state == "expired":
            raise RequestExpired("request %d expired before "
                                 "admission" % rid)
        if cr.state == "cancelled":
            raise RequestCancelled("request %d was cancelled" % rid)
        raise ClusterFailed("request %d: %r" % (rid, cr.error))

    def drain(self, timeout=None):
        """Wait until every submitted request is finished one way or
        another.  Returns True if all are."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        for cr in list(self.requests.values()):
            left = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            if not cr.done_evt.wait(left):
                return False
        return True

    # ---------------------------------------------------- streaming --
    def attach_stream(self, rid, cb):
        """Register a token-stream listener for one request.  ``cb``
        gets, in order, ``("tokens", [int, ...])`` for each batch of
        newly committed tokens (the backlog at once, so a late attach
        misses none), then exactly one ``("done", output_array)`` or
        ``("error", exc)``.  Callbacks run on the cluster's worker
        threads under the cluster lock: they must be quick and must not
        block."""
        with self._lock:
            cr = self.requests.get(rid)
            if cr is None:
                raise KeyError("attach_stream(%d): unknown rid" % rid)
            if cr.stream:
                cb(("tokens", list(cr.stream)))
            if cr.state in ("queued", "running"):
                cr.listeners.append(cb)
            else:
                cr.delivered = True        # terminal event handed out
                cb(self._terminal_event(cr))

    @staticmethod
    def _terminal_event(cr):
        if cr.state == "done":
            return ("done", cr.output)
        if cr.state == "expired":
            return ("error", RequestExpired(
                "request %d expired before admission" % cr.rid))
        if cr.state == "cancelled":
            return ("error", RequestCancelled(
                "request %d was cancelled" % cr.rid))
        return ("error", cr.error if cr.error is not None else
                ClusterFailed("request %d failed" % cr.rid))

    def _publish_tokens_locked(self, cr, ereq=None):
        """Hand listeners every token not yet published: the stream so
        far is ``committed`` (kept across failovers) plus the live
        incarnation's ``generated``, and ``cr.stream`` is its published
        prefix, so a failover's fold never repeats or drops a token."""
        full = list(cr.committed)
        if ereq is not None:
            full.extend(int(t) for t in ereq.generated)
        new = full[len(cr.stream):]
        if new:
            cr.stream.extend(new)
            for cb in cr.listeners:
                cb(("tokens", new))

    def _finish_locked(self, cr):
        """The end of every path that finishes a request: publish any
        token left, deliver the one terminal stream event, wake
        ``result()``.  A listener's terminal event IS the delivery, so
        the request counts as delivered for ``_purge_locked``."""
        self._publish_tokens_locked(cr)
        if cr.listeners:
            cr.delivered = True
        for cb in cr.listeners:
            cb(self._terminal_event(cr))
        cr.listeners = []
        cr.done_evt.set()

    def _publish_running(self, rep):
        """Each step's tokens of this replica's in-flight requests to
        their listeners (nothing to do when nobody listens)."""
        with self._lock:
            for erid, cr in rep.in_flight.items():
                if not cr.listeners or cr.state != "running":
                    continue
                self._publish_tokens_locked(
                    cr, rep.engine.requests.get(erid))

    # ------------------------------------------------------- cancel --
    def cancel(self, rid):
        """Cancel a request end to end (a client's disconnect, or a
        chaos action).  A WAITING request is dropped at once; a RUNNING
        one is flagged, and its replica's worker releases the slot and
        pages on its own thread before its next step (the engine is
        single-threaded state).  Returns True if the cancel took (or
        will take) effect, False if the request had already finished;
        its output then stays retrievable."""
        with self._lock:
            cr = self.requests.get(rid)
            if cr is None:
                raise KeyError("cancel(%d): unknown rid" % rid)
            if cr.state not in ("queued", "running"):
                return False
            if cr.state == "queued":
                for rep in self.replicas:
                    try:
                        rep.inbox.remove(cr)
                        break
                    except ValueError:
                        pass
                try:
                    self._orphans.remove(cr)
                except ValueError:
                    pass
                self._cancel_now_locked(cr)
                return True
            cr.cancel_req = True
            rep = self.replicas[cr.replica]
            rep.wake.set()
            return True

    def _cancel_now_locked(self, cr):
        cr.state = "cancelled"
        self._retire_locked(cr)
        if self._obs is not None:
            self._obs.cancelled.inc()
            self._sync_gauges_locked()
        self._finish_locked(cr)

    def _sweep_cancels(self, rep):
        """Apply pending cancels on THIS replica's worker thread, between
        steps: ``engine.cancel`` frees the slot and pages at once."""
        with self._lock:
            pend = [(erid, cr) for erid, cr in rep.in_flight.items()
                    if cr.cancel_req and cr.state == "running"]
            for erid, cr in pend:
                del rep.in_flight[erid]
                ereq = rep.engine.requests.get(erid)
                if ereq is not None:
                    # fold the live incarnation's tokens into the
                    # committed log, so the partial output is a strict
                    # prefix of the oracle's
                    cr.committed.extend(int(t)
                                        for t in list(ereq.generated))
                    cr.token_times.extend(ereq.token_times)
                    rep.engine.cancel(erid)
                    del rep.engine.requests[erid]
                self._cancel_now_locked(cr)

    # ------------------------------------------------------ routing --
    def _healthy(self):
        return [r for r in self.replicas
                if r.alive and not r.draining]

    def _route_locked(self, cr):
        healthy = self._healthy()
        if not healthy:
            raise ClusterClosed("no healthy replicas")
        min_wait = min(r.waiting for r in healthy)
        target = None
        # the longest registered prefix wins (deepest first)
        for key in reversed(cr.affinity_keys):
            idx = self._affinity.get(key)
            if idx is None:
                continue
            rep = self.replicas[idx]
            if rep.alive and not rep.draining \
                    and rep.waiting <= min_wait + self.affinity_slack:
                target = rep
                self._affinity.move_to_end(key)
                if self._obs is not None:
                    self._obs.routed_affinity.inc()
                break
        if target is None:
            target = min(healthy, key=lambda r: (r.load, r.idx))
            if self._obs is not None:
                self._obs.routed_least.inc()
        for key in cr.affinity_keys:
            self._affinity[key] = target.idx
            self._affinity.move_to_end(key)
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)
        return target

    def _retry_after_locked(self, waiting):
        """Retry-After hint for a refused submit(): the time for the
        queue's excess over the bound (plus one request) to drain at the
        recent completion rate, at most one watchdog period; with no
        recent completions, a quarter of it."""
        now = time.perf_counter()
        comp = self._completions
        # a rate across an idle gap would hand a busy-again cluster an
        # hours-long hint
        horizon = now - max(5.0, self.watchdog_s)
        while comp and comp[0] < horizon:
            comp.popleft()
        if len(comp) >= 2 and now > comp[0]:
            rate = (len(comp) - 1) / (now - comp[0])
            excess = waiting - self.max_queue + 1
            return min(self.watchdog_s,
                       max(0.001, excess / max(rate, 1e-6)))
        return max(0.001, self.watchdog_s / 4.0)

    def _retire_locked(self, cr):
        """Remember a finished rid; past ``retain_results`` the oldest
        DELIVERED ones are dropped (a result not yet collected never
        is)."""
        self._terminal.append(cr.rid)
        self._purge_locked()

    def _purge_locked(self):
        excess = len(self._terminal) - self._retain
        if excess <= 0:
            return
        kept: "collections.deque[int]" = collections.deque()
        for rid in self._terminal:
            req = self.requests.get(rid)
            if excess > 0 and (req is None or req.delivered):
                excess -= 1
                if req is not None:
                    del self.requests[rid]
            else:
                kept.append(rid)
        self._terminal = kept

    def _sync_gauges_locked(self):
        obs = self._obs
        if obs is None:
            return
        obs.g_healthy.set(len(self._healthy()))
        obs.g_waiting.set(sum(r.waiting for r in self.replicas))
        obs.g_in_flight.set(
            sum(len(r.in_flight) for r in self.replicas))

    # ------------------------------------------------------- worker --
    def _worker(self, rep):
        with self._on(rep.stream):
            self._serve(rep)

    def _serve(self, rep):
        eng = rep.engine
        while True:
            rep.heartbeat = time.perf_counter()
            if rep.dead:
                return
            try:
                self._pump_inbox(rep)
                self._sweep_cancels(rep)
                finished = eng.step()
            except Exception as e:                  # replica death
                self._fail_replica(rep, e)
                return
            rep.heartbeat = time.perf_counter()
            if finished is not False:
                self._publish_running(rep)
            if finished is False:
                with self._lock:
                    idle = not rep.inbox and not rep.in_flight
                    if idle and (rep.draining or self._closed):
                        rep.alive = False
                        rep.drained_evt.set()
                        self._sync_gauges_locked()
                        return
                rep.wake.wait(timeout=0.02)
                rep.wake.clear()
            elif finished:
                for erid in finished:
                    self._complete(rep, erid)

    def _pump_inbox(self, rep):
        """Move waiting requests into the engine, at most one engine
        queue's worth, so TTL expiry keeps its meaning (the engine queue
        is this thread's, the inbox the cluster's)."""
        eng = rep.engine
        while True:
            with self._lock:
                if not rep.inbox or rep.dead:
                    return
                if len(eng._queue) >= self.num_slots:
                    return
                cr = rep.inbox.popleft()
                if cr.cancel_req:
                    # cancelled while queued on a failover or drain
                    # reroute (a directly queued cancel leaves the inbox
                    # inside cancel() itself)
                    self._cancel_now_locked(cr)
                    continue
                now = time.perf_counter()
                if cr.deadline is not None and now > cr.deadline \
                        and not cr.committed:
                    cr.state = "expired"
                    self._retire_locked(cr)
                    if self._obs is not None:
                        self._obs.expired.inc()
                        self._sync_gauges_locked()
                    self._finish_locked(cr)
                    continue
                prompt = cr.prompt if not cr.committed else \
                    np.concatenate([cr.prompt,
                                    np.asarray(cr.committed,
                                               np.int32)])
                try:
                    erid = eng.submit(
                        prompt, cr.max_new_tokens - len(cr.committed),
                        eos_id=cr.eos_id, trace_id=cr.trace_id)
                except Exception as e:
                    # a request THIS engine refuses (submit() validated
                    # it already) fails alone, not the worker
                    cr.state = "failed"
                    cr.error = e
                    self._retire_locked(cr)
                    self._finish_locked(cr)
                    continue
                cr.state = "running"
                cr.replica = rep.idx
                cr.engine_rid = erid
                rep.in_flight[erid] = cr
                if self._obs is not None:
                    self._sync_gauges_locked()

    def _complete(self, rep, erid):
        with self._lock:
            cr = rep.in_flight.pop(erid, None)
            if cr is None or rep.dead:
                return                      # fenced zombie completion
            if cr.state != "running" or cr.replica != rep.idx \
                    or cr.engine_rid != erid:
                return
            ereq = rep.engine.requests[erid]
            if cr.cancel_req:
                # a cancel raced the finishing step: cancel() already
                # returned True, so the cancel wins; fold the tokens so
                # a late listener and the oracle's prefix check see them
                cr.committed.extend(int(t)
                                    for t in list(ereq.generated))
                cr.token_times.extend(ereq.token_times)
                del rep.engine.requests[erid]
                self._cancel_now_locked(cr)
                return
            self._publish_tokens_locked(cr, ereq)
            cr.output = ereq.output
            cr.state = "done"
            cr.token_times.extend(ereq.token_times)
            self._completions.append(time.perf_counter())
            if cr.first_token_t is None and ereq.token_times:
                cr.first_token_t = ereq.token_times[0]
            # the engine's record is copied out: drop it, so a replica
            # does not keep one Request per request it ever served
            del rep.engine.requests[erid]
            self._retire_locked(cr)
            if self._obs is not None:
                self._obs.completed.inc()
                if cr.first_token_t is not None:
                    self._obs.h_ttft.observe(
                        (cr.first_token_t - cr.submit_t) * 1e3)
                self._sync_gauges_locked()
            self._finish_locked(cr)

    # ----------------------------------------------------- failover --
    def _fail_replica(self, rep, error):
        """Take a dead or stalled replica out of rotation and resubmit
        its waiting and in-flight requests to survivors through the
        recompute-exact resume.  Idempotent under the lock (the worker's
        own exception and the monitor's watchdog can race here)."""
        with self._lock:
            if rep.dead:
                return
            rep.dead = True
            rep.alive = False
            rep.error = error
            strays = list(rep.inbox)
            rep.inbox.clear()
            in_flight = list(rep.in_flight.items())
            rep.in_flight.clear()
            obs = self._obs
            if obs is not None:
                obs.failovers.inc()
            tracing = obs is not None and profiler.is_recording()
            now = time.perf_counter()
            survivors = self._healthy()
            for erid, cr in in_flight:
                # snapshot the committed tokens (greedy decode makes any
                # snapshot exact: the resumed run regenerates the rest)
                ereq = rep.engine.requests.get(erid)
                if ereq is not None:
                    cr.committed.extend(int(t)
                                        for t in list(ereq.generated))
                    cr.token_times.extend(ereq.token_times)
                    if cr.first_token_t is None and ereq.token_times:
                        cr.first_token_t = ereq.token_times[0]
                cr.failovers += 1
                if tracing:
                    obs.trace.add_instant(
                        cr.rid, "failover", now,
                        args={"replica": rep.idx,
                              "committed": len(cr.committed)})
            for cr in strays + [cr for _, cr in in_flight]:
                if cr.state not in ("queued", "running"):
                    continue
                if cr.cancel_req:
                    # a cancel raced the failover: the client is gone,
                    # so the cancel beats a resubmission
                    self._cancel_now_locked(cr)
                    continue
                done = (cr.eos_id is not None
                        and cr.eos_id in cr.committed) or \
                    len(cr.committed) >= cr.max_new_tokens
                if done:
                    cr.output = np.concatenate(
                        [cr.prompt,
                         np.asarray(cr.committed, np.int32)])
                    cr.state = "done"
                    self._completions.append(now)
                    self._retire_locked(cr)
                    if obs is not None:
                        obs.completed.inc()
                    self._finish_locked(cr)
                    continue
                cr.state = "queued"
                cr.engine_rid = None
                if not survivors:
                    if self.scaler_attached and not self._closed:
                        # recoverable: park the request; add_replica
                        # reroutes it, close() fails it if none comes
                        self._orphans.append(cr)
                        continue
                    cr.state = "failed"
                    cr.error = error
                    self._retire_locked(cr)
                    self._finish_locked(cr)
                    continue
                target = self._route_locked(cr)
                target.inbox.append(cr)
                cr.replica = target.idx
                target.wake.set()
                if obs is not None:
                    obs.resubmitted.inc()
                    if tracing:
                        obs.trace.add_instant(
                            cr.rid, "resubmit", now,
                            args={"replica": target.idx})
            if tracing:
                obs.trace.flush()
            if obs is not None:
                self._sync_gauges_locked()

    def _monitor_loop(self):
        period = max(0.01, min(0.25, self.watchdog_s / 4.0))
        while True:
            time.sleep(period)
            with self._lock:
                if self._closed and all(not r.alive
                                        for r in self.replicas):
                    return
                now = time.perf_counter()
                stalled = [
                    r for r in self.replicas
                    if r.alive and not r.dead
                    and (r.in_flight or r.inbox)
                    and now - r.heartbeat > self.watchdog_s]
            for rep in stalled:
                self._fail_replica(
                    rep, RuntimeError(
                        "replica %d stalled past watchdog %.3fs"
                        % (rep.idx, self.watchdog_s)))

    # -------------------------------------------- drain / scale-down --
    def drain_replica(self, idx, timeout=None):
        """Graceful scale-down of one replica: stop routing to it,
        reroute its waiting requests, let its in-flight ones finish,
        park its worker.  Returns True once drained."""
        rep = self.replicas[idx]
        with self._lock:
            rep.draining = True
            strays = list(rep.inbox)
            rep.inbox.clear()
            for cr in strays:
                if cr.state != "queued":
                    continue
                target = self._route_locked(cr)
                target.inbox.append(cr)
                cr.replica = target.idx
                target.wake.set()
            if self._obs is not None:
                self._sync_gauges_locked()
        rep.wake.set()
        return rep.drained_evt.wait(timeout)

    # ---------------------------------------------- scale up / down --
    def add_replica(self):
        """Scale-up actuation (``serving/autoscaler.py``): build ONE
        more replica from the kept engine configuration and the shared
        weights, warm it (on the card: capture its step while the other
        replicas keep replaying theirs) outside the cluster lock, and
        put it in rotation.  Returns its index."""
        with self._lock:
            if self._closed:
                raise ClusterClosed("add_replica() after close()")
            block = self._rid_blocks
            self._rid_blocks += 1
        rep = self._build_replica(None, block)
        with self._lock:
            added = not self._closed
            if added:
                rep.idx = len(self.replicas)
                self.replicas.append(rep)
                self._start(rep)
                # requests stranded by a total loss ride the new
                # capacity (their committed tokens already snapshotted)
                while self._orphans:
                    cr = self._orphans.popleft()
                    if cr.state != "queued":
                        continue
                    target = self._route_locked(cr)
                    target.inbox.append(cr)
                    cr.replica = target.idx
                    target.wake.set()
                    if self._obs is not None:
                        self._obs.resubmitted.inc()
                if self._obs is not None:
                    self._obs.scale_ups.inc()
                    self._sync_gauges_locked()
        if not added:
            # lost the race with close(): release the never-published
            # engine's cached pages before dropping it
            if rep.engine.prefix is not None:
                rep.engine.prefix.clear()
            raise ClusterClosed("add_replica() after close()")
        return rep.idx

    def remove_replica(self, idx=None, timeout=None):
        """Scale-down actuation: drain one replica (the least-loaded
        healthy one unless ``idx`` names it), check that it leaked
        nothing, and release its engine (its KV pool).  Never removes
        the last healthy replica.  Returns the removed index, or None if
        no replica was eligible or the drain timed out.  A prefix ref or
        a page still held after the drain raises RuntimeError."""
        with self._lock:
            healthy = self._healthy()
            if len(healthy) <= 1:
                return None
            if idx is None:
                idx = min(healthy, key=lambda r: (r.load, -r.idx)).idx
            elif not any(r.idx == idx for r in healthy):
                return None
        if not self.drain_replica(idx, timeout) \
                and not self.replicas[idx].drained_evt.is_set():
            # timed out with work in flight: back in rotation (a replica
            # left draining would shrink capacity without being freed)
            with self._lock:
                rep = self.replicas[idx]
                if rep.alive and not rep.dead:
                    rep.draining = False
                    rep.wake.set()
            return None
        rep = self.replicas[idx]
        eng = rep.engine
        leaked_refs = 0 if eng.prefix is None else eng.prefix.refs_total
        if eng.prefix is not None:
            eng.prefix.clear()
        in_use = eng.cache.pages_in_use
        if leaked_refs or in_use:
            raise RuntimeError(
                "remove_replica(%d): %d prefix refs / %d pages still "
                "held after drain — scale-down would leak" %
                (idx, leaked_refs, in_use))
        eng.close()                       # retire any planner thread
        with self._lock:
            rep.dead = True               # waiting -> 0, never routed
            rep.engine = None             # release the pool and graph
            if self._obs is not None:
                self._obs.scale_downs.inc()
                self._sync_gauges_locked()
        return idx

    def detach_scaler(self):
        """The attached autoscaler is going away: requests parked for a
        scale-up that will never come fail now instead of leaving their
        result() waiters hanging."""
        with self._lock:
            self.scaler_attached = False
            while self._orphans:
                cr = self._orphans.popleft()
                if cr.state != "queued":
                    continue
                cr.state = "failed"
                cr.error = ClusterFailed(
                    "request %d: parked for scale-up but the "
                    "autoscaler detached" % cr.rid)
                self._retire_locked(cr)
                self._finish_locked(cr)

    # the autoscaler's actuation protocol: scale_up() -> bool,
    # scale_down() -> bool
    def scale_up(self):
        self.add_replica()
        return True

    def scale_down(self, timeout=60.0):
        return self.remove_replica(timeout=timeout) is not None

    @property
    def slots_per_replica(self):
        return self.num_slots

    def close(self, timeout=None):
        """Drain every replica and stop the monitor.  In-flight work
        finishes first (the watchdog still covers a replica that stalls
        during shutdown)."""
        with self._lock:
            self._closed = True
            # parked requests will never see new capacity now
            while self._orphans:
                cr = self._orphans.popleft()
                if cr.state != "queued":
                    continue
                cr.state = "failed"
                cr.error = ClusterClosed(
                    "cluster closed with the request parked for "
                    "scale-up")
                self._retire_locked(cr)
                self._finish_locked(cr)
        for rep in self.replicas:
            rep.wake.set()
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout)
        for rep in self.replicas:
            if rep.engine is not None:
                rep.engine.close()        # an overlap engine's planner
        self._monitor.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # --------------------------------------------------- accounting --
    def health(self):
        """Per-replica health snapshot."""
        now = time.perf_counter()
        with self._lock:
            return [{"replica": r.idx, "alive": r.alive,
                     "draining": r.draining, "dead": r.dead,
                     "load": r.load, "waiting": r.waiting,
                     "in_flight": len(r.in_flight),
                     "heartbeat_age_s": now - r.heartbeat,
                     "error": repr(r.error) if r.error else None}
                    for r in self.replicas]

    def debug_status(self):
        """Operations snapshot (``GET /debug/statusz``): the replicas'
        health and the live requests.  JSON-able, read-only."""
        now = time.perf_counter()
        with self._lock:
            reqs = []
            for cr in self.requests.values():
                if cr.state not in ("queued", "running"):
                    continue
                reqs.append({
                    "rid": cr.rid, "trace_id": cr.trace_id,
                    "state": cr.state, "replica": cr.replica,
                    # the published stream's length, across failovers
                    "tokens": len(cr.stream),
                    "failovers": cr.failovers,
                    "ttft_ms": None if cr.first_token_t is None
                    else (cr.first_token_t - cr.submit_t) * 1e3,
                    "age_s": now - cr.submit_t})
            return {"kind": "inproc", "closed": self._closed,
                    "replicas": self.health(), "requests": reqs}

    @property
    def registry(self):
        return self._obs.registry if self._obs is not None else None

    def metrics(self):
        """JSON-able snapshot: the router's counters and each live
        replica's engine snapshot."""
        if self._obs is None:
            return {"enabled": False}
        snap = self._obs.registry.snapshot()
        snap["enabled"] = True
        snap["replicas"] = [r.engine.metrics() for r in self.replicas
                            if r.engine is not None]
        return snap
