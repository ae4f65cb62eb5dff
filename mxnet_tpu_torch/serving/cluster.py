"""Multi-replica serving cluster: an SLO-aware router over N engines.
Port of ``mxnet_tpu/serving/cluster.py``: the in-process
``ServingCluster``, and the disaggregated ``DisaggServingCluster`` of
worker processes with ``run_worker`` (bottom of this module).

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

:class:`DisaggServingCluster` runs a router in THIS process and N
prefill + M decode workers as spawned OS processes, wired by
``serving/transport.py`` over the ``parallel/dist.py`` raw frames.  A
prefill worker runs chunked prefill only and streams the finished KV
pages to its request's decode worker (``serving/page_streamer.py``,
pipelined with the prefill chunks); the decode worker installs them and
adopts the request at ``n_cached = prompt_len``.  The router's
:class:`prefix_cache.ClusterPrefixIndex` knows which worker holds each
prefix chain; a worker matching another's chain fetches its pages peer
to peer instead of prefilling them again.  A worker's death (SIGKILL,
a crash, a stall past the watchdog) resubmits its requests to the
survivors with their streamed tokens as prompt extension, the same
recompute-exact resume as in process.  Every worker runs its own
engine, with its own copy of the weights and, on the card, its own
captured step, so the paged-attention kernel runs in each of them.

Clock: ``time.perf_counter`` throughout, the serving trace clock.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import queue
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import profiler, resolve_device
from ..models import gpt as G
from ..parallel.mesh import mesh_device
from .engine import ServingEngine
from .prefix_cache import ClusterPrefixIndex, chain_keys
from .transport import PUT_STATS

__all__ = ["ServingCluster", "ClusterRequest", "ClusterOverloaded",
           "RequestExpired", "RequestCancelled", "ClusterClosed",
           "ClusterFailed", "DisaggServingCluster", "run_worker"]

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
    and ``mesh`` go to the engines, which take a mesh whose axes all
    have size 1 (every replica on its device) and refuse ``kernel`` and
    ``tp > 1`` (not ported).  ``device``: None means the CUDA device
    (or the mesh's), ``"cpu"`` runs the engines' plain versions.  MoE
    params reach every replica like any other: the one prepared tree.
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
        self.device = mesh_device(mesh, "ServingCluster", device)
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


# ===========================================================================
# Disaggregated prefill/decode serving: worker PROCESSES streaming KV
# pages, with a cluster-level prefix index
# ===========================================================================

class _DisaggObs:
    """Router-side instrument bundle of the disaggregated cluster."""

    _seq = [0]

    def __init__(self, registry=None):
        from .. import obs as O
        if registry is None:
            registry = O.MetricsRegistry(
                labels={"disagg": str(self._seq[0])})
            self._seq[0] += 1
            O.register_engine_registry(registry)
        self.registry = registry
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.submitted = c("cluster_requests_submitted_total",
                           "requests accepted by cluster submit()")
        self.cancelled = c("cluster_cancelled_total",
                           "requests cancelled via cancel(rid) — "
                           "client disconnects propagated by the "
                           "HTTP front door, plus chaos 'cancel' "
                           "actions")
        self.completed = c("cluster_requests_completed_total",
                           "requests finished across all workers")
        self.failovers = c("cluster_failovers_total",
                           "worker-process failures (SIGKILL, crash, "
                           "or watchdog stall) failed over")
        self.resubmitted = c("cluster_requests_resubmitted_total",
                             "requests resubmitted after a worker "
                             "death (recompute-exact resume)")
        self.page_bytes = c("cluster_page_bytes_streamed_total",
                            "KV page bytes moved between worker "
                            "processes (prefill->decode streams + "
                            "peer prefix fetches)")
        self.pages_streamed = c("cluster_pages_streamed_total",
                                "KV pages moved between worker "
                                "processes")
        self.remote_hits = c("serving_prefix_remote_hits_total",
                             "prefix chains fetched from another "
                             "replica instead of re-prefilled")
        self.remote_hit_tokens = c(
            "serving_prefix_remote_hit_tokens_total",
            "prompt tokens whose prefill was skipped via a REMOTE "
            "prefix fetch")
        self.g_workers = g("cluster_workers_healthy",
                           "worker processes accepting traffic")
        self.g_in_flight = g("cluster_in_flight",
                             "requests not yet terminal")
        self.h_ttft = h("cluster_ttft_ms",
                        help="cluster submit() -> first committed "
                             "token seen at the router")
        self.h_transfer = h("cluster_page_transfer_ms",
                            help="page-frame send -> installed in the "
                                 "decode pool (same-host monotonic "
                                 "clock)")
        from ..obs import RequestTraceEmitter
        self.trace = RequestTraceEmitter()


class _WorkerHandle:
    """Router-side record of one worker process."""
    __slots__ = ("name", "role", "proc", "conn", "data_host",
                 "data_port", "last_seen", "dead", "draining",
                 "outstanding", "stats", "stats_evt", "stats_sid",
                 "error", "recv_thread", "pid", "clock_offset",
                 "clock_rtt", "flight_tail")

    def __init__(self, name, role):
        self.name = name
        self.role = role
        self.proc = None
        self.pid = None                   # from hello (put-segment sweep)
        self.conn = None
        self.data_host = None
        self.data_port = None
        self.last_seen = time.perf_counter()
        self.dead = False
        self.draining = False
        self.outstanding = set()          # rids currently assigned
        self.stats: Dict = {}
        self.stats_evt = threading.Event()
        self.stats_sid = None             # the awaited stats_req id
        self.error = None
        self.recv_thread = None
        # ping-pong clock model: worker perf_counter minus router
        # perf_counter, from the sample of least round trip
        self.clock_offset = 0.0
        self.clock_rtt = None
        # the flight-recorder tail recovered after this worker died
        self.flight_tail = None

    @property
    def alive(self):
        return not self.dead and self.conn is not None


class DisaggRequest:
    """Router-side request record of the disaggregated cluster.
    ``committed`` is fed by the token stream of whichever worker runs
    the request: it is the failover snapshot (a SIGKILLed worker's
    memory is gone; only streamed tokens survive)."""
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "state",
                 "phase", "prefill", "decode", "gen", "committed",
                 "output", "error", "done_evt", "submit_t",
                 "first_token_t", "token_times", "failovers",
                 "delivered", "listeners", "trace_id")

    def __init__(self, rid, prompt, max_new_tokens, eos_id,
                 trace_id=None):
        self.rid = rid
        self.trace_id = trace_id if trace_id is not None \
            else "rid%d" % rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.state = "running"            # running|done|failed|cancelled
        self.phase = "prefill"            # prefill|decode
        self.prefill: Optional[str] = None
        self.decode: Optional[str] = None
        self.gen = 0                      # incarnation fence
        self.committed: List[int] = []
        self.output: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.done_evt = threading.Event()
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        # router-side arrival time of each streamed token
        self.token_times: List[float] = []
        self.failovers = 0
        self.delivered = False
        self.listeners: List = []


def _host_tree(tree):
    """A host copy of a params tree (tensors to CPU tensors, anything
    else to numpy), for shipping to the workers."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return np.asarray(tree)


class DisaggServingCluster:
    """Disaggregated prefill/decode serving across OS processes.

    The router (this object, in the calling process) starts ``prefill``
    + ``decode`` worker processes (``multiprocessing`` spawn: real pids,
    SIGKILL-able; a forked worker would inherit this process's CUDA
    state), ships each the model params and the engine config over the
    transport at its handshake, and then routes: every request runs
    chunked prefill on a prefill worker (its engine capped at one
    sampled token), whose finished KV pages stream to the request's
    decode worker, pipelined with the prefill chunks; the decode worker
    installs the pages, adopts the request at ``n_cached = prompt_len``
    (``ServingEngine.admit_prefilled``) and streams committed tokens
    back to the router.

    * **Cluster-level prefix reuse**: the router owns a
      :class:`prefix_cache.ClusterPrefixIndex`; submit() names the
      worker holding the longest cached chain, and the prefill worker
      fetches those pages from it peer to peer instead of recomputing
      them.  A hot prefix is prefilled once per cluster
      (``serving_prefix_remote_hits_total``,
      ``cluster_page_bytes_streamed_total``).
    * **Failover**: a worker that dies (SIGKILL, crash, socket loss) or
      stalls past ``watchdog_s`` is failed over: its requests go to
      survivors with the router's streamed ``committed`` tokens as
      prompt extension (recompute-exact; f32 greedy output is
      token-identical to an undisturbed run), fenced by per-request
      incarnation numbers so a zombie's late frames never land.
    * **Exactness**: prefill and decode run one engine config and pages
      move as exact pool bytes, so under f32 greedy the output is
      token-identical to ``generate``.

    On this port every worker process builds its own engine and its own
    copy of the weights from host copies shipped at its handshake (the
    reference ships ``jax.device_get(params)``), captures its own step
    graph on the card, and reports its kernels' launch counts in its
    stats (``cluster_stats()[name]["launches"]``).  ``device``: None
    means the CUDA device, ``"cpu"`` runs the workers' engines on the
    CPU; it travels in the handshake, and a worker asked for CUDA that
    finds none fails its handshake rather than run elsewhere.  On CUDA
    the router builds the serving kernels before it starts a worker.
    ``kernel=`` is refused (not ported), as by ``ServingEngine``.  A
    prefill worker's engine runs serially (``overlap`` applies to the
    decode workers): its handoff exports the retired request's freed
    pages right after the step, before a planner could hand them out.

    Off-host scale-out uses the same protocol: pass ``spawn=False`` and
    start the workers with ``python -m mxnet_tpu_torch.tools.launch
    --launcher serve`` (or ``run_worker()`` with the ``MXNET_SERVE_*``
    environment).
    """

    def __init__(self, params, cfg, *, prefill=1, decode=1,
                 num_slots, page_size=16, num_pages=None,
                 pages_per_slot=None, prefill_chunk=8, kv_int8=False,
                 kernel=None, spec_K=0, metrics=None, registry=None,
                 watchdog_s=None, spawn=True, host="127.0.0.1",
                 port=0, ready_timeout=None, tier_bytes=None,
                 overlap=None, device=None):
        if prefill < 1 or decode < 1:
            raise ValueError("DisaggServingCluster: needs >= 1 "
                             "prefill and >= 1 decode worker")
        if kernel is not None:
            raise NotImplementedError(
                "DisaggServingCluster: kernel is not ported to "
                "mxnet_tpu_torch yet (ROADMAP.md)")
        if watchdog_s is None:
            watchdog_s = _env_default("MXNET_SERVE_WATCHDOG_S", 30.0)
        if ready_timeout is None:
            ready_timeout = _env_default(
                "MXNET_SERVE_READY_TIMEOUT_S", 120.0)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.watchdog_s = float(watchdog_s)
        self._spawn = bool(spawn)
        self._engine_kwargs = dict(
            num_slots=num_slots, page_size=page_size,
            num_pages=num_pages, pages_per_slot=pages_per_slot,
            prefill_chunk=prefill_chunk, kv_int8=kv_int8,
            spec_K=spec_K, tier_bytes=tier_bytes, overlap=overlap,
            device=str(self.device))
        # the workers' engine limits, so an invalid request fails the
        # submit() call instead of a worker
        pps = pages_per_slot if pages_per_slot is not None \
            else -(-cfg.max_len // page_size)
        self._max_seq = min(pps * page_size, cfg.max_len)
        if metrics is None:
            metrics = registry is not None or \
                os.environ.get("MXNET_SERVING_METRICS", "0") == "1"
        self._obs = _DisaggObs(registry) if metrics else None
        self._lock = threading.RLock()
        self._closed = False
        self._next_rid = 0
        self.requests: Dict[int, DisaggRequest] = {}
        # terminal requests are kept up to this many, then the oldest
        # delivered ones drop
        self._retain = 4096
        self._terminal: "collections.deque[int]" = collections.deque()
        self.index = ClusterPrefixIndex()
        # hellos of workers that connected while another worker's
        # add_worker handshake was draining the accept queue
        self._early_hellos: Dict[str, object] = {}
        self._rr = [0, 0]                 # round-robin cursors
        # worker-reported cumulative stats, folded into the router's
        # registry as deltas
        self._stat_seen: Dict[str, Dict[str, float]] = {}
        # the router's flight ring, the merged cross-process trace, the
        # per-rid span store behind request_trace(), the TTFT window
        # behind the SLO burn gauges
        from ..obs.flight import FlightRecorder
        from ..obs.trace import MergedTraceEmitter
        self._flight = FlightRecorder()
        self._merged = MergedTraceEmitter()
        self._span_store: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._span_store_cap = 512
        self._flight_tails: Dict[str, list] = {}
        self._clock_seq = itertools.count(1)
        self._ttft_window: "collections.deque" = collections.deque()
        self._slo_ttft_ms = _env_default("MXNET_SERVE_SLO_TTFT_MS",
                                         1000.0)
        self.workers: Dict[str, _WorkerHandle] = {}
        # standby workers: handshaken and warm but out of routing and
        # out of the healthy gauge until scale_up() adopts one
        self._standby: set = set()
        for i in range(prefill):
            self.workers["prefill%d" % i] = _WorkerHandle(
                "prefill%d" % i, "prefill")
        for i in range(decode):
            self.workers["decode%d" % i] = _WorkerHandle(
                "decode%d" % i, "decode")

        from .transport import Listener, tree_to_frames
        # port 0: the OS picks (spawned workers); an external launcher
        # picks the port first and hands it to both sides
        self._listener = Listener(host=host, port=port)
        self._pending_conns: "queue.Queue" = queue.Queue()
        self._listener.start(self._pending_conns.put)
        self._params_frames = tree_to_frames(_host_tree(params))
        if self.device.type == "cuda":
            # the workers' kernels, built once here before any worker
            # could race to build them
            from ..kernels import _build
            for name in ("paged_attention", "flash_fwd"):
                _build.load(name)
        if spawn:
            for name, wh in self.workers.items():
                wh.proc = self._spawn_worker(name, wh.role)
        try:
            self._handshake_all(ready_timeout)
        except BaseException:
            # a failed construction must not strand live workers or the
            # bound listener: the caller never gets an object to close()
            for wh in self.workers.values():
                if wh.proc is not None and wh.proc.is_alive():
                    wh.proc.terminate()
                    wh.proc.join(timeout=5)
                if wh.conn is not None:
                    wh.conn.close()
            self._listener.close()
            raise
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="disagg-monitor")
        self._monitor.start()

    def _spawn_worker(self, name, role):
        import multiprocessing as mp
        proc = mp.get_context("spawn").Process(
            target=_disagg_worker_entry,
            args=(name, role, self._listener.host, self._listener.port),
            daemon=True, name="serving-" + name)
        proc.start()
        return proc

    # --------------------------------------------------- handshake ---
    def _config_meta(self, wh):
        pm, pb = self._params_frames
        return ({"cfg": self.cfg, "role": wh.role,
                 "engine_kwargs": self._engine_kwargs,
                 "params_meta": pm, "watchdog_s": self.watchdog_s}, pb)

    def _take_ready(self, wh, deadline, what):
        got = wh.conn.recv(timeout=max(1.0,
                                       deadline - time.perf_counter()))
        if got in (None, "timeout") or got[0] != "ready":
            why = got[1].get("msg") if isinstance(got, tuple) \
                and got[0] == "error" else repr(got)
            raise RuntimeError(
                "%s: worker %s failed to build its engine (%s)"
                % (what, wh.name, why))
        wh.data_host = got[1]["data_host"]
        wh.data_port = got[1]["data_port"]
        wh.last_seen = time.perf_counter()

    def _handshake_all(self, timeout):
        deadline = time.perf_counter() + timeout
        need = {n for n in self.workers}
        while need:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RuntimeError(
                    "DisaggServingCluster: workers %s never connected"
                    % sorted(need))
            try:
                conn = self._pending_conns.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            got = conn.recv(timeout=left)
            if got in (None, "timeout"):
                conn.close()
                continue
            kind, meta, _ = got
            if kind != "hello" or meta.get("name") not in need:
                conn.close()
                continue
            name = meta["name"]
            wh = self.workers[name]
            wh.conn = conn
            wh.pid = meta.get("pid")
            conn.send("config", *self._config_meta(wh))
            need.discard(name)
        for wh in self.workers.values():
            self._take_ready(wh, deadline, "DisaggServingCluster")
        peers = {n: {"role": w.role, "host": w.data_host,
                     "port": w.data_port}
                 for n, w in self.workers.items()}
        for wh in self.workers.values():
            wh.conn.send("peers", {"peers": peers})
            wh.recv_thread = threading.Thread(
                target=self._recv_loop, args=(wh,), daemon=True,
                name="disagg-recv-" + wh.name)
            wh.recv_thread.start()
        # clock pings after the receive threads start: the worker is in
        # its main loop by now and its replies land in _recv_loop
        for wh in self.workers.values():
            self._clock_ping(wh)
        if self._obs is not None:
            self._obs.g_workers.set(self._serving_count())

    def _clock_ping(self, wh, n=5):
        """A burst of ``clock_req`` frames; each echoes back with the
        worker's ``perf_counter``, and the sample of least round trip
        (``_on_clock``) estimates the worker's clock offset."""
        for _ in range(n):
            try:
                wh.conn.send("clock_req",
                             {"seq": next(self._clock_seq),
                              "t0": time.perf_counter()})
            except OSError:
                return                    # the monitor fails it over

    def _serving_count(self):
        """Workers counted as serving capacity: alive and not parked as
        standby."""
        return sum(w.alive and w.name not in self._standby
                   for w in self.workers.values())

    # ------------------------------------------------- router recv ---
    def _recv_loop(self, wh):
        while True:
            got = wh.conn.recv()
            if got is None:
                with self._lock:
                    closed = self._closed or wh.dead
                if not closed:
                    self._fail_worker(wh, RuntimeError(
                        "worker %s: connection lost (process died?)"
                        % wh.name))
                return
            kind, meta, bufs = got
            wh.last_seen = time.perf_counter()
            if kind == "tokens":
                self._on_tokens(wh, meta)
            elif kind == "handed":
                self._on_handed(wh, meta)
            elif kind == "done":
                self._on_done(wh, meta)
            elif kind == "lost":
                self._on_lost(wh, meta)
            elif kind == "insert":
                self.index.report_insert(wh.name, meta["keys"])
            elif kind == "evict":
                self.index.report_evict(wh.name, meta["keys"])
            elif kind == "tier":
                # chains moved between the worker's tiers: re-tag, a
                # spilled chain is still fetchable
                self.index.report_tier(wh.name, meta["keys"],
                                       meta["tier"])
            elif kind == "stats":
                self._on_stats(wh, meta)
            elif kind == "spans":
                self._on_spans(wh, meta)
            elif kind == "clock":
                self._on_clock(wh, meta)
            elif kind == "reqfail":
                with self._lock:
                    cr = self.requests.get(meta["rid"])
                    if cr is not None and cr.gen == meta["gen"] \
                            and cr.state == "running":
                        cr.state = "failed"
                        cr.error = RuntimeError(meta.get("msg", ""))
                        for side in (cr.prefill, cr.decode):
                            w = self.workers.get(side)
                            if w is not None:
                                w.outstanding.discard(cr.rid)
                        self._terminal.append(cr.rid)
                        self._finish_locked(cr)
            elif kind == "error":
                self._fail_worker(wh, RuntimeError(
                    "worker %s: %s" % (wh.name, meta.get("msg"))))
                return

    def _commit_tokens_locked(self, cr, toks, now):
        """Append newly streamed tokens (router lock held)."""
        if toks and cr.first_token_t is None:
            cr.first_token_t = now
            ttft_ms = (now - cr.submit_t) * 1e3
            if self._obs is not None:
                self._obs.h_ttft.observe(ttft_ms)
                if profiler.is_recording():
                    # the router lane's TTFT span: the worker and
                    # transport spans of this rid nest inside it in the
                    # merged dump (flushed outside the router lock)
                    self._obs.trace.add_span(
                        cr.rid, "ttft", cr.submit_t, now,
                        args={"trace_id": cr.trace_id,
                              "prefill": cr.prefill,
                              "decode": cr.decode})
            self._ttft_window.append((now, ttft_ms))
            while self._ttft_window and \
                    now - self._ttft_window[0][0] > 300.0:
                self._ttft_window.popleft()
        new = [int(t) for t in toks]
        cr.committed.extend(new)
        cr.token_times.extend(now for _ in toks)
        if new:
            # the failover log is the stream: a listener sees exactly
            # the tokens a resubmission would replay
            for cb in cr.listeners:
                cb(("tokens", new))

    def _terminal_event(self, cr):
        if cr.state == "done":
            return ("done", cr.output)
        if cr.state == "cancelled":
            return ("error", RequestCancelled(
                "request %d was cancelled" % cr.rid))
        return ("error", cr.error if cr.error is not None else
                ClusterFailed("request %d failed" % cr.rid))

    def _finish_locked(self, cr):
        """The terminal transition's tail (router lock held): one
        terminal stream event a request, then wake ``result()``
        waiters; a listener receiving it is the delivery."""
        if cr.listeners:
            cr.delivered = True
        for cb in cr.listeners:
            cb(self._terminal_event(cr))
        cr.listeners = []
        cr.done_evt.set()

    def attach_stream(self, rid, cb):
        """A per-request token-stream listener, as
        ``ServingCluster.attach_stream``: the backlog on attach, then
        ``("tokens", [...])`` batches and one terminal ``("done",
        output)`` / ``("error", exc)``.  Callbacks run on the router's
        receive threads under its lock: keep them to an enqueue."""
        with self._lock:
            cr = self.requests.get(rid)
            if cr is None:
                raise KeyError("attach_stream(%d): unknown rid" % rid)
            if cr.committed:
                cb(("tokens", list(cr.committed)))
            if cr.state == "running":
                cr.listeners.append(cb)
            else:
                cr.delivered = True
                cb(self._terminal_event(cr))

    def cancel(self, rid):
        """Cancel a running request end to end: bump its incarnation
        (fencing every late frame of the old one) and send the fenced
        ``cancel`` kind to both assigned workers, which drop staged pages
        and force-retire the engine request.  A cancel after completion
        returns False; a repeated one is harmless."""
        sends = []
        with self._lock:
            cr = self.requests.get(rid)
            if cr is None:
                raise KeyError("cancel(%d): unknown rid" % rid)
            if cr.state != "running":
                return False
            cr.gen += 1
            cr.state = "cancelled"
            for side in {cr.prefill, cr.decode}:
                w = self.workers.get(side)
                if w is not None:
                    w.outstanding.discard(cr.rid)
                    if w.alive:
                        sends.append((w.conn, (
                            "cancel", {"rid": cr.rid,
                                       "below_gen": cr.gen,
                                       "trace_id": cr.trace_id}, [])))
            if self._obs is not None:
                self._obs.cancelled.inc()
                self._obs.g_in_flight.set(
                    sum(r.state == "running"
                        for r in self.requests.values()))
            self._terminal.append(cr.rid)
            self._purge_locked()
            self._finish_locked(cr)
        self._do_sends(sends)
        self._flight.record("cancel", rid=rid, trace_id=cr.trace_id)
        return True

    def _live_request(self, meta):
        """The request a worker frame is about, if the frame's
        incarnation is the live one (router lock held)."""
        cr = self.requests.get(meta["rid"])
        if cr is None or cr.gen != meta["gen"] or cr.state != "running":
            return None
        return cr

    def _on_tokens(self, wh, meta):
        with self._lock:
            cr = self._live_request(meta)
            if cr is None:
                return
            self._commit_tokens_locked(cr, meta["toks"],
                                       time.perf_counter())
        if self._obs is not None:
            self._obs.trace.flush()       # outside the router lock

    def _on_handed(self, wh, meta):
        """Prefill handed off to the decode worker.  Carries no tokens:
        the decode worker reports the whole committed stream on its own
        FIFO connection (split over two connections, a decode ``done``
        could overtake the prefill's ``handed``)."""
        with self._lock:
            cr = self._live_request(meta)
            if cr is None:
                return
            cr.phase = "decode"
            wh.outstanding.discard(cr.rid)

    def _on_done(self, wh, meta):
        sends = []
        with self._lock:
            cr = self._live_request(meta)
            if cr is None:
                return
            self._commit_tokens_locked(cr, meta.get("toks", ()),
                                       time.perf_counter())
            cr.output = np.concatenate(
                [cr.prompt, np.asarray(cr.committed, np.int32)])
            cr.state = "done"
            for side in (cr.prefill, cr.decode):
                w = self.workers.get(side)
                if w is not None:
                    w.outstanding.discard(cr.rid)
            if cr.phase == "prefill" and cr.decode != wh.name:
                # finished at prefill: the decode side may hold staged
                # pages of the stream; fence it from here (the prefill
                # worker's own 'drop' is best effort)
                w = self.workers.get(cr.decode)
                if w is not None and w.alive:
                    sends.append((w.conn, (
                        "abort", {"rid": cr.rid,
                                  "below_gen": cr.gen + 1}, [])))
            if self._obs is not None:
                self._obs.completed.inc()
                self._obs.g_in_flight.set(
                    sum(r.state == "running"
                        for r in self.requests.values()))
            self._terminal.append(cr.rid)
            self._purge_locked()
            self._finish_locked(cr)
        self._do_sends(sends)
        self._flight.record("done", rid=meta.get("rid"),
                            worker=wh.name)
        if self._obs is not None:
            self._obs.trace.flush()

    def _purge_locked(self):
        excess = len(self._terminal) - self._retain
        if excess <= 0:
            return
        kept: "collections.deque[int]" = collections.deque()
        for rid in self._terminal:
            req = self.requests.get(rid)
            if excess > 0 and (req is None or req.delivered):
                excess -= 1
                self.requests.pop(rid, None)
            else:
                kept.append(rid)
        self._terminal = kept

    def _on_lost(self, wh, meta):
        """A prefill worker abandoned a request because its decode peer
        was unreachable (the peer process may be alive, so the watchdog
        cannot see it): reassign, the streamed state fenced out."""
        sends = []
        with self._lock:
            cr = self._live_request(meta)
            if cr is None:
                return
            cr.gen += 1
            cr.failovers += 1
            for side in (cr.prefill, cr.decode):
                w = self.workers.get(side)
                if w is not None:
                    w.outstanding.discard(cr.rid)
                    if w.alive:
                        sends.append((w.conn, (
                            "abort", {"rid": cr.rid,
                                      "below_gen": cr.gen}, [])))
            if cr.failovers > 5:
                # a broken data plane must not bounce the request
                # between worker pairs forever
                cr.state = "failed"
                cr.error = ClusterFailed(
                    "request %d: abandoned %d times (worker data "
                    "plane unreachable)" % (cr.rid, cr.failovers))
                self._terminal.append(cr.rid)
                self._finish_locked(cr)
            else:
                sends.extend(self._dispatch_locked(cr))
                if cr.state == "running" and self._obs is not None:
                    self._obs.resubmitted.inc()
        self._do_sends(sends)

    def _on_stats(self, wh, meta):
        wh.stats = meta["stats"]
        obs = self._obs
        if obs is not None:
            seen = self._stat_seen.setdefault(wh.name, {})
            for key, ctr in (("bytes_streamed", obs.page_bytes),
                             ("pages_streamed", obs.pages_streamed),
                             ("remote_hits", obs.remote_hits),
                             ("remote_hit_tokens",
                              obs.remote_hit_tokens)):
                v = wh.stats.get(key, 0)
                d = v - seen.get(key, 0)
                if d > 0:
                    ctr.inc(d)
                seen[key] = v
            for ms in wh.stats.get("transfer_ms", ()):
                obs.h_transfer.observe(ms)
        # set last, and only for the awaited stats_req reply: a periodic
        # frame sent before the request must not satisfy the wait
        if meta.get("sid") is not None \
                and meta["sid"] == wh.stats_sid:
            wh.stats_evt.set()

    def _on_clock(self, wh, meta):
        """One clock sample: ``offset = t_worker - (t0 + rtt/2)``; the
        sample of least round trip wins."""
        now = time.perf_counter()
        try:
            t0 = float(meta["t0"])
            tw = float(meta["t_worker"])
        except (KeyError, TypeError, ValueError):
            return
        rtt = max(0.0, now - t0)
        if wh.clock_rtt is None or rtt < wh.clock_rtt:
            wh.clock_rtt = rtt
            wh.clock_offset = tw - (t0 + rtt / 2.0)

    def _on_spans(self, wh, meta):
        """A worker's span batch onto the router's timeline: times
        corrected by the worker's clock offset, kept per rid for
        :meth:`request_trace`, and, while a profiler session records,
        put in the one merged trace under the worker's (or the shared
        ``transport``) lane."""
        spans = meta.get("spans") or ()
        if not spans:
            return
        off = wh.clock_offset
        with self._lock:
            for s in spans:
                if not isinstance(s, dict):
                    continue
                rec = dict(s, worker=wh.name, offset_s=off)
                lst = self._span_store.get(rec.get("rid"))
                if lst is None:
                    self._span_store[rec.get("rid")] = lst = []
                    while len(self._span_store) > \
                            self._span_store_cap:
                        self._span_store.popitem(last=False)
                lst.append(rec)
        if profiler.is_recording():
            for s in spans:
                if not isinstance(s, dict):
                    continue
                lane = "transport" \
                    if s.get("cat") == "transport" else wh.name
                self._merged.add(lane, s, off)
            self._merged.flush()

    # ------------------------------------------------------ intake ---
    def _pick(self, role, exclude=()):
        """Least outstanding over the healthy workers of ``role``, ties
        broken round robin (the cluster prefix index, not stickiness,
        makes spreading cheap: a second worker fetches the pages)."""
        cands = sorted((w for w in self.workers.values()
                        if w.role == role and w.alive
                        and not w.draining
                        and w.name not in exclude),
                       key=lambda w: w.name)
        if not cands:
            return None
        i = 0 if role == "prefill" else 1
        cur = self._rr[i]
        self._rr[i] = cur + 1
        lo = min(len(w.outstanding) for w in cands)
        tied = [w for w in cands if len(w.outstanding) == lo]
        return tied[cur % len(tied)]

    def submit(self, prompt, max_new_tokens, eos_id=None,
               trace_id=None):
        """Queue a request; returns its rid at once.  ``trace_id`` is
        the cross-process trace context (a ``rid<N>`` default)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("submit: empty prompt")
        if max_new_tokens < 1:
            raise ValueError("submit: max_new_tokens must be >= 1")
        if prompt.size + int(max_new_tokens) > self._max_seq:
            raise ValueError(
                "submit: %d tokens > worker max_seq/max_len %d"
                % (prompt.size + int(max_new_tokens), self._max_seq))
        with self._lock:
            if self._closed:
                raise ClusterClosed("submit() after close()")
            cr = DisaggRequest(self._next_rid, prompt,
                               int(max_new_tokens), eos_id,
                               trace_id=trace_id)
            self._next_rid += 1
            self.requests[cr.rid] = cr
            if self._obs is not None:
                self._obs.submitted.inc()
                self._obs.g_in_flight.set(
                    sum(r.state == "running"
                        for r in self.requests.values()))
            sends = self._dispatch_locked(cr)
        self._do_sends(sends)
        self._flight.record("submit", rid=cr.rid,
                            trace_id=cr.trace_id, prefill=cr.prefill,
                            decode=cr.decode)
        if self._obs is not None and profiler.is_recording():
            self._obs.trace.add_instant(
                cr.rid, "submit", cr.submit_t,
                args={"trace_id": cr.trace_id})
            self._obs.trace.flush()
        return cr.rid

    def _dispatch_locked(self, cr):
        """Assign (or reassign) a request; returns the (conn, frame)
        sends to make outside the lock."""
        pre = self._pick("prefill")
        dec = self._pick("decode")
        if pre is None or dec is None:
            cr.state = "failed"
            cr.error = ClusterFailed(
                "no healthy %s worker" %
                ("prefill" if pre is None else "decode"))
            self._terminal.append(cr.rid)
            self._finish_locked(cr)
            return []
        cr.prefill, cr.decode = pre.name, dec.name
        cr.phase = "prefill"
        pre.outstanding.add(cr.rid)
        dec.outstanding.add(cr.rid)
        inp = cr.prompt if not cr.committed else np.concatenate(
            [cr.prompt, np.asarray(cr.committed, np.int32)])
        owner, depth, tier = self.index.match(
            chain_keys(inp, self.page_size))
        hint = None
        if owner is not None and owner != pre.name:
            wo = self.workers.get(owner)
            if wo is not None and wo.alive:
                hint = owner
        # hint_tier: where the owner's copy lives ("hbm": its pool;
        # "host": its host tier).  The prefill worker fetches only when
        # the peer's chain is deeper than its own hot and warm depth
        meta = {"rid": cr.rid, "gen": cr.gen,
                "max_new": cr.max_new_tokens - len(cr.committed),
                "eos": cr.eos_id, "decode": dec.name,
                "hint": hint, "hint_depth": depth,
                "hint_tier": tier if hint is not None else None,
                "trace_id": cr.trace_id}
        return [(pre.conn, ("submit", meta,
                            [np.ascontiguousarray(inp).data]))]

    def _do_sends(self, sends):
        for conn, (kind, meta, bufs) in sends:
            try:
                conn.send(kind, meta, bufs)
            except OSError:
                pass                      # the monitor fails it over

    def drain(self, timeout=None):
        """Wait until every submitted request is terminal; True when
        drained (``ServingCluster.drain``'s contract)."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        for cr in list(self.requests.values()):
            left = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            if not cr.done_evt.wait(left):
                return False
        return True

    def result(self, rid, timeout=None):
        """Block until the request finishes; returns prompt + generated
        tokens.  Raises :class:`ClusterFailed` when no healthy worker
        could finish it."""
        cr = self.requests.get(rid)
        if cr is None:
            raise KeyError("result(%d): unknown rid (already "
                           "collected and purged?)" % rid)
        if not cr.done_evt.wait(timeout):
            raise TimeoutError("result(%d): still running" % rid)
        with self._lock:
            cr.delivered = True
            self._purge_locked()
        if cr.state == "done":
            return cr.output
        if cr.state == "cancelled":
            raise RequestCancelled("request %d was cancelled" % rid)
        raise ClusterFailed("request %d: %r" % (rid, cr.error))

    # ---------------------------------------------------- failover ---
    def _fail_worker(self, wh, error):
        """A worker died or stalled: fence it, drop its index entries,
        resubmit its requests to survivors with their streamed tokens as
        prompt extension (recompute-exact)."""
        sends = []
        with self._lock:
            if wh.dead:
                return
            wh.dead = True
            wh.error = error
            self._standby.discard(wh.name)
            self.index.drop_owner(wh.name)
            # a SIGKILLed worker cannot sweep its own unreceived put
            # segments: reclaim them by its pid, and recover its
            # flight ring's tail (crash-durable, keyed by the same pid)
            pid = wh.pid or (wh.proc.pid if wh.proc is not None
                             else None)
            if pid is not None:
                from ..obs.flight import flight_recover
                from .transport import put_sweep
                put_sweep(pid)
                tail = flight_recover(pid, unlink=True)
                if tail:
                    wh.flight_tail = tail
                    self._flight_tails[wh.name] = tail
            if self._obs is not None:
                self._obs.failovers.inc()
                self._obs.g_workers.set(self._serving_count())
            # a request in prefill dies with either of its workers
            # (pages may be streaming to the decode side); one handed
            # off dies only with its decode worker
            victims = [
                cr for cr in self.requests.values()
                if cr.state == "running"
                and ((cr.phase == "prefill"
                      and wh.name in (cr.prefill, cr.decode))
                     or (cr.phase == "decode"
                         and wh.name == cr.decode))]
            for cr in victims:
                cr.gen += 1
                cr.failovers += 1
                for side in (cr.prefill, cr.decode):
                    w = self.workers.get(side)
                    if w is not None:
                        w.outstanding.discard(cr.rid)
                # fence and free what the surviving side holds
                for side in {cr.prefill, cr.decode}:
                    w = self.workers.get(side)
                    if w is not None and w.alive:
                        sends.append((w.conn, ("abort",
                                               {"rid": cr.rid,
                                                "below_gen": cr.gen},
                                               [])))
                done = (len(cr.committed) >= cr.max_new_tokens
                        or (cr.eos_id is not None
                            and cr.eos_id in cr.committed))
                if done:
                    cr.output = np.concatenate(
                        [cr.prompt, np.asarray(cr.committed, np.int32)])
                    cr.state = "done"
                    if self._obs is not None:
                        self._obs.completed.inc()
                    self._terminal.append(cr.rid)
                    self._finish_locked(cr)
                    continue
                sends.extend(self._dispatch_locked(cr))
                if cr.state == "running" and self._obs is not None:
                    self._obs.resubmitted.inc()
        try:
            wh.conn.close()
        except Exception:
            pass
        self._do_sends(sends)
        self._flight.record("worker_dead", worker=wh.name,
                            error=repr(error))
        tail = wh.flight_tail
        if tail and profiler.is_recording():
            # the victim's last events as instants on its lane
            for ev in tail:
                self._merged.add_flight(wh.name, ev, wh.clock_offset)
            self._merged.flush()

    def flight_tail(self, name):
        """The recovered flight-recorder tail of a dead worker (event
        dicts in order), or None."""
        with self._lock:
            return self._flight_tails.get(name)

    def _monitor_loop(self):
        period = max(0.05, min(0.5, self.watchdog_s / 4.0))
        while True:
            time.sleep(period)
            with self._lock:
                if self._closed:
                    return
                suspects = []
                now = time.perf_counter()
                for wh in self.workers.values():
                    if wh.dead:
                        continue
                    if wh.proc is not None and not wh.proc.is_alive():
                        suspects.append((wh, "process exited"))
                    elif wh.outstanding and \
                            now - wh.last_seen > self.watchdog_s:
                        suspects.append((wh, "stalled past watchdog "
                                         "%.1fs" % self.watchdog_s))
            for wh, why in suspects:
                self._fail_worker(wh, RuntimeError(
                    "worker %s: %s" % (wh.name, why)))

    # --------------------------------------------------- accounting --
    _stats_seq = itertools.count(1)

    def cluster_stats(self, timeout=5.0):
        """A fresh stats snapshot of every live worker (a round trip
        each, matched by sequence id): {name: {engine, prefix, streamer
        counters and the kernels' ``launches``}}."""
        sid = next(self._stats_seq)
        live = [w for w in self.workers.values() if w.alive]
        for wh in live:
            wh.stats_sid = sid
            wh.stats_evt.clear()
        for wh in live:
            try:
                wh.conn.send("stats_req", {"sid": sid})
            except OSError:
                pass
        deadline = time.perf_counter() + timeout
        for wh in live:
            wh.stats_evt.wait(max(0.0, deadline - time.perf_counter()))
        return {wh.name: dict(wh.stats) for wh in live}

    def health(self):
        now = time.perf_counter()
        with self._lock:
            return [{"worker": w.name, "role": w.role,
                     "alive": w.alive, "dead": w.dead,
                     "standby": w.name in self._standby,
                     "draining": w.draining,
                     "outstanding": len(w.outstanding),
                     "heartbeat_age_s": now - w.last_seen,
                     "pid": None if w.proc is None else w.proc.pid,
                     "error": repr(w.error) if w.error else None}
                    for w in self.workers.values()]

    def _slo_locked(self, now):
        """SLO burn rates from the router's TTFT window: the share of
        recent requests over ``MXNET_SERVE_SLO_TTFT_MS``, as a burn rate
        against the 1% error budget of a 99% objective."""
        budget_ms = self._slo_ttft_ms
        windows = {}
        for label, win_s in zip(("1m", "5m"), (60.0, 300.0)):
            n = bad = 0
            for t, ms in self._ttft_window:
                if now - t <= win_s:
                    n += 1
                    bad += ms > budget_ms
            frac = bad / n if n else 0.0
            windows[label] = {"requests": n, "over_budget": bad,
                              "bad_fraction": frac,
                              "burn_rate": frac / 0.01}
        return {"ttft_budget_ms": budget_ms, "windows": windows}

    def debug_status(self):
        """The ``GET /debug/statusz`` snapshot: topology, each worker's
        health, clock offset and last stats, the live requests, the SLO
        burn gauges and the flight recorder's state."""
        now = time.perf_counter()
        with self._lock:
            workers = []
            for w in self.workers.values():
                st = w.stats or {}
                tail = self._flight_tails.get(w.name)
                workers.append({
                    "worker": w.name, "role": w.role,
                    "alive": w.alive, "dead": w.dead,
                    "standby": w.name in self._standby,
                    "draining": w.draining,
                    "outstanding": len(w.outstanding),
                    "heartbeat_age_s": now - w.last_seen,
                    "pid": w.pid or (w.proc.pid
                                     if w.proc is not None else None),
                    "clock_offset_us": None if w.clock_rtt is None
                    else w.clock_offset * 1e6,
                    "clock_rtt_us": None if w.clock_rtt is None
                    else w.clock_rtt * 1e6,
                    "active_requests": st.get("active_requests"),
                    "pages_in_use": st.get("pages_in_use"),
                    "free_pages": st.get("free_pages"),
                    "tier": st.get("tier"),
                    "flight_tail_events": None if tail is None
                    else len(tail),
                    "error": repr(w.error) if w.error else None})
            reqs = [{"rid": r.rid, "trace_id": r.trace_id,
                     "state": r.state, "phase": r.phase,
                     "prefill": r.prefill, "decode": r.decode,
                     "gen": r.gen, "committed": len(r.committed),
                     "failovers": r.failovers,
                     "age_s": now - r.submit_t,
                     "ttft_ms": None if r.first_token_t is None
                     else (r.first_token_t - r.submit_t) * 1e3}
                    for r in self.requests.values()
                    if r.state == "running"]
            slo = self._slo_locked(now)
            recovered = sorted(self._flight_tails)
        return {"kind": "disagg", "closed": self._closed,
                "workers": workers, "in_flight": reqs, "slo": slo,
                "flight": {"path": self._flight.path,
                           "recovered": recovered}}

    def request_trace(self, rid):
        """One request's timeline: its record (state, assignment,
        timing) and every span the workers shipped for it, on the
        router's clock.  KeyError on a rid never seen."""
        with self._lock:
            cr = self.requests.get(rid)
            router = None if cr is None else {
                "rid": cr.rid, "trace_id": cr.trace_id,
                "state": cr.state, "phase": cr.phase,
                "prefill": cr.prefill, "decode": cr.decode,
                "gen": cr.gen, "committed": len(cr.committed),
                "failovers": cr.failovers, "submit_t": cr.submit_t,
                "first_token_t": cr.first_token_t}
            spans = [dict(s) for s in self._span_store.get(rid, ())]
        if router is None and not spans:
            raise KeyError("request_trace(%r): unknown rid" % (rid,))
        return {"rid": rid, "router": router, "spans": spans}

    @property
    def registry(self):
        return self._obs.registry if self._obs is not None else None

    def kill_worker(self, name, sig=None):
        """Send a spawned worker process a signal (SIGKILL by
        default)."""
        import signal as _signal
        wh = self.workers[name]
        if wh.proc is None:
            raise ValueError("worker %s was not spawned locally"
                             % name)
        os.kill(wh.proc.pid, sig or _signal.SIGKILL)

    # ------------------------------------------------- scale-up/down --
    def _handshake_one(self, wh, timeout):
        """Handshake one late worker on the live listener (the
        add_worker path).  Hellos of other joining workers are kept for
        their own add_worker call, not closed."""
        deadline = time.perf_counter() + timeout
        with self._lock:
            conn = self._early_hellos.pop(wh.name, None)
        while conn is None:
            left = deadline - time.perf_counter()
            if left <= 0:
                raise RuntimeError(
                    "add_worker: %s never connected" % wh.name)
            try:
                cand = self._pending_conns.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            got = cand.recv(timeout=left)
            if got in (None, "timeout"):
                cand.close()
                continue
            kind, meta, _ = got
            name = meta.get("name") if kind == "hello" else None
            if name == wh.name:
                conn = cand
                wh.pid = meta.get("pid")
            elif name:
                with self._lock:
                    old = self._early_hellos.pop(name, None)
                    self._early_hellos[name] = cand
                if old is not None:
                    old.close()
            else:
                cand.close()
        wh.conn = conn
        wh.conn.send("config", *self._config_meta(wh))
        self._take_ready(wh, deadline, "add_worker")

    def add_worker(self, role, spawn=None, ready_timeout=None,
                   standby=False):
        """Add one ``role`` worker process to the live cluster (the
        autoscaler's scale-up).  ``spawn=True`` starts it here;
        ``spawn=False`` waits for one launched elsewhere
        (``tools.launch --launcher serve --workers-only``, or
        ``run_worker()``).  Blocks through the handshake and the
        engine's warm-up; every live worker gets the new peer map.
        Returns the new worker's name.  ``standby=True`` brings it all
        the way up but parks it out of routing and out of the healthy
        gauge until ``scale_up()`` adopts it."""
        if role not in ("prefill", "decode"):
            raise ValueError("add_worker: role must be 'prefill' or "
                             "'decode', got %r" % (role,))
        if ready_timeout is None:
            ready_timeout = _env_default(
                "MXNET_SERVE_READY_TIMEOUT_S", 120.0)
        with self._lock:
            if self._closed:
                raise ClusterClosed("add_worker() after close()")
            i = 0
            while "%s%d" % (role, i) in self.workers:
                i += 1
            name = "%s%d" % (role, i)
            wh = _WorkerHandle(name, role)
            # hidden from _pick until fully ready: a submit sent before
            # the worker has its peer map would break its handshake
            wh.draining = True
            self.workers[name] = wh
        if spawn is None:
            spawn = self._spawn
        if spawn:
            wh.proc = self._spawn_worker(name, role)
        try:
            self._handshake_one(wh, ready_timeout)
        except BaseException:
            with self._lock:
                wh.dead = True
                self._standby.discard(name)
                self.workers.pop(name, None)
            if wh.proc is not None and wh.proc.is_alive():
                wh.proc.terminate()
                wh.proc.join(timeout=5)
            if wh.conn is not None:
                wh.conn.close()
            raise
        with self._lock:
            peers = {n: {"role": w.role, "host": w.data_host,
                         "port": w.data_port}
                     for n, w in self.workers.items() if w.alive}
            targets = [w for w in self.workers.values() if w.alive]
        for w in targets:
            try:
                w.conn.send("peers", {"peers": peers})
            except OSError:
                pass                      # the monitor fails it over
        wh.recv_thread = threading.Thread(
            target=self._recv_loop, args=(wh,), daemon=True,
            name="disagg-recv-" + wh.name)
        wh.recv_thread.start()
        self._clock_ping(wh)
        with self._lock:
            if standby:
                self._standby.add(name)   # warm, never routed until adopted
            else:
                wh.draining = False
            if self._obs is not None:
                self._obs.g_workers.set(self._serving_count())
        return name

    def adopt_standby(self, role):
        """Put one standby ``role`` worker into rotation (a flag flip:
        it is handshaken, warm and in every peer map).  Its name, or
        None when no standby of that role is parked."""
        with self._lock:
            for name in sorted(self._standby):
                wh = self.workers.get(name)
                if wh is not None and wh.role == role and wh.alive:
                    self._standby.discard(name)
                    wh.draining = False
                    if self._obs is not None:
                        self._obs.g_workers.set(self._serving_count())
                    return name
        return None

    def drain_worker(self, name, timeout=60.0):
        """Scale one worker down gracefully: stop routing to it, wait
        for its outstanding requests, then shut it down (a clean exit).
        Refuses the last live worker of a role.  True once drained and
        stopped; False (and back in rotation) on timeout."""
        with self._lock:
            wh = self.workers[name]
            if wh.dead:
                return False
            siblings = [w for w in self.workers.values()
                        if w.role == wh.role and w.alive
                        and not w.draining and w is not wh]
            if not siblings:
                return False
            wh.draining = True
        deadline = time.perf_counter() + float(timeout)
        drained = False
        while time.perf_counter() < deadline:
            with self._lock:
                drained = not wh.outstanding
            if drained:
                break
            time.sleep(0.02)
        if not drained:
            with self._lock:
                wh.draining = False       # back in rotation
            return False
        with self._lock:
            wh.dead = True                # its EOF will not fail over
            self._standby.discard(name)
            self.index.drop_owner(name)
            if self._obs is not None:
                self._obs.g_workers.set(self._serving_count())
        try:
            wh.conn.send("shutdown", {})
        except OSError:
            pass
        if wh.proc is not None:
            wh.proc.join(timeout=10)
            if wh.proc.is_alive():
                wh.proc.terminate()
                wh.proc.join(timeout=5)
        try:
            wh.conn.close()
        except Exception:
            pass
        return True

    # the autoscaler's actuation protocol (as ServingCluster's), by
    # role: scale_up grows the role with the higher mean outstanding
    # load, scale_down drains the least loaded worker of a role that
    # keeps one
    def scale_up(self):
        with self._lock:
            load = {}
            for role in ("prefill", "decode"):
                ws = [w for w in self.workers.values()
                      if w.role == role and w.alive
                      and not w.draining]
                load[role] = (float("inf") if not ws else
                              sum(len(w.outstanding) for w in ws)
                              / len(ws))
        role = max(sorted(load), key=lambda r: load[r])
        if self.adopt_standby(role) is not None:
            return True
        self.add_worker(role)
        return True

    def scale_down(self, timeout=60.0):
        with self._lock:
            cands = []
            for role in ("prefill", "decode"):
                ws = [w for w in self.workers.values()
                      if w.role == role and w.alive
                      and not w.draining]
                if len(ws) > 1:
                    cands.extend(ws)
            if not cands:
                return False
            name = min(cands, key=lambda w: (len(w.outstanding),
                                             w.name)).name
        return self.drain_worker(name, timeout=timeout)

    @property
    def slots_per_replica(self):
        return self._engine_kwargs["num_slots"]

    def close(self, timeout=30.0):
        with self._lock:
            self._closed = True
            workers = list(self.workers.values())
            # a result() waiter must not hang on a request the shutdown
            # abandons: fail every running one
            for cr in self.requests.values():
                if cr.state == "running":
                    cr.state = "failed"
                    cr.error = ClusterClosed(
                        "cluster closed with the request in flight")
                    self._terminal.append(cr.rid)
                    self._finish_locked(cr)
        for wh in workers:
            if wh.conn is not None:
                try:
                    wh.conn.send("shutdown", {})
                except OSError:
                    pass
        from ..obs.flight import flight_sweep
        from .transport import put_sweep
        for wh in workers:
            if wh.proc is not None:
                wh.proc.join(timeout=timeout)
                if wh.proc.is_alive():
                    wh.proc.terminate()
                    wh.proc.join(timeout=5)
            # the receive thread first: the worker's last frames (its
            # final stats and spans) are still in the socket buffer
            if wh.recv_thread is not None and \
                    wh.recv_thread is not threading.current_thread():
                wh.recv_thread.join(timeout=5)
            if wh.conn is not None:
                wh.conn.close()
            pid = wh.pid or (wh.proc.pid if wh.proc is not None
                             else None)
            if pid is not None:
                put_sweep(pid)
                flight_sweep(pid)
        self._flight.close(unlink=True)
        with self._lock:
            early = list(self._early_hellos.values())
            self._early_hellos.clear()
        for conn in early:
            try:
                conn.close()
            except Exception:
                pass
        self._listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --------------------------------------------------------------------------
# the disaggregated worker process
# --------------------------------------------------------------------------

def _kernel_launches():
    """This process's serving kernels' launch counters."""
    from ..kernels import flash_attention as FA
    from ..kernels import paged_attention as PA
    return {"paged_attention": PA.paged_attention.launches,
            "flash_fwd": FA.flash_fwd.launches}


class _DisaggWorker:
    """One prefill or decode worker process: one main loop owns the
    engine (all device work stays on one thread; receive threads only
    queue host bytes), a data listener serves peer page fetches and the
    prefill-to-decode streams, and a control connection carries
    submits, tokens and stats to the router."""

    def __init__(self, name, role, router_host, router_port):
        from .transport import connect, frames_to_tree, Listener
        self.name = name
        self.role = role
        self.inbox: "queue.Queue" = queue.Queue()
        self.fetch_inbox: "queue.Queue" = queue.Queue()
        self.router = connect(router_host, router_port, timeout=60.0,
                              retry_until=60.0)
        self.router.send("hello", {"name": name, "role": role,
                                   "pid": os.getpid()})
        got = self.router.recv(timeout=120.0)
        if got in (None, "timeout") or got[0] != "config":
            raise RuntimeError("worker %s: bad config handshake: %r"
                               % (name, got))
        _, meta, bufs = got
        self.cfg = meta["cfg"]
        self.watchdog_s = meta.get("watchdog_s", 30.0)
        kw = dict(meta["engine_kwargs"])
        if role == "prefill":
            # the prefill worker's trie is the cluster's page source;
            # speculation never pays on a one-token budget; serial, so
            # the handoff's export of a retired request's freed pages
            # runs before any later plan hands them out
            kw.update(prefix_cache=True, spec_K=0, overlap=False)
        else:
            kw.update(prefix_cache=False)
        try:
            # a worker asked for CUDA without a card raises here
            resolve_device(kw["device"])
            params = frames_to_tree(meta["params_meta"], bufs)
            self.eng = ServingEngine(params, self.cfg, **kw)
            del params, bufs
            self._warm()
        except Exception as e:
            try:
                self.router.send("error", {"msg": repr(e)})
            except OSError:
                pass
            raise
        if self.eng.prefix is not None:
            self.eng.prefix.evict_cb = self._on_evict
            if self.eng.tier is not None:
                self.eng.prefix.tier_cb = self._on_tier_move
        if role == "prefill":
            self.eng.retire_cb = self._on_retire
        self._evicted_keys: List[bytes] = []
        # chain key -> last tier seen, flushed with the stats tick as
        # `tier` frames (only the last transition of a key travels)
        self._tier_moves: Dict[bytes, str] = {}
        from .page_streamer import PageReceiver, PageStreamer
        self.streamer = PageStreamer(self.eng)
        self.receiver = PageReceiver(self.eng)
        # the data plane: loopback for local workers; a worker on
        # another host sets MXNET_SERVE_DATA_HOST to its reachable
        # address, binds every interface and advertises that address
        data_host = os.environ.get("MXNET_SERVE_DATA_HOST")
        self.listener = Listener(
            host="0.0.0.0" if data_host else "127.0.0.1")
        self.listener.start(self._peer_handler)
        self.router.send("ready",
                         {"data_host": data_host or "127.0.0.1",
                          "data_port": self.listener.port})
        got = self.router.recv(timeout=120.0)
        if got in (None, "timeout") or got[0] != "peers":
            raise RuntimeError("worker %s: no peer map" % name)
        self.peers = got[1]["peers"]
        self._peer_conns: Dict[str, object] = {}
        # request state: engine rid -> {rid, gen, meta, inp}
        self.by_erid: Dict[int, dict] = {}
        self.by_rid: Dict[int, int] = {}  # cluster rid -> engine rid
        self._reported: Dict[int, int] = {}   # rid -> tokens reported
        self.remote_hits = 0
        self.remote_hit_tokens = 0
        self.remote_hits_host_tier = 0
        self.fetch_bytes = 0
        self.pages_put_total = 0          # pages sent through segments
        self.put_bytes_total = 0
        self._fetch_seq = 0               # fetch/reply correlation
        # rid -> lowest still-valid gen: a fenced zombie's late frames
        # are dropped instead of recreating staging
        self._fenced: Dict[int, int] = {}
        self.transfer_ms: List[float] = []
        self._last_stats = 0.0
        # device time of the steps (CUDA events around each step on
        # the engine's stream), folded when their events complete
        self._step_events: List = []
        self.device_ms = 0.0
        self.device_steps = 0
        self.step_wall_ms = 0.0           # host clock inside eng.step()
        from ..obs.flight import FlightRecorder
        from ..obs.trace import SpanBuffer
        self._flight = FlightRecorder()
        self._spans = SpanBuffer()
        self._decode_t0: Dict[int, float] = {}   # rid -> admit time
        self._flight.record("ready", worker=name, role=role)
        self._running = True
        threading.Thread(target=self._router_recv, daemon=True,
                         name="disagg-router-recv").start()

    def _warm(self):
        """The first step (on the card: the capture) and one page
        export and install, before the worker reports ready: the
        handshake's timeout covers them, so the watchdog never takes a
        first request's capture for a stall.  Then zero the warm-up's
        footprint."""
        eng = self.eng
        wid = eng.submit(np.ones(1, np.int32), 1)
        eng.run()
        del eng.requests[wid]
        ids = eng.cache.alloc(1)
        if ids is not None:
            eng.cache.install_pages(ids, eng.cache.export_pages(ids))
            eng.cache.run_transfers()
            eng.cache.free(ids)
        if eng.prefix is not None:
            eng.prefix.clear()
        for k in eng.stats:
            eng.stats[k] = type(eng.stats[k])()
        if eng.metrics_enabled:
            eng.reset_metrics()

    # -- feeder threads -> inbox ------------------------------------
    def _router_recv(self):
        while True:
            got = self.router.recv()
            if got is None:
                self.inbox.put(("_lost", None, None, None))
                return
            kind, meta, bufs = got
            self.inbox.put((kind, meta, bufs, None))

    def _peer_handler(self, conn):
        """One accepted peer connection: page streams and sibling
        fetches, queued with the conn so the main loop replies in
        order.  Our caps frame goes out first (the connector's
        ``wait_caps`` relies on it preceding any reply)."""
        try:
            conn.send_caps()
        except OSError:
            return
        while True:
            got = conn.recv()
            if got is None:
                return
            kind, meta, bufs = got
            if kind == "caps":
                continue                  # recorded on the conn
            if kind == "fetch":
                self.fetch_inbox.put((meta, bufs, conn))
                # wake an idle main loop parked on the inbox, or the
                # fetch waits out its poll
                self.inbox.put(("_wake", None, None, None))
            else:
                self.inbox.put((kind, meta, bufs, conn))

    def _on_evict(self, key):
        self._evicted_keys.append(key)
        self._tier_moves.pop(key, None)   # gone beats any re-tag

    def _on_tier_move(self, key, tier):
        self._tier_moves[key] = tier

    def _on_retire(self, req):
        """Engine retire hook (prefill role): the finishing request's
        page ids and depth, before the engine frees them; the handoff
        export after the step reads these pages."""
        st = self.by_erid.get(req.rid)
        if st is not None:
            st["final_pages"] = list(req.pages)
            st["final_n_cached"] = req.n_cached
            st["final_chain_upto"] = req.chain_upto

    # -- remote prefix fetch (prefill role) -------------------------
    def _peer_conn(self, owner):
        from .transport import connect
        conn = self._peer_conns.get(owner)
        if conn is None or conn.closed:
            p = self.peers[owner]
            conn = connect(p["host"], p["port"], timeout=10.0)
            # caps handshake: a timeout means a socket-only peer
            try:
                conn.send_caps()
                conn.wait_caps(timeout=5.0)
            except OSError:
                conn.close()
                raise
            self._peer_conns[owner] = conn
        return conn

    def _send_pages_frame(self, conn, kind, meta, bufs):
        """Send a page-carrying frame (a ``pages`` stream or a
        ``fetch_reply``) over the negotiated transport: a shm put when
        both ends advertised same-host ``put_pages`` (and the segment
        could be written: a full ``/dev/shm`` sends inline), else inline
        socket bytes, the same bytes.  Raises OSError as
        ``conn.send``."""
        from .transport import put_capability, put_eligible, put_write
        path = None
        if bufs and put_eligible(put_capability(), conn.peer_put):
            try:
                path, sizes = put_write(bufs)
            except OSError:
                path = None               # shm full: the socket instead
        if path is not None:
            try:
                conn.send(kind, dict(
                    meta, put={"path": path, "sizes": sizes}), ())
            except BaseException:
                # the peer never got the frame: nobody else unlinks it
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            self.pages_put_total += int(meta.get("n", len(bufs)))
            self.put_bytes_total += sum(sizes)
        else:
            conn.send(kind, meta, bufs)

    def _serve_fetches(self):
        """Answer queued sibling fetches (also while waiting on our own
        fetch: two workers fetching from each other must not deadlock).
        The reply goes out on every path: a fetch that fails to serve is
        an n=0 miss now, not a timeout later."""
        from .page_streamer import merge_page_content, pages_to_bufs
        while True:
            try:
                meta, bufs, conn = self.fetch_inbox.get_nowait()
            except queue.Empty:
                return
            reply_bufs = []
            n_full = 0
            try:
                tokens = np.frombuffer(bytes(bufs[0]), np.int32)
                if self.eng.prefix is not None:
                    # restore=False: serving a sibling spends none of our
                    # pool pages; a spilled tail ships off the host tier
                    entries, pages, m = self.eng.prefix.match(
                        tokens, restore=False)
                    try:
                        n_hot = min(len(pages), m // self.eng.page_size)
                        parts = []
                        if n_hot:
                            parts.append(self.eng.cache.export_pages(
                                pages[:n_hot]))
                        tail = self.eng.prefix.spilled_content(
                            tokens, n_hot)
                        n_full = n_hot + len(tail)
                        parts.extend(tail)
                        if parts:
                            reply_bufs = pages_to_bufs(
                                merge_page_content(parts))
                    finally:
                        self.eng.prefix.release(entries)
            except Exception:
                n_full, reply_bufs = 0, []   # a miss: cold prefill there
            try:
                self._send_pages_frame(
                    conn, "fetch_reply",
                    {"n": n_full, "fid": meta.get("fid"),
                     "trace_id": meta.get("trace_id"),
                     "t_send": time.perf_counter()},
                    reply_bufs)
                self.fetch_bytes += sum(
                    memoryview(b).nbytes for b in reply_bufs)
            except OSError:
                pass                      # the requester died

    def _fetch_remote(self, owner, tokens, timeout=15.0,
                      peer_tier=None, trace_id=None):
        """Fetch the longest cached chain for ``tokens`` from a sibling
        and graft it into the local trie.  A miss, or a dead or slow
        peer, leaves a cold local prefill: exactness never depends on
        the fetch.  Returns the prompt tokens covered."""
        from .page_streamer import _release, bufs_to_pages
        self._fetch_seq += 1
        fid = self._fetch_seq
        try:
            conn = self._peer_conn(owner)
            conn.send("fetch", {"fid": fid, "trace_id": trace_id},
                      [np.ascontiguousarray(tokens).data])
        except (OSError, KeyError):
            return 0
        deadline = time.perf_counter() + timeout
        while True:
            left = deadline - time.perf_counter()
            if left <= 0:
                # a reply may still come on this conn: drop it, so a
                # later fetch cannot take the stale reply for its own
                self._peer_conns.pop(owner, None)
                conn.close()
                return 0
            got = conn.recv(timeout=min(left, 0.05))
            if got == "timeout":
                self._serve_fetches()     # break a fetch-fetch deadlock
                continue
            if got is None:
                self._peer_conns.pop(owner, None)
                return 0
            kind, meta, bufs = got
            if kind != "fetch_reply" or meta.get("fid") != fid:
                _release(bufs)            # a stale reply: unmap it
                continue
            break
        n = meta["n"]
        if not n:
            return 0
        ps = self.eng.page_size
        ids = self.eng.cache.alloc(n)
        if ids is None:
            _release(bufs)
            return 0                      # pool too tight: stay cold
        self.eng.cache.install_pages(
            ids, bufs_to_pages(self.eng.cache, n, bufs))
        _release(bufs)
        created = self.eng.prefix.insert_chain(
            tokens[:n * ps], ids, upto_page=n)
        created_idx = {j for j, _ in created}
        # pages whose chain position was cached here already stay
        # unowned: free them
        extra = [ids[j] for j in range(n) if j not in created_idx]
        if extra:
            self.eng.cache.free(extra)
        # the fetched entries are cache-owned; drop the donor refs
        self.eng.prefix.release([e for _, e in created])
        self.remote_hits += 1
        self.remote_hit_tokens += n * ps
        if peer_tier == "host":
            self.remote_hits_host_tier += 1
        self.transfer_ms.append(
            (time.perf_counter() - meta["t_send"]) * 1e3)
        # bytes are counted by the sender only (as the streams are)
        return n * ps

    # -- message handling -------------------------------------------
    def _handle(self, kind, meta, bufs, conn):
        if kind == "submit":
            inp = np.frombuffer(bytes(bufs[0]), np.int32)
            if meta["gen"] < self._fenced.get(meta["rid"], -1):
                return                    # a fenced incarnation's submit
            t_recv = time.perf_counter()
            tid = meta.get("trace_id")
            self._flight.record("submit_recv", rid=meta["rid"],
                                gen=meta["gen"], trace_id=tid)
            self._spans.instant(meta["rid"], "submit_recv", t_recv,
                                trace_id=tid)
            if meta.get("hint") and self.eng.prefix is not None:
                # a peer copy wins only when it covers more than our hot
                # and spilled pages together
                hot, warm = self.eng.prefix.probe_depth(inp)
                if meta["hint_depth"] > hot + warm:
                    t0f = time.perf_counter()
                    got = self._fetch_remote(
                        meta["hint"], inp,
                        peer_tier=meta.get("hint_tier"),
                        trace_id=tid)
                    self._spans.span(
                        meta["rid"], "fetch", t0f,
                        time.perf_counter(), trace_id=tid,
                        cat="transport",
                        args={"owner": meta["hint"],
                              "hit_tokens": got})
            try:
                erid = self.eng.submit(
                    inp, 1 if self.role == "prefill"
                    else meta["max_new"], eos_id=meta["eos"],
                    trace_id=tid)
            except Exception as e:
                # a request this engine refuses fails alone
                self.router.send("reqfail", {"rid": meta["rid"],
                                             "gen": meta["gen"],
                                             "msg": repr(e)})
                return
            self.by_erid[erid] = {"rid": meta["rid"],
                                  "gen": meta["gen"],
                                  "meta": meta, "inp": inp,
                                  "t0": t_recv}
            self.by_rid[meta["rid"]] = erid
            self._reported[meta["rid"]] = 0
        elif kind == "pages":
            key = tuple(meta["srid"])
            if key[1] < self._fenced.get(key[0], -1):
                from .page_streamer import _release
                _release(bufs)
                return                    # a zombie incarnation's frame
            t_in = time.perf_counter()
            try:
                self.receiver.on_pages(key, meta["start"],
                                       meta["n"], bufs)
            except RuntimeError:
                # a gapped stream cannot resume: drop its staging and
                # let the router's reassignment recover
                self.receiver.abort(key)
                return
            now = time.perf_counter()
            self.transfer_ms.append((now - meta["t_send"]) * 1e3)
            self._flight.record("pages_recv", rid=key[0],
                                start=meta["start"], n=meta["n"])
            # the span ends installed; install_ms is this side's part
            self._spans.span(key[0], "transfer", meta["t_send"], now,
                             trace_id=meta.get("trace_id"),
                             cat="transport",
                             args={"start": meta["start"],
                                   "pages": meta["n"],
                                   "install_ms": (now - t_in) * 1e3})
        elif kind == "handoff":
            key = tuple(meta["srid"])
            if key[1] < self._fenced.get(key[0], -1):
                return
            self.receiver.on_handoff(
                key, meta["total"],
                dict(meta, prompt=np.frombuffer(bytes(bufs[0]),
                                                np.int32)))
            self._flight.record("handoff_recv", rid=key[0],
                                total=meta["total"])
            self._spans.instant(key[0], "handoff_recv",
                                time.perf_counter(),
                                trace_id=meta.get("trace_id"))
        elif kind == "abort":
            self._abort(meta["rid"], meta["below_gen"])
            self._flight.record("abort", rid=meta["rid"],
                                below_gen=meta["below_gen"])
        elif kind == "cancel":
            # as a failover abort, and nothing resubmits afterwards
            self._abort(meta["rid"], meta["below_gen"])
            self._flight.record("cancel", rid=meta["rid"],
                                trace_id=meta.get("trace_id"))
        elif kind == "drop":
            key = tuple(meta["srid"])
            if key[1] < self._fenced.get(key[0], -1):
                return
            # the prefill side finished this request itself
            self.receiver.abort(key)
        elif kind == "peers":
            self.peers = meta["peers"]    # only grows or re-addresses
        elif kind == "stats_req":
            self._send_stats(sid=meta.get("sid"))
        elif kind == "clock_req":
            # echo at once: queueing here inflates the round trip
            try:
                self.router.send("clock",
                                 {"seq": meta["seq"], "t0": meta["t0"],
                                  "t_worker": time.perf_counter()})
            except OSError:
                self._running = False
        elif kind in ("shutdown", "_lost"):
            self._running = False
        # "caps" (recorded on the conn) and "_wake" need nothing

    def _abort(self, rid, below_gen):
        """Fence an old incarnation: drop its staged pages and its
        engine request, and remember the fence so its late frames drop
        instead of recreating staging."""
        if below_gen > self._fenced.get(rid, -1):
            self._fenced[rid] = below_gen
            if len(self._fenced) > 4096:  # bound: oldest rids first
                for k in sorted(self._fenced)[:1024]:
                    del self._fenced[k]
        for key in [k for k in self.receiver.staged_rids
                    if k[0] == rid and k[1] < below_gen]:
            self.receiver.abort(key)
        erid = self.by_rid.get(rid)
        if erid is not None and self.by_erid[erid]["gen"] < below_gen:
            self.by_erid.pop(erid)
            self.by_rid.pop(rid, None)
            self._reported.pop(rid, None)
            self._decode_t0.pop(rid, None)
            self.streamer.drop(erid)
            if erid in self.eng.requests:
                self.eng.cancel(erid)
                del self.eng.requests[erid]

    # -- per-step work ----------------------------------------------
    def _admit_ready(self):
        """Decode role: adopt handed-off requests whose pages are all
        installed, as slots free up (their installs run at the next
        dispatch, before the step reads them)."""
        self.receiver.retry_installs()
        for key in list(self.receiver.staged_rids):
            if not self.receiver.ready(key):
                continue
            if self.eng.free_slots == 0:
                return
            pages, meta = self.receiver.take(key)
            rid, gen = key
            erid = self.eng.admit_prefilled(
                meta["prompt"], meta["toks"], pages,
                max_new_tokens=meta["max_new"], eos_id=meta["eos"])
            self.by_erid[erid] = {"rid": rid, "gen": gen, "meta": meta}
            self.by_rid[rid] = erid
            t_admit = time.perf_counter()
            self._decode_t0[rid] = t_admit
            self._flight.record("admit", rid=rid, gen=gen)
            self._spans.instant(rid, "admit_prefilled", t_admit,
                                trace_id=meta.get("trace_id"))
            # report from zero: the handoff tokens reach the router in
            # OUR stream, not the prefill worker's
            self._reported[rid] = 0

    def _abandon(self, erid, st):
        """The decode peer is unreachable (refused, or a send died mid
        stream, leaving a gap): give the request back to the router.
        The peer process may be alive, its heartbeats keeping the
        watchdog quiet, so decode-death failover would not cover it."""
        try:
            self.router.send("lost", {"rid": st["rid"],
                                      "gen": st["gen"]})
        except OSError:
            pass                          # the router is gone
        self.streamer.drop(erid)
        self.by_erid.pop(erid, None)
        self.by_rid.pop(st["rid"], None)
        self._reported.pop(st["rid"], None)
        if erid in self.eng.requests:
            if self.eng.requests[erid].state in ("queued", "running"):
                self.eng.cancel(erid)
            del self.eng.requests[erid]

    def _stream_pages(self, finished):
        """Prefill role, after a step: stream the newly completed pages
        of every request in flight; finish the stream and hand off the
        requests that sampled their token this step."""
        fin = set(finished or ())
        for erid, st in list(self.by_erid.items()):
            req = self.eng.requests.get(erid)
            if req is None:
                continue
            final = erid in fin
            dec = self._conn_or_none(st["meta"]["decode"])
            t_pump = time.perf_counter()
            if final:
                out = self.streamer.pump(
                    erid, st.get("final_n_cached", req.n_cached),
                    st.get("final_pages", req.pages), final=True)
            else:
                out = self.streamer.pump(erid, req.n_cached, req.pages)
            if out is not None and dec is not None:
                start, n, bufs = out
                t_send = time.perf_counter()
                try:
                    self._send_pages_frame(
                        dec, "pages",
                        {"srid": (st["rid"], st["gen"]),
                         "start": start, "n": n,
                         "trace_id": st["meta"].get("trace_id"),
                         "t_send": t_send}, bufs)
                    self._flight.record("pages_sent", rid=st["rid"],
                                        start=start, n=n)
                    # this side's part of a frame: the export (device to
                    # host) until t_send, then its write and send
                    self._spans.span(
                        st["rid"], "stream", t_pump, time.perf_counter(),
                        trace_id=st["meta"].get("trace_id"),
                        cat="transport",
                        args={"start": start, "pages": n,
                              "export_ms": (t_send - t_pump) * 1e3})
                except OSError:
                    self._drop_peer(st["meta"]["decode"])
                    dec = None            # a gap in the stream: abandon
            if dec is None and st["meta"]["max_new"] > 1:
                self._abandon(erid, st)
                continue
            if final:
                self._hand_off(erid, st, req, dec)

    def _hand_off(self, erid, st, req, dec):
        """A prefill request sampled its token: hand it to its decode
        worker, or report it done when prefill was all of it."""
        toks = [int(t) for t in req.generated]
        total = self.streamer.pending(erid)
        remaining = st["meta"]["max_new"] - len(toks)
        eos = st["meta"]["eos"]
        if eos is not None and toks and toks[-1] == eos:
            remaining = 0                 # eos at prefill: complete
        if remaining > 0:
            try:
                dec.send("handoff",
                         {"srid": (st["rid"], st["gen"]),
                          "total": total, "toks": toks,
                          "max_new": st["meta"]["max_new"],
                          "eos": st["meta"]["eos"],
                          "trace_id": st["meta"].get("trace_id")},
                         [np.ascontiguousarray(st["inp"]).data])
            except OSError:
                # the decode side never got it: saying "handed" would
                # strand the request on a worker that keeps heartbeating
                self._drop_peer(st["meta"]["decode"])
                self._report_inserts(req, st.get("final_chain_upto", 0))
                self._abandon(erid, st)
                return
            # a phase flip only: the decode worker reports the tokens
            self.router.send("handed", {"rid": st["rid"],
                                        "gen": st["gen"]})
        else:
            # prefill was the whole request: the decode side drops any
            # pages already streamed to it
            self.router.send("done", {"rid": st["rid"], "gen": st["gen"],
                                      "toks": toks})
            if dec is not None:
                try:
                    dec.send("drop", {"srid": (st["rid"], st["gen"])})
                except OSError:
                    pass
        t1 = time.perf_counter()
        self._spans.span(st["rid"], "prefill", st.get("t0", t1), t1,
                         trace_id=st["meta"].get("trace_id"),
                         args={"toks": len(toks), "pages": total,
                               "handed": remaining > 0})
        self._flight.record("handoff_sent" if remaining > 0 else "done",
                            rid=st["rid"], total=total)
        self._report_inserts(req, st.get("final_chain_upto", 0))
        self.streamer.drop(erid)
        self.by_erid.pop(erid, None)
        self.by_rid.pop(st["rid"], None)
        self._reported.pop(st["rid"], None)
        del self.eng.requests[erid]

    def _report_inserts(self, req, chain_upto):
        """Tell the router which chains this worker now holds
        (``chain_upto`` from the retire-time snapshot)."""
        if self.eng.prefix is None or chain_upto == 0:
            return
        keys = chain_keys(req.prompt, self.eng.page_size)[:chain_upto]
        if keys:
            try:
                self.router.send("insert", {"keys": keys})
            except OSError:
                pass

    def _flush_tokens(self, finished):
        """Decode role: stream each request's newly committed tokens;
        ``done`` when it finished."""
        fin = set(finished or ())
        for erid, st in list(self.by_erid.items()):
            req = self.eng.requests.get(erid)
            if req is None:
                continue
            rid = st["rid"]
            new = [int(t) for t in
                   req.generated[self._reported.get(rid, 0):]]
            if erid in fin:
                self.router.send("done", {"rid": rid, "gen": st["gen"],
                                          "toks": new})
                t1 = time.perf_counter()
                self._spans.span(
                    rid, "decode", self._decode_t0.pop(rid, t1), t1,
                    trace_id=st["meta"].get("trace_id"),
                    args={"toks": len(req.generated)})
                self._flight.record("done", rid=rid,
                                    toks=len(req.generated))
                self.by_erid.pop(erid, None)
                self.by_rid.pop(rid, None)
                self._reported.pop(rid, None)
                del self.eng.requests[erid]
            elif new:
                self.router.send("tokens", {"rid": rid, "gen": st["gen"],
                                            "toks": new})
                self._reported[rid] = len(req.generated)

    def _conn_or_none(self, name):
        try:
            return self._peer_conn(name)
        except (OSError, KeyError):
            return None

    def _drop_peer(self, name):
        """Forget a cached peer connection after a send failed (the
        next ``_peer_conn`` reconnects)."""
        conn = self._peer_conns.pop(name, None)
        if conn is not None:
            conn.close()

    def _step(self):
        """One engine step, timed on the host clock and, on the card, by
        CUDA events on the engine's stream (folded once they
        complete)."""
        t0 = time.perf_counter()
        if self.eng.device.type != "cuda":
            finished = self.eng.step()
            self.step_wall_ms += (time.perf_counter() - t0) * 1e3
            return finished
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        finished = self.eng.step()
        e1.record()
        self.step_wall_ms += (time.perf_counter() - t0) * 1e3
        self._step_events.append((e0, e1))
        while self._step_events and self._step_events[0][1].query():
            a, b = self._step_events.pop(0)
            self.device_ms += a.elapsed_time(b)
            self.device_steps += 1
        return finished

    def _maybe_send_stats(self):
        """The periodic stats tick (rate limited); a ``stats_req`` is
        answered by :meth:`_send_stats` at once."""
        if time.perf_counter() - self._last_stats < 0.25:
            return
        self._send_stats()
        spans = self._spans.drain()
        if spans:
            try:
                self.router.send("spans", {"spans": spans})
            except OSError:
                self._running = False

    def _send_stats(self, sid=None):
        """Send one stats frame now (the ``stats_req`` reply too)."""
        self._last_stats = time.perf_counter()
        eng = self.eng
        prefix = eng.prefix
        stats = {
            "role": self.role,
            "steps": eng.stats["steps"],
            "prefill_rows": eng.stats["prefill_rows"],
            "decode_rows": eng.stats["decode_rows"],
            "preemptions": eng.stats["preemptions"],
            "prefix_hit_tokens": eng.stats["prefix_hit_tokens"],
            "pages_in_use": eng.cache.pages_in_use,
            "free_pages": eng.cache.free_pages,
            "prefix_cached_pages":
                0 if prefix is None else prefix.cached_pages,
            "prefix_refs": 0 if prefix is None else prefix.refs_total,
            "active_requests": len(self.by_erid),
            "staged_rids": len(self.receiver.staged_rids),
            "remote_hits": self.remote_hits,
            "remote_hit_tokens": self.remote_hit_tokens,
            "remote_hits_host_tier": self.remote_hits_host_tier,
            "prefix_spilled_pages":
                0 if prefix is None else prefix.spilled_pages,
            "warm_hits": 0 if prefix is None else prefix.warm_hits_total,
            "warm_hit_tokens": 0 if prefix is None
                else prefix.warm_hit_tokens_total,
            "swap_outs": eng.stats["swap_outs"],
            "swap_ins": eng.stats["swap_ins"],
            "overlap_steps": eng.stats["overlap_steps"],
            "overlap_fences": eng.stats["overlap_fences"],
            "host_hidden_ms": eng.stats["host_hidden_ms"],
            "tier": None if eng.tier is None else {
                "pages_held": eng.tier.pages_held,
                "bytes_held": eng.tier.bytes_held,
                "budget_bytes": eng.tier.budget_bytes,
                "spilled_pages_total": eng.tier.spilled_pages_total,
                "installed_pages_total": eng.tier.installed_pages_total,
                "bytes_moved_total": eng.tier.bytes_moved_total,
                "evicted_pages_total": eng.tier.evicted_pages_total,
                "evictions_total": eng.tier.evictions_total},
            "bytes_streamed": self.streamer.bytes_streamed_total
            + self.fetch_bytes,
            "pages_streamed": self.streamer.pages_streamed_total,
            "pages_installed": self.receiver.pages_installed_total,
            # the logical page bytes above count the same on both
            # transports; these say how many rode shm puts
            "pages_put": self.pages_put_total,
            "put_bytes": self.put_bytes_total,
            # this process's transport segments, opened and released
            "put_opens": PUT_STATS["opens"],
            "put_releases": PUT_STATS["releases"],
            # the kernels' launches in this process (the card's graph
            # replays included), and the steps' device time
            "launches": _kernel_launches(),
            "device_ms": self.device_ms,
            "device_steps": self.device_steps,
            "step_wall_ms": self.step_wall_ms,
            # each sample travels once: the router observes every one
            "transfer_ms": self.transfer_ms,
        }
        self.transfer_ms = []
        if self._tier_moves:
            moves, self._tier_moves = self._tier_moves, {}
            by_tier: Dict[str, List[bytes]] = {}
            for k, t in moves.items():
                by_tier.setdefault(t, []).append(k)
            for t, keys in by_tier.items():
                try:
                    self.router.send("tier", {"keys": keys, "tier": t})
                except OSError:
                    pass
        if self._evicted_keys:
            keys, self._evicted_keys = self._evicted_keys, []
            try:
                self.router.send("evict", {"keys": keys})
            except OSError:
                pass
        try:
            self.router.send("stats", {"stats": stats, "sid": sid})
        except OSError:
            self._running = False

    # -- main loop ---------------------------------------------------
    def run(self):
        try:
            while self._running:
                drained = False
                while True:
                    try:
                        item = self.inbox.get_nowait()
                    except queue.Empty:
                        break
                    drained = True
                    self._handle(*item)
                self._serve_fetches()
                if not self._running:
                    break
                if self.role == "decode":
                    self._admit_ready()
                busy = bool(self.eng._queue) or any(
                    s is not None for s in self.eng._slots) \
                    or self.eng._inflight is not None
                if busy:
                    finished = self._step()
                    self._flight.record(
                        "step", active=len(self.by_erid),
                        finished=len(finished or ()))
                    if self.role == "prefill":
                        self._stream_pages(finished)
                    else:
                        self._flush_tokens(finished)
                elif not drained:
                    try:
                        self._handle(*self.inbox.get(timeout=0.02))
                    except queue.Empty:
                        pass
                self._maybe_send_stats()
        except Exception as e:
            try:
                self.router.send("error", {"msg": repr(e)})
            except OSError:
                pass
            raise
        finally:
            # the last spans: a worker shut down between ticks still
            # delivers them
            spans = self._spans.drain()
            if spans:
                try:
                    self.router.send("spans", {"spans": spans})
                except OSError:
                    pass
            self.eng.close()
            self.listener.close()
            self.router.close()
            for c in self._peer_conns.values():
                c.close()
            # an orderly exit needs no forensics: unlink the flight
            # ring (a SIGKILL skips this; the file is the evidence)
            self._flight.record("exit")
            self._flight.close(unlink=True)
            from .transport import put_sweep
            put_sweep()


def _disagg_worker_entry(name, role, router_host, router_port):
    """The worker process's entry (the ``multiprocessing`` spawn
    target).  Leaves through ``os._exit``, skipping the interpreter's
    teardown of a process that ran CUDA work on several threads; the
    router tracks liveness by the connection's EOF."""
    try:
        _DisaggWorker(name, role, router_host, router_port).run()
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)


def run_worker():
    """An externally launched worker (``tools.launch --launcher serve``
    or the bare environment): connects to the router at
    ``MXNET_SERVE_ROUTER_HOST``:``MXNET_SERVE_ROUTER_PORT`` as
    ``MXNET_SERVE_WORKER``, role ``MXNET_SERVE_ROLE``."""
    _disagg_worker_entry(
        os.environ["MXNET_SERVE_WORKER"],
        os.environ.get("MXNET_SERVE_ROLE", "prefill"),
        os.environ.get("MXNET_SERVE_ROUTER_HOST", "127.0.0.1"),
        int(os.environ["MXNET_SERVE_ROUTER_PORT"]))
