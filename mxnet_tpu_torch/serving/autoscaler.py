"""Metrics-driven autoscaler for the serving cluster.  Port of
``mxnet_tpu/serving/autoscaler.py``.

Every scaling decision is read off the cluster's OWN metrics registry:
the ``cluster_queue_depth``, ``cluster_in_flight`` and
``cluster_replicas_healthy`` (or ``cluster_workers_healthy``) gauges and
a sliding window over the ``cluster_ttft_ms`` histogram.  Every
actuation goes through the cluster's own paths,
:meth:`ServingCluster.add_replica` and
:meth:`~ServingCluster.remove_replica` (thread replicas, a graceful
drain with a checked zero-leak contract), through the actuation
protocol ``scale_up()``/``scale_down()``/``slots_per_replica``, and
:meth:`DisaggServingCluster.add_worker` /
:meth:`~DisaggServingCluster.drain_worker` (worker processes by role,
spawned here or joined from ``tools.launch --launcher serve
--workers-only``) through the same protocol.  The scaler never reaches
into request tables or engines: what the operator can see on the
scrape, the scaler acts on, and nothing else.

Policy:

* **scale up** when the waiting queue exceeds ``up_queue_factor ×``
  the healthy capacity (slots), or the windowed TTFT p95 exceeds
  ``ttft_p95_slo_ms`` (when set), sustained for ``up_ticks``
  consecutive control ticks (hysteresis), outside the cooldown, and
  below ``max_size``.
* **scale down** when waiting + in-flight would fit in
  ``down_queue_factor ×`` the capacity REMAINING after removing one
  replica, sustained for ``down_ticks`` (longer than ``up_ticks``:
  adding capacity late costs latency, removing it late costs only
  money), outside the cooldown, and above ``min_size``.
* below ``min_size`` (a replica died at the floor) capacity is restored
  at once, past hysteresis and cooldown.
* one actuation per tick, one shared cooldown: a flapping metric
  cannot move replicas up and down inside a single cooldown span.

The control loop is a single thread; every field is written at
construction or from that thread, so the loop needs no locks of its
own (the actuation paths take the cluster's).  ``tick()`` is public
and complete in itself, so tests drive the policy synchronously: the
thread is just ``tick`` on a timer.

Knob defaults come from ``MXNET_SERVE_*`` variables, so a deployment
retunes without code changes.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

from .cluster import _env_default

__all__ = ["Autoscaler", "HistogramWindow"]


class HistogramWindow:
    """Percentiles over the OBSERVATIONS SINCE THE LAST CALL of a
    cumulative fixed-bucket histogram (bucket-count diffing).  A
    control loop must react to the last tick's latency, not the
    lifetime distribution — a burst would otherwise be averaged away
    by hours of healthy history."""

    def __init__(self, hist):
        self.hist = hist
        self._last = list(hist.counts)

    def percentile(self, q: float) -> Optional[float]:
        """q-th percentile of the window, or None if the window holds
        no observations.  Advances the window."""
        counts = list(self.hist.counts)
        delta = [c - p for c, p in zip(counts, self._last)]
        self._last = counts
        total = sum(delta)
        if total <= 0:
            return None
        bounds = self.hist.bounds
        target = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(delta):
            if c == 0:
                continue
            if cum + c >= target:
                if i >= len(bounds):
                    return bounds[-1]
                lo = bounds[i - 1] if i > 0 else 0.0
                return lo + (bounds[i] - lo) * (target - cum) / c
            cum += c
        return bounds[-1]


class Autoscaler:
    """Drive a cluster's replica count from its metrics registry.

    ``cluster`` must expose the actuation protocol (``scale_up()`` /
    ``scale_down()`` / ``slots_per_replica``) and a live metrics
    ``registry``: a ``ServingCluster`` or ``DisaggServingCluster``
    built with ``metrics=True`` does.
    """

    def __init__(self, cluster, *, min_size=1, max_size=4,
                 interval_s=None, cooldown_s=None,
                 up_queue_factor=1.0, down_queue_factor=0.25,
                 ttft_p95_slo_ms=None, up_ticks=2, down_ticks=8,
                 drain_timeout_s=60.0):
        if cluster.registry is None:
            raise ValueError(
                "Autoscaler: the cluster has no metrics registry — "
                "construct it with metrics=True (the scaler is "
                "metrics-driven by design)")
        if min_size < 1 or max_size < min_size:
            raise ValueError("Autoscaler: need 1 <= min_size <= "
                             "max_size")
        if interval_s is None:
            interval_s = _env_default("MXNET_SERVE_SCALE_INTERVAL_S",
                                      0.25)
        if cooldown_s is None:
            cooldown_s = _env_default("MXNET_SERVE_SCALE_COOLDOWN_S",
                                      4.0 * float(interval_s))
        self.cluster = cluster
        self.min_size = int(min_size)
        self.max_size = int(max_size)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.up_queue_factor = float(up_queue_factor)
        self.down_queue_factor = float(down_queue_factor)
        self.ttft_p95_slo_ms = ttft_p95_slo_ms
        self.up_ticks = int(up_ticks)
        self.down_ticks = int(down_ticks)
        self.drain_timeout_s = float(drain_timeout_s)
        reg = cluster.registry
        # get-or-create: whichever gauges the cluster feeds carry the
        # signal, the rest read 0 (an in-process cluster has a queue; a
        # disaggregated one routes at once, its signal is in-flight and
        # TTFT)
        self._g_queue = reg.gauge("cluster_queue_depth")
        self._g_in_flight = reg.gauge("cluster_in_flight")
        self._g_replicas = reg.gauge("cluster_replicas_healthy")
        self._g_workers = reg.gauge("cluster_workers_healthy")
        self._ttft_window = HistogramWindow(
            reg.histogram("cluster_ttft_ms"))
        self._over_ticks = 0
        self._under_ticks = 0
        self._last_action_t: Optional[float] = None
        self._error: Optional[BaseException] = None
        # decision log for benchmarks/tests: {t, action, waiting,
        # in_flight, healthy, ttft_p95_ms}
        self.events: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # tell the cluster a scaler is watching: the zero-replica
        # state is then recoverable, so the router PARKS requests
        # stranded by a total loss instead of failing them
        cluster.scaler_attached = True

    @property
    def error(self):
        """The actuation error the control loop stopped on, if any (a
        caller polling for convergence reports it, not a misleading
        'never converged')."""
        return self._error

    # ------------------------------------------------------- policy --
    def _healthy(self):
        return int(max(self._g_replicas.value, self._g_workers.value))

    def tick(self, now=None):
        """One control decision.  Returns "up", "down", or None."""
        now = time.perf_counter() if now is None else now
        waiting = float(self._g_queue.value)
        in_flight = float(self._g_in_flight.value)
        healthy = self._healthy()
        slots = int(self.cluster.slots_per_replica)
        capacity = max(1, healthy) * slots
        ttft_p95 = self._ttft_window.percentile(95)
        if healthy < self.min_size and healthy < self.max_size:
            # self-heal: below min capacity (a replica died at the
            # floor) is restored at once; hysteresis and cooldown damp
            # load oscillation, they must not slow a recovery
            t_act = time.perf_counter()
            if self.cluster.scale_up():
                self._last_action_t = now
                self._over_ticks = 0
                self._under_ticks = 0
                self.events.append(
                    {"t": now, "action": "up", "self_heal": True,
                     "actuation_s": time.perf_counter() - t_act,
                     "waiting": waiting, "in_flight": in_flight,
                     "healthy": healthy, "ttft_p95_ms": ttft_p95})
                return "up"
        over = waiting > self.up_queue_factor * capacity
        if self.ttft_p95_slo_ms is not None and ttft_p95 is not None:
            over = over or ttft_p95 > float(self.ttft_p95_slo_ms)
        under = (waiting + in_flight
                 <= self.down_queue_factor
                 * max(0, healthy - 1) * slots)
        self._over_ticks = self._over_ticks + 1 if over else 0
        # an overloaded tick must also reset the scale-down streak, or
        # an oscillating queue could count both streaks at once
        self._under_ticks = 0 if over or not under \
            else self._under_ticks + 1
        cooling = (self._last_action_t is not None
                   and now - self._last_action_t < self.cooldown_s)
        action = None
        # each event carries its actuation time (a scale-up's build,
        # warm-up and capture), measured, not assumed
        t_act = time.perf_counter()
        if (self._over_ticks >= self.up_ticks and not cooling
                and healthy < self.max_size):
            if self.cluster.scale_up():
                action = "up"
        elif (self._under_ticks >= self.down_ticks and not cooling
                and healthy > self.min_size):
            if self.cluster.scale_down(timeout=self.drain_timeout_s):
                action = "down"
        if action is not None:
            self._last_action_t = now
            self._over_ticks = 0
            self._under_ticks = 0
            self.events.append(
                {"t": now, "action": action,
                 "actuation_s": time.perf_counter() - t_act,
                 "waiting": waiting, "in_flight": in_flight,
                 "healthy": healthy, "ttft_p95_ms": ttft_p95})
        return action

    def _detach(self):
        """Tell the cluster no healer is watching anymore — it stops
        parking total-loss requests and fails any already parked
        (their result() waiters must not hang forever on a self-heal
        that will never come)."""
        cl = self.cluster
        if getattr(cl, "scaler_attached", False):
            fn = getattr(cl, "detach_scaler", None)
            if fn is not None:
                fn()
            else:
                cl.scaler_attached = False

    # -------------------------------------------------- control loop --
    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # a broken actuation (say the cluster closed under
                # us) stops the scaler rather than spinning; close()
                # raises it again.  Detach now: a dead scaler must not
                # keep the cluster parking requests it can never heal.
                self._error = e
                self._detach()
                return

    def start(self):
        if self._thread is not None:
            raise RuntimeError("Autoscaler already started")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serving-autoscaler")
        self._thread.start()
        return self

    def close(self, timeout=None):
        """Stop the control loop and detach from the cluster (it
        stops parking total-loss requests); raises again an actuation
        error the loop stopped on."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        self._detach()
        if self._error is not None:
            raise self._error

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        # an exception already unwinding takes precedence over a
        # parked scaler error
        try:
            self.close()
        except Exception:
            if exc_type is None:
                raise
