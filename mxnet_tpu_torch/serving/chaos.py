"""Deterministic fault injection for the serving cluster.  Port of
``mxnet_tpu/serving/chaos.py``.

A chaos schedule is fully identified by its seed: :func:`chaos_schedule`
draws the same events as the reference's for the same arguments, and
events fire at times relative to the replay loop's own clock, so a
scenario replays from its seed alone.

Event kinds, in process (``ServingCluster``) and over worker processes
(``DisaggServingCluster``):

* ``kill``: an injected raise in the victim replica's next ``step()``
  (the worker-raise failover path); a real ``SIGKILL`` of the victim
  worker process;
* ``stall``: an injected sleep of 1.5 watchdog periods before the
  victim's next step (the monitor's stall failover; the late step that
  follows is fenced); ``SIGSTOP`` of the worker process (alive and
  silent, the watchdog's case);
* ``cancel``: ``cluster.cancel(rid)`` on a seeded live request (a
  client's disconnect), in both;
* ``reset`` has nothing to act on in process and fires no fault; over
  worker processes the router closes the victim's control connection.

A stalled worker process cannot run signal handlers; ``close()``
SIGKILLs every pid still stopped, so a chaos run leaves no stopped
process behind.

The driver is POLLED from the replay loop (``poll(now_rel)``), not
threaded: the application point is a deterministic place in the
caller's own sequence, and the only draw left is the victim's, taken
from the driver's seeded ``random.Random`` over the eligible victims
sorted by index or name (requests by rid).
"""
from __future__ import annotations

import os
import random
import time
from typing import List

__all__ = ["ChaosEvent", "ChaosDriver", "chaos_schedule"]


class ChaosEvent:
    """One scheduled fault.  ``target`` is None (seeded draw at fire
    time), a replica index (in-process), or a worker name / role
    prefix (disagg)."""
    __slots__ = ("t", "kind", "target")

    def __init__(self, t, kind, target=None):
        if kind not in ("kill", "stall", "reset", "cancel"):
            raise ValueError("ChaosEvent: kind must be kill/stall/"
                             "reset/cancel, got %r" % (kind,))
        self.t = float(t)
        self.kind = kind
        self.target = target

    def __repr__(self):
        return "ChaosEvent(t=%.3f, %s, target=%r)" % (
            self.t, self.kind, self.target)


def chaos_schedule(seed: int, duration_s: float, n_events: int = 1,
                   kinds=("kill",), window=(0.25, 0.75)
                   ) -> List[ChaosEvent]:
    """Seeded event schedule: ``n_events`` faults at times drawn
    uniformly inside ``window`` (fractions of ``duration_s``), kinds
    cycling through ``kinds``.  Same seed ⇒ same schedule."""
    rng = random.Random(seed)
    lo, hi = window
    times = sorted(rng.uniform(lo * duration_s, hi * duration_s)
                   for _ in range(n_events))
    return [ChaosEvent(t, kinds[i % len(kinds)])
            for i, t in enumerate(times)]


class ChaosDriver:
    """Apply a chaos schedule to a live cluster as replay time
    passes.  ``poll(now_rel)`` fires every not-yet-applied event whose
    time has come; ``applied`` is the log of what fired, and on
    whom."""

    def __init__(self, cluster, events, seed: int = 0):
        self.cluster = cluster
        self.events = sorted(events, key=lambda e: e.t)
        self.rng = random.Random(seed)
        self._next = 0
        self.applied: List[dict] = []
        self._stopped_pids: List[int] = []
        # the disaggregated cluster is the one with worker PROCESSES
        self._disagg = hasattr(cluster, "kill_worker")

    # ------------------------------------------------------- firing --
    def poll(self, now_rel: float):
        """Fire due events.  Returns the number fired."""
        fired = 0
        while self._next < len(self.events) \
                and self.events[self._next].t <= now_rel:
            ev = self.events[self._next]
            self._next += 1
            victim = self._apply(ev)
            self.applied.append(
                {"t": ev.t, "kind": ev.kind, "victim": victim})
            fired += 1
        return fired

    def done(self):
        return self._next >= len(self.events)

    # ------------------------------------------------------ victims --
    def _apply(self, ev):
        if ev.kind == "cancel":
            return self._apply_cancel(ev)
        if self._disagg:
            return self._apply_disagg(ev)
        return self._apply_inproc(ev)

    def _apply_cancel(self, ev):
        """The client-disconnect fault: ``cancel(rid)`` on a seeded
        draw over the live (queued or running) requests sorted by rid;
        ``target`` may name a rid.  The request's slot and pages free
        at once, and the outcome is counted on
        ``cluster_cancelled_total``."""
        with self.cluster._lock:
            live = sorted(rid for rid, cr
                          in self.cluster.requests.items()
                          if cr.state in ("queued", "running"))
        if ev.target is not None:
            live = [rid for rid in live if rid == ev.target]
        if not live:
            return None
        rid = self.rng.choice(live)
        try:
            took = self.cluster.cancel(rid)
        except KeyError:
            took = False          # purged between snapshot and cancel
        # a False cancel means the victim finished between the
        # snapshot and the cancel: report no victim, so counts of
        # cancels stay exact
        return rid if took else None

    def _pick_worker(self, ev):
        ws = [w for w in self.cluster.workers.values()
              if w.alive and not w.draining]
        if isinstance(ev.target, str):
            exact = [w for w in ws if w.name == ev.target]
            ws = exact or [w for w in ws if w.role == ev.target]
        if not ws:
            return None
        return self.rng.choice(sorted(ws, key=lambda w: w.name))

    def _pick_replica(self, ev):
        reps = [r for r in self.cluster.replicas
                if r.alive and not r.dead and not r.draining
                and r.engine is not None]
        if ev.target is not None:
            reps = [r for r in reps if r.idx == ev.target]
        if not reps:
            return None
        return self.rng.choice(sorted(reps, key=lambda r: r.idx))

    # ----------------------------------------------- in-process arm --
    def _apply_inproc(self, ev):
        if ev.kind == "reset":
            return None                   # no connections to reset
        rep = self._pick_replica(ev)
        if rep is None:
            return None
        eng = rep.engine
        orig = eng.step
        armed = [True]
        if ev.kind == "kill":
            def chaos_step():
                if armed[0]:
                    armed[0] = False
                    raise RuntimeError(
                        "chaos: injected death of replica %d"
                        % rep.idx)
                return orig()
        else:                             # stall past the watchdog
            stall_s = self.cluster.watchdog_s * 1.5

            def chaos_step():
                if armed[0]:
                    armed[0] = False
                    time.sleep(stall_s)
                return orig()
        eng.step = chaos_step
        return rep.idx

    # ---------------------------------------------------- disagg arm --
    def _apply_disagg(self, ev):
        import signal
        wh = self._pick_worker(ev)
        if wh is None:
            return None
        if ev.kind == "kill":
            self.cluster.kill_worker(wh.name)
        elif ev.kind == "stall":
            if wh.proc is None:
                return None
            self._stopped_pids.append(wh.proc.pid)
            self.cluster.kill_worker(wh.name, sig=signal.SIGSTOP)
        else:                             # reset: drop the control conn
            try:
                wh.conn.close()
            except Exception:
                pass
        return wh.name

    def close(self):
        """Reap the worker processes a stall stopped (a SIGSTOPped
        process cannot take SIGTERM)."""
        import signal
        for pid in self._stopped_pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        self._stopped_pids = []
