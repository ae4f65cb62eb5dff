"""Port parity: the autoscaler (``serving/autoscaler.py``) and chaos
injection (``serving/chaos.py``) of ``mxnet_tpu_torch`` against the
reference's, on the CPU.

The policy is driven synchronously through a metrics-only stand-in
cluster, the port's and the reference's side by side on the same seeded
gauge and TTFT sequences, decision for decision and event for event;
the reference's own hysteresis, cooldown and budget pins hold on the
port; ``HistogramWindow`` gives the reference's percentiles;
``chaos_schedule`` draws the reference's events for the same seeds.
Live, on the tiny f32 GPT with the reference's weights: a burst scales a
one-replica cluster up, a chaos ``kill`` fires on a seeded victim, idling
drains it back to one through the checked zero-leak drain, and every
output equals the reference's ``generate``; the self-heal of a total
loss parks requests and serves them exactly; a chaos ``cancel`` frees
its request; over worker processes a chaos ``kill`` SIGKILLs a decode
worker and the outputs stay exact."""
import time

import numpy as np
import pytest

from _torch_port import (assert_no_leak, configs, numpy_params,
                         ref_generate, to_port)

TIMEOUT = 120


class _FakeScalableCluster:
    """Metrics-only stand-in: the policy must be drivable from the
    registry alone, so the stand-in has the actuation protocol and a
    registry and nothing else."""

    def __init__(self, registry, slots=4):
        self.registry = registry
        self.slots_per_replica = slots
        self.ups = 0
        self.downs = 0

    def scale_up(self):
        self.ups += 1
        g = self.registry.gauge("cluster_replicas_healthy")
        g.set(g.value + 1)
        return True

    def scale_down(self, timeout=None):
        self.downs += 1
        g = self.registry.gauge("cluster_replicas_healthy")
        g.set(g.value - 1)
        return True


def _packages():
    import mxnet_tpu.obs as RO
    import mxnet_tpu.serving as RS
    import mxnet_tpu_torch.obs as PO
    import mxnet_tpu_torch.serving as PS
    return (RO, RS), (PO, PS)


def test_policy_decisions_equal_the_reference_s_tick_by_tick():
    """Seeded gauge, in-flight and TTFT sequences through both
    packages' scalers (an SLO set, up/down hysteresis, a cooldown, a
    floor of 2 so the self-heal fires too): every tick's decision and
    the whole event log agree."""
    runs = []
    for O, S in _packages():
        reg = O.MetricsRegistry()
        cl = _FakeScalableCluster(reg, slots=4)
        g_q = reg.gauge("cluster_queue_depth")
        g_if = reg.gauge("cluster_in_flight")
        g_h = reg.gauge("cluster_replicas_healthy")
        h = reg.histogram("cluster_ttft_ms")
        g_h.set(1)
        sc = S.Autoscaler(cl, min_size=2, max_size=5, interval_s=0.01,
                          cooldown_s=3.0, up_ticks=2, down_ticks=4,
                          up_queue_factor=1.0, down_queue_factor=0.5,
                          ttft_p95_slo_ms=250.0)
        rng = np.random.RandomState(4)
        decisions = []
        for t in range(400):
            phase = (t // 40) % 3
            g_q.set(float(rng.poisson((30.0, 2.0, 0.0)[phase])))
            g_if.set(float(rng.poisson((8.0, 3.0, 0.5)[phase])))
            for _ in range(rng.randint(0, 4)):
                h.observe(float(rng.exponential((400.0, 80.0, 20.0)
                                                [phase])))
            if t in (150, 290):                # a replica dies
                g_h.set(max(0.0, g_h.value - 2))
            decisions.append(sc.tick(100.0 + 0.5 * t))
        # every field but the measured actuation time
        events = [{k: v for k, v in e.items() if k != "actuation_s"}
                  for e in sc.events]
        runs.append((decisions, events, cl.ups, cl.downs))
    ref, port = runs
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2:] == ref[2:]
    assert port[2] > 2 and port[3] > 2
    assert any(e.get("self_heal") for e in port[1])


def test_autoscaler_policy_hysteresis_cooldown_budget():
    from mxnet_tpu_torch.obs import MetricsRegistry
    from mxnet_tpu_torch.serving import Autoscaler
    reg = MetricsRegistry()
    cl = _FakeScalableCluster(reg, slots=4)
    g_q = reg.gauge("cluster_queue_depth")
    g_if = reg.gauge("cluster_in_flight")
    reg.gauge("cluster_replicas_healthy").set(1)
    sc = Autoscaler(cl, min_size=1, max_size=2, interval_s=0.01,
                    cooldown_s=10.0, up_ticks=2, down_ticks=3,
                    up_queue_factor=1.0, down_queue_factor=0.5)
    t = 100.0
    g_q.set(50)
    assert sc.tick(t) is None
    assert sc.tick(t + 1) == "up" and cl.ups == 1
    assert sc.tick(t + 2) is None
    assert sc.tick(t + 3) is None
    t += 20
    assert sc.tick(t) is None
    assert sc.tick(t + 1) is None
    assert cl.ups == 1
    g_q.set(0)
    g_if.set(0)
    t += 20
    assert sc.tick(t) is None
    assert sc.tick(t + 1) is None
    assert sc.tick(t + 2) == "down" and cl.downs == 1
    t += 40
    for i in range(5):
        assert sc.tick(t + i) is None
    assert cl.downs == 1
    assert [e["action"] for e in sc.events] == ["up", "down"]

    class NoMetrics:
        registry = None

    with pytest.raises(ValueError):
        Autoscaler(NoMetrics())
    with pytest.raises(ValueError):
        Autoscaler(cl, min_size=3, max_size=2)


def test_histogram_window_percentiles_equal_the_reference_s():
    rng = np.random.RandomState(0)
    got = []
    for O, S in _packages():
        h = O.Histogram("w")
        for v in (1.0, 2.0, 3.0):
            h.observe(v)
        win = S.HistogramWindow(h)
        seq = [win.percentile(95)]
        r = np.random.RandomState(1)
        for _ in range(30):
            for _ in range(r.randint(0, 6)):
                h.observe(float(r.exponential(200.0)))
            seq.append(win.percentile(r.choice([50, 95, 99])))
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][0] is None and any(x is not None for x in got[1])
    del rng


def test_chaos_schedule_is_the_reference_s_for_the_same_seed():
    (_, RS), (_, PS) = _packages()
    for seed in range(12):
        for kinds in (("kill",), ("kill", "stall"),
                      ("kill", "stall", "cancel")):
            kw = dict(n_events=1 + seed % 4, kinds=kinds,
                      window=(0.1 * (seed % 3), 0.9))
            a = PS.chaos_schedule(seed, 7.5, **kw)
            b = RS.chaos_schedule(seed, 7.5, **kw)
            assert [(e.t, e.kind, e.target) for e in a] == \
                [(e.t, e.kind, e.target) for e in b]
            assert repr(a) == repr(b)
    a = PS.chaos_schedule(7, 10.0, n_events=3, kinds=("kill", "stall"))
    assert all(2.5 <= e.t <= 7.5 for e in a)
    with pytest.raises(ValueError):
        PS.ChaosEvent(0.0, "explode")


def test_chaos_kills_a_worker_process_and_outputs_stay_exact():
    """The disaggregated arm: a chaos ``kill`` aimed at the decode role
    SIGKILLs a seeded decode worker process mid-decode; its requests
    resume on the survivor and every output equals the reference's
    ``generate``; a ``stall`` stops a process that ``close()`` reaps."""
    import signal
    from mxnet_tpu_torch.serving import (ChaosDriver, ChaosEvent,
                                         DisaggServingCluster)
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(5)
    wl = [(rng.randint(1, 90, int(P)).astype(np.int32), 32)
          for P in (6, 11, 17, 9)]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = DisaggServingCluster(to_port(tree), tcfg, prefill=1, decode=2,
                              num_slots=4, page_size=4, metrics=True,
                              watchdog_s=60.0, device="cpu",
                              ready_timeout=TIMEOUT)
    drv = ChaosDriver(cl, [ChaosEvent(0.0, "kill", target="decode")],
                      seed=1)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        _wait(lambda: any(r.state == "running" and r.phase == "decode"
                          and 0 < len(r.committed) < r.max_new_tokens
                          for r in list(cl.requests.values())),
              "no request caught mid-decode", TIMEOUT)
        assert drv.poll(1.0) == 1
        victim = drv.applied[0]["victim"]
        assert victim in ("decode0", "decode1")
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT),
                                          w)
        _wait(lambda: cl.workers[victim].dead, "the kill was not seen")
        assert cl.registry.snapshot()["counters"][
            "cluster_failovers_total"] == 1
        stall = ChaosDriver(cl, [ChaosEvent(0.0, "stall",
                                            target="prefill0")])
        assert stall.poll(0.0) == 1 and stall._stopped_pids
        pid = stall._stopped_pids[0]
        stall.close()
        _wait(lambda: not cl.workers["prefill0"].proc.is_alive(),
              "the stopped worker was not reaped")
        with pytest.raises(ProcessLookupError):
            __import__("os").kill(pid, signal.SIGCONT)
    finally:
        drv.close()
        cl.close()


# --- live, on the tiny GPT --------------------------------------------------
_SETUP = {}


def _setup():
    if not _SETUP:
        jcfg, tcfg = configs()
        _SETUP["v"] = (jcfg, tcfg, numpy_params(jcfg, 3))
    return _SETUP["v"]


_REFS = {}


def _ref(tree, jcfg, p, n):
    """The oracle's output, computed before a cluster starts (its
    compiles hold the interpreter lock, which a watchdog would read as a
    stall)."""
    key = (p.tobytes(), n)
    if key not in _REFS:
        _REFS[key] = ref_generate(tree, jcfg, p, n)
    return _REFS[key]


def _cluster(tcfg, tree, **kw):
    from mxnet_tpu_torch.serving import ServingCluster
    return ServingCluster(to_port(tree), tcfg, num_slots=2, page_size=4,
                          prefill_chunk=6, metrics=True, device="cpu", **kw)


def _live_no_leak(cl):
    for rep in cl.replicas:
        if rep.engine is not None and not rep.dead:
            assert_no_leak(rep.engine)


def _wait(cond, what, limit=60.0):
    deadline = time.perf_counter() + limit
    while not cond():
        assert time.perf_counter() < deadline, what
        time.sleep(0.01)


def test_scale_up_chaos_kill_and_drain_down_exact():
    """A burst scales one replica up to at least two; a chaos ``kill``
    on a seeded victim fails it over; idling brings the cluster back to
    one replica through the checked drain; every output is exact and no
    live replica holds a page or ref."""
    from mxnet_tpu_torch.serving import Autoscaler, ChaosDriver, ChaosEvent
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(5)
    wl = [(rng.randint(1, 90, 4 + (i % 5)).astype(np.int32), 6 + (i % 4))
          for i in range(20)]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = _cluster(tcfg, tree, replicas=1, max_queue=10 ** 6,
                  watchdog_s=5.0)
    sc = Autoscaler(cl, min_size=1, max_size=3, interval_s=0.02,
                    cooldown_s=0.1, up_ticks=1, down_ticks=5,
                    up_queue_factor=0.5, down_queue_factor=0.5)
    drv = ChaosDriver(cl, [ChaosEvent(0.0, "kill")], seed=3)
    sc.start()
    try:
        slow = []
        for rep in cl.replicas:             # hold the burst in the queue
            orig = rep.engine.step

            def step(orig=orig):
                time.sleep(0.01)
                return orig()

            rep.engine.step = step
            slow.append(rep)
        # the burst's first half queues on the one replica and scales the
        # cluster up; the second half is routed to the new capacity
        rids = [cl.submit(p, n) for p, n in wl[:12]]
        _wait(lambda: len(cl._healthy()) >= 2, "never scaled up")
        rids += [cl.submit(p, n) for p, n in wl[12:]]
        _wait(lambda: any(r.engine.stats["steps"] > 0
                          for r in cl.replicas[1:] if r.engine),
              "the new replica never stepped")
        assert drv.poll(0.0) == 1
        victim = drv.applied[0]["victim"]
        assert victim is not None
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT), w)
        _wait(lambda: len(cl._healthy()) == 1, "never drained down")
        kinds = [e["action"] for e in sc.events]
        assert "up" in kinds and "down" in kinds
        assert all(e["actuation_s"] >= 0 for e in sc.events)
        c = cl.metrics()["counters"]
        assert c["cluster_failovers_total"] == 1
        assert c["cluster_scale_ups_total"] >= 1
        assert c["cluster_scale_downs_total"] >= 1
        assert c["cluster_requests_completed_total"] == len(wl)
        assert cl.replicas[victim].dead
        assert any(r.engine is None for r in cl.replicas)
        assert sc.error is None
    finally:
        drv.close()
        sc.close()
        cl.close(timeout=60)
    _live_no_leak(cl)


def test_self_heal_after_total_loss_parks_and_serves_exactly():
    from mxnet_tpu_torch.serving import (Autoscaler, ChaosDriver,
                                         ChaosEvent, ClusterClosed,
                                         ClusterOverloaded)
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(6)
    wl = [(rng.randint(1, 90, 6).astype(np.int32), 8) for _ in range(4)]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = _cluster(tcfg, tree, replicas=1)
    sc = Autoscaler(cl, min_size=1, max_size=2, interval_s=0.02,
                    cooldown_s=5.0, up_ticks=100, down_ticks=10 ** 6)
    drv = ChaosDriver(cl, [ChaosEvent(0.0, "kill")], seed=0)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        drv.poll(0.0)
        _wait(lambda: not cl._healthy(), "the only replica never died")
        with pytest.raises(ClusterOverloaded) as ei:
            cl.submit(np.ones(4, np.int32), 2)
        assert ei.value.retry_after_s > 0
        assert all(not cl.requests[r].done_evt.is_set() for r in rids)
        assert sc.tick() == "up" and sc.events[-1]["self_heal"]
        for rid, w in zip(rids, want):
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT), w)
        r2 = cl.submit(np.ones(4, np.int32), 2)
        cl.result(r2, timeout=TIMEOUT)
        _live_no_leak(cl)
    finally:
        drv.close()
        sc.close()
        cl.close(timeout=60)
    with pytest.raises(ClusterClosed):
        cl.submit(np.ones(4, np.int32), 2)


def test_chaos_cancel_and_stall_on_a_live_cluster():
    """A seeded ``cancel`` frees a live request (counted once); a
    ``stall`` sleeps one replica past the watchdog, which fails it over;
    the other requests finish exactly."""
    from mxnet_tpu_torch.serving import (ChaosDriver, ChaosEvent,
                                         RequestCancelled)
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(8)
    wl = [(rng.randint(1, 90, 5).astype(np.int32), 12) for _ in range(6)]
    want = [_ref(tree, jcfg, p, n) for p, n in wl]
    cl = _cluster(tcfg, tree, replicas=2, watchdog_s=1.0)
    drv = ChaosDriver(cl, [ChaosEvent(0.0, "cancel"),
                           ChaosEvent(0.1, "stall", target=0)], seed=1)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        assert drv.poll(0.05) == 1
        victim = drv.applied[0]["victim"]
        assert victim in rids
        assert drv.poll(0.2) == 1 and drv.done()
        assert drv.applied[1] == {"t": 0.1, "kind": "stall", "victim": 0}
        for rid, w in zip(rids, want):
            if rid == victim:
                with pytest.raises(RequestCancelled):
                    cl.result(rid, timeout=TIMEOUT)
                continue
            np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT), w)
        c = cl.metrics()["counters"]
        assert c["cluster_cancelled_total"] == 1
        assert c["cluster_failovers_total"] == 1
        assert cl.replicas[0].dead
    finally:
        drv.close()
        cl.close(timeout=60)
    _live_no_leak(cl)
