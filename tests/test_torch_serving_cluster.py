"""Port parity: the in-process serving cluster
(``mxnet_tpu_torch/serving/cluster.py``) against the reference's, on
the CPU at the tiny f32 GPT of tests/test_serving_cluster.py, with the
reference's weights through ``convert.from_jax``.

Twins of the reference's cluster tests: every output of 1, 2 and 3
replicas (prefix hits and a copy on write included), after a forced
replica failure, after a watchdog stall and under a drain racing a burst
of submits is token-identical to the reference's ``generate``, and no
page or prefix ref is left on a live replica.  Backpressure with its
``retry_after_s``, TTL expiry, cancel and the token stream, validation,
``close`` and result retention follow the reference's contracts; the
router's choices are held against the reference's ``_route_locked`` on
the same replica states; ``rid_start`` gives disjoint rid blocks; the
``cluster_*`` metrics have the reference's names, types and help; the
replicas share one copy of the weights.

The ``cuda`` test runs two replicas on the card and adds a third while
they serve: the new replica's capture overlaps the others' replays, and
every output equals ``generate`` on the card token for token (no JAX
there: this file imports the reference only inside its CPU tests)."""
import threading
import time

import numpy as np
import pytest

from _torch_port import (assert_no_leak, configs, cuda_device,  # noqa: F401
                         numpy_params, ref_generate, to_port)

TIMEOUT = 120


def _tree(seed=3):
    jcfg, tcfg = configs()
    return jcfg, tcfg, numpy_params(jcfg, seed)


_REFS = {}


def _ref(tree, jcfg, prompt, n):
    key = (id(tree), prompt.tobytes(), n)
    if key not in _REFS:
        _REFS[key] = ref_generate(tree, jcfg, prompt, n)
    return _REFS[key]


_SETUP = {}


def _setup():
    """One weight tree for the whole file (the reference's ``generate``
    compiles once per prompt shape: a shared workload keeps it cheap)."""
    if not _SETUP:
        _SETUP["v"] = _tree()
    return _SETUP["v"]


def _mixed_workload(rng, shared, n):
    out = []
    for i in range(n):
        if i % 2 == 0:
            p = np.concatenate([shared, rng.randint(1, 90, 2 + i)
                                .astype(np.int32)])
        else:
            p = rng.randint(1, 90, 4 + i).astype(np.int32)
        out.append((p, 5 + (i % 5)))
    return out


def _workload():
    rng = np.random.RandomState(1)
    shared = rng.randint(1, 90, 8).astype(np.int32)
    wl = _mixed_workload(rng, shared, 8)
    wl.append(wl[0])               # whole-input match: a copy on write
    return wl


def _refs(tree, jcfg, wl):
    """The oracle's outputs, computed before a cluster starts: the
    reference's compiles hold the interpreter lock for long stretches,
    which a running cluster's watchdog would read as a stall."""
    return [_ref(tree, jcfg, p, n) for p, n in wl]


def _cluster(tcfg, tree, **kw):
    from mxnet_tpu_torch.serving import ServingCluster
    base = dict(num_slots=2, page_size=4, prefill_chunk=6, device="cpu")
    base.update(kw)
    return ServingCluster(to_port(tree), tcfg, **base)


def _check_exact(cl, rids, wl, tree, jcfg):
    for rid, (p, n) in zip(rids, wl):
        np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT),
                                      _ref(tree, jcfg, p, n))


def _live_no_leak(cl):
    for rep in cl.replicas:
        if rep.engine is not None and not rep.dead:
            assert_no_leak(rep.engine)


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_cluster_exactness_any_replica_count(replicas):
    jcfg, tcfg, tree = _setup()
    wl = _workload()
    _refs(tree, jcfg, wl)
    cl = _cluster(tcfg, tree, replicas=replicas, metrics=True)
    try:
        rids = [cl.submit(p, n) for p, n in wl]
        _check_exact(cl, rids, wl, tree, jcfg)
        assert sum(r.engine.stats["prefix_hit_tokens"]
                   for r in cl.replicas) > 0
        c = cl.metrics()["counters"]
        assert c["cluster_requests_completed_total"] == len(wl)
        assert c["cluster_routed_affinity_total"] + \
            c["cluster_routed_least_loaded_total"] == len(wl)
        assert len(cl.metrics()["replicas"]) == replicas
        if replicas > 1:
            assert len({cl.requests[r].replica for r in rids}) > 1
    finally:
        cl.close(timeout=60)
    _live_no_leak(cl)


def _bombed(eng, when, action):
    orig, calls = eng.step, [0]

    def step():
        calls[0] += 1
        if calls[0] == when:
            action()
        return orig()

    eng.step = step


def test_cluster_failover_resubmit_exact():
    """Replica 0's step raises at its 4th call: its waiting and
    in-flight requests resume on the survivor with their committed
    tokens, exactly."""
    jcfg, tcfg, tree = _setup()
    wl = _workload()[:6]
    _refs(tree, jcfg, wl)
    cl = _cluster(tcfg, tree, replicas=2, metrics=True, watchdog_s=10.0)
    try:
        def boom():
            raise RuntimeError("injected replica failure")

        _bombed(cl.replicas[0].engine, 4, boom)
        rids = [cl.submit(p, n) for p, n in wl]
        _check_exact(cl, rids, wl, tree, jcfg)
        c = cl.metrics()["counters"]
        assert c["cluster_failovers_total"] == 1
        assert c["cluster_requests_completed_total"] == len(wl)
        assert c["cluster_requests_resubmitted_total"] >= 1
        health = {h["replica"]: h for h in cl.health()}
        assert health[0]["dead"] and not health[0]["alive"]
        assert "injected" in health[0]["error"]
        assert health[1]["alive"]
        assert any(cl.requests[r].failovers > 0 for r in rids)
    finally:
        cl.close(timeout=60)
    _live_no_leak(cl)


def test_cluster_watchdog_stall_failover():
    """Replica 0 sleeps past the watchdog at its 3rd step: the monitor
    fails it over, the survivor finishes its requests exactly, and the
    stalled replica's late step delivers nothing."""
    jcfg, tcfg, tree = _setup()
    wl = _workload()[:6]
    _refs(tree, jcfg, wl)
    cl = _cluster(tcfg, tree, replicas=2, metrics=True, watchdog_s=1.0)
    try:
        _bombed(cl.replicas[0].engine, 3, lambda: time.sleep(2.5))
        rids = [cl.submit(p, n) for p, n in wl]
        _check_exact(cl, rids, wl, tree, jcfg)
        c = cl.metrics()["counters"]
        assert c["cluster_failovers_total"] == 1
        assert c["cluster_requests_completed_total"] == len(wl)
        assert "stalled past watchdog" in cl.health()[0]["error"]
        assert all(cl.requests[r].replica == 1 for r in rids
                   if cl.requests[r].failovers)
    finally:
        cl.close(timeout=60)
    _live_no_leak(cl)


def test_cluster_drain_while_submitting_race():
    """``drain_replica(0)`` against a burst of submits from another
    thread: strays reroute, nothing lands on the drained replica, every
    output is exact; then one more request lands on the survivor."""
    jcfg, tcfg, tree = _setup()
    wl = _workload()
    _refs(tree, jcfg, wl)
    cl = _cluster(tcfg, tree, replicas=2, metrics=True)
    try:
        rids = []

        def submitter():
            for p, n in wl:
                rids.append(cl.submit(p, n))

        th = threading.Thread(target=submitter)
        th.start()
        assert cl.drain_replica(0, timeout=TIMEOUT)
        th.join(TIMEOUT)
        assert len(rids) == len(wl)
        _check_exact(cl, rids, wl, tree, jcfg)
        health = {h["replica"]: h for h in cl.health()}
        assert health[0]["draining"] and not health[0]["alive"]
        assert health[0]["in_flight"] == 0 and health[0]["waiting"] == 0
        p2, n2 = wl[3]
        r2 = cl.submit(p2, n2)
        np.testing.assert_array_equal(cl.result(r2, timeout=TIMEOUT),
                                      _ref(tree, jcfg, p2, n2))
        assert cl.requests[r2].replica == 1
    finally:
        cl.close(timeout=60)
    _live_no_leak(cl)


def test_cluster_backpressure_ttl_and_retry_after():
    from mxnet_tpu_torch.serving import ClusterOverloaded, RequestExpired
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(7)
    p_ok = rng.randint(1, 90, 4).astype(np.int32)
    want = _ref(tree, jcfg, p_ok, 20)
    cl = _cluster(tcfg, tree, replicas=1, num_slots=1, prefill_chunk=4,
                  metrics=True, max_queue=3)
    try:
        r_ok = cl.submit(p_ok, 20)
        r_ttl = cl.submit(rng.randint(1, 90, 4).astype(np.int32), 4,
                          ttl_s=0.0)
        with pytest.raises(ClusterOverloaded) as ei:
            for _ in range(10):
                cl.submit(rng.randint(1, 90, 4).astype(np.int32), 4)
        assert ei.value.retry_after_s is not None
        assert 0 < ei.value.retry_after_s <= cl.watchdog_s
        assert "retry after" in str(ei.value)
        assert cl.metrics()["gauges"]["cluster_retry_after_s"] == \
            ei.value.retry_after_s
        with pytest.raises(RequestExpired):
            cl.result(r_ttl, timeout=TIMEOUT)
        np.testing.assert_array_equal(cl.result(r_ok, timeout=TIMEOUT),
                                      want)
        assert cl.drain(timeout=TIMEOUT)
        c = cl.metrics()["counters"]
        assert c["cluster_requests_rejected_total"] >= 1
        assert c["cluster_requests_expired_total"] == 1
    finally:
        cl.close(timeout=60)
    _live_no_leak(cl)


def test_cluster_cancel_stream_and_status():
    """A stream listener sees the tokens in order and one terminal
    event; a running request cancelled frees its slot and pages, its
    partial output a prefix of the oracle's; a finished one cannot be
    cancelled."""
    from mxnet_tpu_torch.serving import RequestCancelled
    jcfg, tcfg, tree = _setup()
    wl = _workload()
    _refs(tree, jcfg, [wl[1], (wl[2][0], 40)])
    cl = _cluster(tcfg, tree, replicas=1, metrics=True)
    try:
        p, n = wl[1]
        got = []
        rid = cl.submit(p, n)
        cl.attach_stream(rid, got.append)
        want = _ref(tree, jcfg, p, n)
        np.testing.assert_array_equal(cl.result(rid, timeout=TIMEOUT), want)
        toks = [t for kind, x in got if kind == "tokens" for t in x]
        assert toks == list(want[p.size:])
        assert got[-1][0] == "done" and sum(k == "done" for k, _ in got) == 1
        assert cl.cancel(rid) is False
        late = []
        cl.attach_stream(rid, late.append)
        assert late[0] == ("tokens", toks) and late[-1][0] == "done"

        pc, nc = wl[2][0], 40
        rc = cl.submit(pc, nc)
        deadline = time.perf_counter() + TIMEOUT
        while cl.requests[rc].state != "running" or \
                not cl.replicas[0].engine.requests.get(
                    cl.requests[rc].engine_rid, None) or \
                not cl.replicas[0].engine.requests[
                    cl.requests[rc].engine_rid].generated:
            assert time.perf_counter() < deadline
            time.sleep(0.001)
        status = cl.debug_status()
        assert status["kind"] == "inproc" and \
            [r["rid"] for r in status["requests"]] == [rc]
        assert cl.cancel(rc) is True
        with pytest.raises(RequestCancelled):
            cl.result(rc, timeout=TIMEOUT)
        part = cl.requests[rc].committed
        full = _ref(tree, jcfg, pc, nc)[pc.size:]
        assert 0 < len(part) < nc and list(full[:len(part)]) == part
        assert cl.metrics()["counters"]["cluster_cancelled_total"] == 1
        assert cl.drain(timeout=TIMEOUT)
        time.sleep(0.05)                       # the worker's sweep ran
        _live_no_leak(cl)
    finally:
        cl.close(timeout=60)


def test_cluster_validation_close_and_retention():
    from mxnet_tpu_torch.serving import ClusterClosed
    jcfg, tcfg, tree = _setup()
    with pytest.raises(ValueError):
        _cluster(tcfg, tree, replicas=0)
    with pytest.raises(NotImplementedError, match="kernel"):
        _cluster(tcfg, tree, replicas=1, kernel="xla")
    rng = np.random.RandomState(11)
    _refs(tree, jcfg, _workload()[1:7])
    cl = _cluster(tcfg, tree, replicas=1, retain_results=3)
    try:
        with pytest.raises(ValueError):
            cl.submit(rng.randint(1, 90, 60).astype(np.int32), 60)
        with pytest.raises(ValueError):
            cl.submit(np.ones(0, np.int32), 4)
        with pytest.raises(ValueError):
            cl.submit(np.ones(4, np.int32), 0)
        wl = _workload()[1:7]
        rids = [cl.submit(p, n) for p, n in wl]
        _check_exact(cl, rids, wl, tree, jcfg)
        assert all(r.thread.is_alive() for r in cl.replicas)
        assert set(cl.requests) == set(rids[-3:])
        assert cl.replicas[0].engine.requests == {}
        assert cl.metrics() == {"enabled": False} and cl.registry is None
    finally:
        cl.close(timeout=60)
    with pytest.raises(ClusterClosed):
        cl.submit(np.arange(1, 6, dtype=np.int32), 4)
    with pytest.raises(ClusterClosed):
        cl.add_replica()


def test_cluster_prefix_affinity_routing():
    """Requests sharing a prompt prefix stay on the replica that cached
    it while load allows (a wide slack isolates the affinity signal)."""
    jcfg, tcfg, tree = _setup()
    rng = np.random.RandomState(9)
    shared = rng.randint(1, 90, 8).astype(np.int32)
    cl = _cluster(tcfg, tree, replicas=2, num_slots=4, prefill_chunk=8,
                  metrics=True, affinity_slack=64)
    try:
        rids = [cl.submit(np.concatenate(
            [shared, rng.randint(1, 90, 2 + i).astype(np.int32)]), 4)
            for i in range(6)]
        assert cl.drain(timeout=TIMEOUT)
        assert len({cl.requests[r].replica for r in rids}) == 1
        c = cl.metrics()["counters"]
        assert c["cluster_routed_affinity_total"] >= len(rids) - 1
    finally:
        cl.close(timeout=60)


class _FakeReplica:
    def __init__(self, idx, rng):
        self.idx = idx
        self.alive = rng.rand() > 0.15
        self.draining = rng.rand() < 0.15
        self.waiting = int(rng.randint(0, 5))
        self.load = self.waiting + int(rng.randint(0, 3))


class _FakeRouter:
    """The state ``_route_locked`` reads, for either package's method."""

    def __init__(self, replicas, slack, cap):
        import collections
        self.replicas = replicas
        self.affinity_slack = slack
        self._affinity = collections.OrderedDict()
        self._affinity_cap = cap
        self._obs = None

    def _healthy(self):
        return [r for r in self.replicas if r.alive and not r.draining]


def test_router_choices_equal_the_reference_s():
    """Both packages' ``_route_locked`` over the same seeded replica
    states and prompts (shared prefixes, a small LRU) choose the same
    replica every time and keep the same affinity table."""
    from mxnet_tpu.serving.cluster import ServingCluster as RC
    from mxnet_tpu_torch.serving.cluster import ServingCluster as PC
    from mxnet_tpu_torch.serving.prefix_cache import chain_keys

    class _Req:
        def __init__(self, keys):
            self.affinity_keys = keys

    rng = np.random.RandomState(0)
    heads = [rng.randint(1, 90, 8).astype(np.int32) for _ in range(4)]
    routers = [_FakeRouter(None, 1, 6), _FakeRouter(None, 1, 6)]
    choices = [[], []]
    for step in range(300):
        st = np.random.RandomState(step)
        reps = [_FakeReplica(i, st) for i in range(3)]
        if not any(r.alive and not r.draining for r in reps):
            continue
        p = np.concatenate([heads[step % 4][:4 + step % 5],
                            st.randint(1, 90, 3).astype(np.int32)])
        keys = chain_keys(p, 4)
        for k, (cls, r) in enumerate(zip((RC, PC), routers)):
            r.replicas = reps
            choices[k].append(cls._route_locked(r, _Req(keys)).idx)
        assert list(routers[0]._affinity.items()) == \
            list(routers[1]._affinity.items())
    assert choices[0] == choices[1]
    assert len(set(choices[1])) == 3


def test_rid_start_gives_disjoint_blocks():
    from mxnet_tpu.serving import ServingEngine as RE
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.serving.cluster import RID_BLOCK
    import mxnet_tpu.serving.cluster as RCM
    jcfg, tcfg, tree = _setup()
    assert RID_BLOCK == RCM.RID_BLOCK
    p = np.arange(1, 6, dtype=np.int32)
    for start in (0, 5, 3 * RID_BLOCK):
        eng = ServingEngine(to_port(tree), tcfg, num_slots=1, page_size=4,
                            device="cpu", rid_start=start)
        ref = RE(tree, jcfg, num_slots=1, page_size=4, rid_start=start)
        assert [eng.submit(p, 2) for _ in range(2)] == \
            [ref.submit(p, 2) for _ in range(2)] == [start, start + 1]
    wl = _workload()
    _refs(tree, jcfg, wl)
    cl = _cluster(tcfg, tree, replicas=3)
    try:
        rids = [cl.submit(pr, n) for pr, n in wl]
        _check_exact(cl, rids, wl, tree, jcfg)
        added = cl.add_replica()
        assert added == 3
        eng = cl.replicas[added].engine
        assert eng._next_rid == 3 * RID_BLOCK + 1     # its warm-up's
        seen = {}
        for rep in cl.replicas:
            lo = rep.idx * RID_BLOCK
            assert lo <= rep.engine._next_rid < lo + RID_BLOCK
            seen[rep.idx] = rep.engine._next_rid - lo
        assert sum(seen.values()) >= len(wl)
    finally:
        cl.close(timeout=60)


def test_cluster_metric_names_types_and_help_equal_the_reference_s():
    from mxnet_tpu.obs import MetricsRegistry as RR
    from mxnet_tpu.serving.cluster import _ClusterObs as RObs
    from mxnet_tpu_torch.obs import MetricsRegistry as PR
    from mxnet_tpu_torch.serving.cluster import _ClusterObs as PObs
    seen = []
    for obs in (RObs(RR()), PObs(PR())):
        seen.append(sorted(
            (name, type(inst).__name__, getattr(inst, "help", ""))
            for name, inst in obs.registry._instruments.items()))
    assert seen[0] == seen[1]
    assert {n for n, _, _ in seen[1]} >= {
        "cluster_queue_depth", "cluster_in_flight",
        "cluster_replicas_healthy", "cluster_ttft_ms",
        "cluster_failovers_total", "cluster_scale_ups_total"}


def test_replicas_share_one_copy_of_the_weights():
    jcfg, tcfg, tree = _setup()
    cl = _cluster(tcfg, tree, replicas=2)
    try:
        cl.add_replica()
        ptrs = []
        for rep in cl.replicas:
            leaves = [rep.engine.params["tok_emb"],
                      rep.engine.params["layers"][0]["wqkv"],
                      rep.engine.params["layers"][-1]["w2"]]
            ptrs.append([t.data_ptr() for t in leaves])
        assert ptrs[0] == ptrs[1] == ptrs[2]
        pools = {rep.engine.cache.pools[0]["kv"].data_ptr()
                 for rep in cl.replicas}
        assert len(pools) == 3
    finally:
        cl.close(timeout=60)


# --- on the card ------------------------------------------------------------
@pytest.mark.cuda
def test_add_replica_captures_while_replicas_replay(cuda_device):
    """Two replicas serve a burst on the card; a third is added while
    they replay: its capture's window holds replays of the others, and
    every output equals the port's ``generate`` on the card, token for
    token.  The paged kernel's counter equals the steps x layers of
    every replica."""
    from mxnet_tpu_torch.kernels import paged_attention as PA
    from mxnet_tpu_torch.models import gpt as G
    from mxnet_tpu_torch.serving import ServingCluster
    from mxnet_tpu_torch.serving import engine as E
    dev = cuda_device
    cfg = G.gpt_tiny(dtype="float32", vocab_size=128, max_len=64,
                     d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    params = G.init_params(3, cfg, device=dev)
    rng = np.random.RandomState(0)
    wl = [(rng.randint(1, 90, 4 + i % 9).astype(np.int32), 40)
          for i in range(24)]
    want = [G.generate(params, cfg, p[None], n, device=dev)[0].cpu()
            .numpy() for p, n in wl]
    spans, replays = [], []

    class Timed(E.Program):
        def __init__(self, *a, **k):
            t0 = time.perf_counter()
            super().__init__(*a, **k)
            spans.append((threading.get_ident(), t0, time.perf_counter()))

        def __call__(self):
            replays.append((threading.get_ident(), time.perf_counter()))
            return super().__call__()

    orig = E.Program
    E.Program = Timed
    try:
        cl = ServingCluster(params, cfg, replicas=2, num_slots=4,
                            page_size=4, prefill_chunk=8, device=dev)
        try:
            PA.paged_attention.launches = 0
            base = [r.engine.stats["steps"] for r in cl.replicas]
            rids = [cl.submit(p, n) for p, n in wl]
            while sum(r.engine.stats["steps"] for r in cl.replicas) \
                    - sum(base) < 8:
                time.sleep(0.001)
            n_spans = len(spans)
            added = cl.add_replica()
            me, t0, t1 = spans[n_spans]
            during = [t for tid, t in replays if tid != me and t0 <= t <= t1]
            assert during, "no replica replayed during the capture"
            outs = [cl.result(r, timeout=TIMEOUT) for r in rids]
            steps = sum(r.engine.stats["steps"] for r in cl.replicas)
            for o, w in zip(outs, want):
                np.testing.assert_array_equal(o, w)
            # the added replica's warm-up step replays once too (its
            # engine's stats start after it)
            assert PA.paged_attention.launches == \
                (steps - sum(base) + 1) * cfg.n_layers
            assert added == 2
        finally:
            cl.close(timeout=60)
    finally:
        E.Program = orig
    for rep in cl.replicas:
        assert_no_leak(rep.engine)
