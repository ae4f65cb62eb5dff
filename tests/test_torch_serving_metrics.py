"""Port parity: the serving engine's telemetry (``metrics=True``, the
``obs/`` layer) against the reference engine's, on the CPU at the tiny
config of tests/test_serving.py.

One scripted workload runs through both engines (the same requests, a
preempting pool, the prefix cache, ``spec_K``, a cancel at a fixed
step; overlap on a second workload with no call from outside the
step loop, which would race the planner) with each package's profiler
recording.  Exact, as both schedules are the same: every counter and
gauge of ``metrics()``, every histogram's count (the histograms'
values are host times), each request's lifecycle trace events in the
same (name, ph) order, the tokens.  Then ``MXNET_SERVING_METRICS``,
the ``registry=`` rules, ``reset_metrics()`` and the disabled path,
where no instrument exists."""
import json

import numpy as np
import pytest

import mxnet_tpu.profiler as RP
import mxnet_tpu_torch.obs as PO
import mxnet_tpu_torch.profiler as PP
from _torch_port import (assert_no_leak, configs, numpy_params,
                         port_engine, ref_engine, ref_generate)
from mxnet_tpu_torch.obs import REQ_TID_BASE


def _cases(seed):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 90, 12).astype(np.int32)
    cases = [(np.concatenate([shared, rng.randint(1, 90, 2 + i)
                              .astype(np.int32)]), 6 + i) for i in range(4)]
    cases += [(rng.randint(1, 90, P).astype(np.int32), N)
              for P, N in [(5, 8), (9, 4), (3, 10)]]
    cases.append((shared, 5))           # whole-input match: copy on write
    return cases


def _drive(make, tree, cfg, cases, kw, cancel_at=None, tmp=None, P=None):
    """Run ``cases`` through one engine with the profiler ``P``
    recording; with ``cancel_at`` = (step, index) cancel that request
    after that many steps.  Returns (engine, rids, trace events)."""
    P.set_config(filename=str(tmp))
    P.set_state("run")
    try:
        eng = make(tree, cfg, metrics=True, **kw)
        rids = [eng.submit(p, n, trace_id="t%d" % i if i % 2 else None)
                for i, (p, n) in enumerate(cases)]
        steps = 0
        while eng.step() is not False:
            steps += 1
            if cancel_at is not None and steps == cancel_at[0]:
                eng.cancel(rids[cancel_at[1]])
        eng.close()
    finally:
        P.set_state("stop")
    with open(P.dump(filename=str(tmp))) as f:
        events = json.load(f)["traceEvents"]
    return eng, rids, events


def _lanes(events):
    """{rid: [(name, ph), ...]} of the request lanes; the serving_step
    operator events' count."""
    lanes = {}
    for e in events:
        if e.get("tid", 0) >= REQ_TID_BASE:
            lanes.setdefault(e["tid"] - REQ_TID_BASE, []).append(
                (e["name"], e["ph"]))
    steps = sum(e["name"] == "serving_step" and e.get("cat") == "operator"
                for e in events)
    return lanes, steps


def _assert_same_metrics(ref, eng):
    a, b = ref.metrics(), eng.metrics()
    assert b["enabled"] and a["enabled"]
    assert b["counters"] == a["counters"]
    assert b["gauges"] == a["gauges"]
    assert {k: v["count"] for k, v in b["histograms"].items()} == \
        {k: v["count"] for k, v in a["histograms"].items()}


RUNS = {
    "serial, preempting pool, prefix cache, spec_K=2, cancel": (
        dict(num_slots=3, page_size=4, prefill_chunk=6, num_pages=14,
             pages_per_slot=8, prefix_cache=True, spec_K=2), (6, 5)),
    "overlap, preempting pool, prefix cache": (
        dict(num_slots=3, page_size=4, prefill_chunk=6, num_pages=14,
             pages_per_slot=8, prefix_cache=True, overlap=True), None),
    "overlap, spec_K=2 (fences)": (
        dict(num_slots=2, page_size=4, prefill_chunk=8, spec_K=2,
             overlap=True), None),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_metrics_and_lifecycle_equal_reference(name, tmp_path):
    kw, cancel_at = RUNS[name]
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 3)
    cases = _cases(0)
    ref, rids, rev = _drive(ref_engine, tree, jcfg, cases, kw, cancel_at,
                            tmp_path / "r.json", RP)
    eng, prids, pev = _drive(port_engine, tree, tcfg, cases, kw, cancel_at,
                             tmp_path / "p.json", PP)
    assert rids == prids
    for rid in rids:
        a, b = ref.requests[rid], eng.requests[rid]
        assert (a.state, list(a.generated)) == (b.state, list(b.generated))
        assert len(b.token_times) == len(b.generated)
        assert b.submit_t <= b.wait_start
    _assert_same_metrics(ref, eng)
    rl, rsteps = _lanes(rev)
    pl, psteps = _lanes(pev)
    assert pl == rl and psteps == rsteps > 0
    c = eng.metrics()["counters"]
    assert c["serving_steps_total"] == eng.stats["steps"]
    assert c["serving_tokens_total"] == sum(
        len(eng.requests[r].generated) for r in rids)
    assert eng.metrics()["histograms"]["serving_ttft_ms"]["count"] == \
        len(rids) - (cancel_at is not None
                     and not eng.requests[rids[cancel_at[1]]].generated)
    names = {n for seq in pl.values() for n, _ in seq}
    assert {"admission_wait", "decode", "retire", "first_token"} <= names
    assert any(n.startswith("prefill[") for n in names)
    if cancel_at is not None:
        assert "preempt" in names and "resume" in names
        assert "spec_verify" in names
        assert eng.requests[rids[cancel_at[1]]].state == "cancelled"
    for rid in rids:
        if eng.requests[rid].state == "done":
            assert pl[rid][0] == ("thread_name", "M")
    assert_no_leak(eng)
    # the engine registry renders on the process scrape with its label
    text = PO.prometheus_text()
    assert 'serving_steps_total{engine="%s"} %d' % (
        eng.registry.labels["engine"], eng.stats["steps"]) in text


def test_generate_parity_with_metrics_on():
    """Telemetry changes nothing the engine computes."""
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 5)
    cases = _cases(1)[:5]
    eng = port_engine(tree, tcfg, num_slots=2, page_size=4, prefill_chunk=6,
                      num_pages=10, pages_per_slot=8, metrics=True)
    rids = [eng.submit(p, n) for p, n in cases]
    outs = eng.run()
    for rid, (p, n) in zip(rids, cases):
        np.testing.assert_array_equal(outs[rid],
                                      ref_generate(tree, jcfg, p, n))
    assert eng.metrics()["counters"]["serving_preemptions_total"] == \
        eng.stats["preemptions"] > 0


def test_env_registry_rules_and_disabled_path(monkeypatch):
    jcfg, tcfg = configs()
    tree = numpy_params(jcfg, 3)
    kw = dict(num_slots=2, page_size=4)
    before = len(PO.engine_registries())
    eng = port_engine(tree, tcfg, **kw)
    assert eng._obs is None and not eng.metrics_enabled
    assert eng.registry is None and eng.metrics() == {"enabled": False}
    eng.reset_metrics()
    eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    eng.run()
    assert len(PO.engine_registries()) == before
    monkeypatch.setenv("MXNET_SERVING_METRICS", "1")
    on = port_engine(tree, tcfg, **kw)
    assert on.metrics_enabled and on.registry in PO.engine_registries()
    monkeypatch.setenv("MXNET_SERVING_METRICS", "0")
    assert not port_engine(tree, tcfg, **kw).metrics_enabled
    mine = PO.MetricsRegistry(labels={"engine": "mine"})
    given = port_engine(tree, tcfg, registry=mine, **kw)
    assert given.metrics_enabled and given.registry is mine
    assert mine not in PO.engine_registries()      # caller-scoped
    with pytest.raises(ValueError, match="registry"):
        port_engine(tree, tcfg, registry=mine, metrics=False, **kw)
    # reset_metrics zeroes values in place: a later run counts from 0
    rid = given.submit(np.arange(1, 6, dtype=np.int32), 3)
    given.run()
    assert mine.counter("serving_tokens_total").value == 3
    given.reset_metrics()
    snap = given.metrics()
    assert not any(snap["counters"].values())
    assert given.requests[rid].state == "done"
    given.submit(np.arange(1, 9, dtype=np.int32), 2)
    given.run()
    c = given.metrics()["counters"]
    assert c["serving_tokens_total"] == 2
    assert c["serving_page_alloc_calls_total"] == \
        given.cache.alloc_calls > 0
