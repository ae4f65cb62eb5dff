"""Port parity: ``mxnet_tpu_torch/obs`` (metrics registry, Prometheus
exposition, request trace emitters) against ``mxnet_tpu/obs``, driven
by the same sequences of calls on the CPU.

Host-only code on both sides, so every comparison is exact: registry
snapshots (histogram percentiles included) equal as Python values,
Prometheus bodies equal line for line (the native collectors off: each
package's native library counts its own work; with them on, the same
native families follow the registries), trace events equal dict for dict
(timestamps are the values the test passes in)."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu.obs as RO
import mxnet_tpu.profiler as RP
import mxnet_tpu_torch.obs as PO
import mxnet_tpu_torch.profiler as PP


def _drive(O, seed):
    """One sequence of instrument calls on a fresh registry of package
    ``O``: counters, gauges (set/inc/dec), histograms with default and
    custom bounds (overflow included), a reset_values, more samples."""
    rng = np.random.RandomState(seed)
    reg = O.MetricsRegistry(labels={"engine": "7", "zone": 'a"b'})
    c = reg.counter("requests_total", "requests seen")
    g = reg.gauge("queue_depth", "queued")
    h = reg.histogram("latency_ms", help="latency")
    hc = reg.histogram("tiny_ms", bounds=(0.5, 1.0, 4.0), help="")
    for v in rng.exponential(20.0, 200):
        h.observe(float(v))
        hc.observe(float(v) / 10.0)
    c.inc()
    c.inc(5)
    g.set(3)
    g.inc(2)
    g.dec()
    assert reg.counter("requests_total") is c       # get-or-create
    reg.reset_values()
    for v in (0.05, 0.3, 7.0, 99999.0):
        h.observe(v)
    c.inc(2)
    g.set(1.5)
    reg.counter(O.sanitize_name("9 bad-name.x"), "sanitized")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_equal(seed):
    """The same calls give equal snapshots (percentiles included) and
    the same Prometheus text."""
    ref, port = _drive(RO, seed), _drive(PO, seed)
    assert port.snapshot() == ref.snapshot()
    for q in (0, 1, 50, 90, 95, 99, 100):
        for name in ("latency_ms", "tiny_ms"):
            assert port.histogram(name).percentile(q) == \
                ref.histogram(name).percentile(q)
    assert PO.prometheus_text([port], include_native=False) == \
        RO.prometheus_text([ref], include_native=False)
    full, bare = PO.prometheus_text([port]), RO.prometheus_text([ref])
    assert full.startswith(PO.prometheus_text([port], include_native=False))
    assert [ln for ln in full.splitlines() if ln.startswith("# TYPE")] == \
        [ln for ln in bare.splitlines() if ln.startswith("# TYPE")]


def test_prometheus_families_across_registries_and_kind_conflict():
    """Two registries sharing a family render under one header; a kind
    conflict is reported as the reference reports it."""
    out = []
    for O in (RO, PO):
        a = O.MetricsRegistry(labels={"engine": "0"})
        b = O.MetricsRegistry(labels={"engine": "1"})
        a.counter("steps_total", "steps").inc(3)
        b.counter("steps_total", "steps").inc(4)
        b.gauge("clash").set(1)
        a.counter("clash").inc()
        out.append(O.prometheus_text([a, b], include_native=False))
    assert out[0] == out[1]
    assert out[1].count("# TYPE steps_total counter") == 1
    assert "# skipped clash" in out[1]


def test_registry_type_mismatch_and_bad_bounds():
    for O in (RO, PO):
        reg = O.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            O.Histogram("h", bounds=(2.0, 1.0))
    assert PO.DEFAULT_MS_BUCKETS == RO.DEFAULT_MS_BUCKETS
    for name in ("a.b-c", "9x", "", "ok_name:1"):
        assert PO.sanitize_name(name) == RO.sanitize_name(name)


def test_default_and_engine_registries():
    """register_engine_registry is weak and the default registry is a
    process singleton, in the port as in the reference."""
    import gc
    reg = PO.MetricsRegistry(labels={"engine": "x"})
    PO.register_engine_registry(reg)
    assert reg in PO.engine_registries()
    assert PO.default_registry() is PO.default_registry()
    del reg
    gc.collect()
    assert all(r.labels.get("engine") != "x"
               for r in PO.engine_registries())


@pytest.fixture
def recording(tmp_path):
    """Both profilers recording, with their event streams cleared before
    and after."""
    for P in (RP, PP):
        P.set_state("stop")
        P.dump(filename=str(tmp_path / "drop.json"))
        P.set_state("run")
    yield tmp_path
    for P in (RP, PP):
        P.set_state("stop")
        P.dump(filename=str(tmp_path / "drop.json"))


def _events(P, path):
    P.dump(finished=True, filename=str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _emit(O, rid_base):
    em = O.RequestTraceEmitter()
    em.add_span(rid_base, "admission_wait", 1.0, 1.5)
    em.add_span(rid_base + 1, "prefill[0:6)", 1.5, 1.75, args={"rows": 6})
    em.add_instant(rid_base, "first_token", 1.75,
                   args={"trace_id": "abc"})
    ok = em.flush()
    em.add_span(rid_base, "decode", 2.0, 2.25)
    ok2 = em.flush()
    return em, ok, ok2


def test_request_trace_emitter_equal(recording):
    """Same spans through both emitters: the same events (lane metadata
    once per trace, re-emitted after a dump, nothing emitted while the
    profiler is stopped)."""
    got = []
    for O, P in ((RO, RP), (PO, PP)):
        em, ok, ok2 = _emit(O, 3)
        assert ok and ok2 and not em.flush()
        first = _events(P, recording / "a.json")
        em.add_instant(3, "retire", 3.0)      # a new trace: names again
        em.flush()
        second = _events(P, recording / "b.json")
        P.set_state("stop")
        em.add_instant(3, "retire", 4.0)
        assert em.flush() is False            # not recording: dropped
        P.set_state("run")
        got.append((first, second))
    assert got[0] == got[1]
    first, second = got[1]
    lanes = [e for e in first if e["ph"] == "M"]
    assert [e["args"]["name"] for e in lanes] == ["req 3", "req 4"]
    assert [e["tid"] for e in lanes] == \
        [PO.REQ_TID_BASE + 3, PO.REQ_TID_BASE + 4]
    assert [e["name"] for e in second] == ["thread_name", "retire"]


def test_span_buffer_equal():
    """Cap, drop count, wire shape and drain, as the reference's."""
    out = []
    for O in (RO, PO):
        buf = O.SpanBuffer(cap=3)
        buf.span(1, "decode", 0.5, 0.75, trace_id="t1")
        buf.instant(2, "retire", 1.0, args={"tokens": 4})
        buf.span(3, "prefill[0:4)", 1.0, 1.25, cat="serving")
        buf.span(4, "over", 2.0, 2.5)
        out.append((buf.drain(), buf.dropped, buf.drain()))
        off = O.SpanBuffer(cap=0)
        off.span(1, "x", 0.0, 1.0)
        assert not off.enabled and off.drain() == []
    assert out[0] == out[1]
    old = os.environ.get("MXNET_SERVE_SPANS")
    os.environ["MXNET_SERVE_SPANS"] = "5"
    try:
        assert PO.SpanBuffer().cap == RO.SpanBuffer().cap == 5
    finally:
        if old is None:
            del os.environ["MXNET_SERVE_SPANS"]
        else:
            os.environ["MXNET_SERVE_SPANS"] = old


def test_merged_trace_emitter_equal(recording):
    """Lanes become synthetic processes, clocks are corrected by the
    offset, malformed spans are dropped: the same events as the
    reference's."""
    got = []
    for O, P in ((RO, RP), (PO, PP)):
        m = O.MergedTraceEmitter()
        m.add("worker-0", {"rid": 1, "name": "decode", "ph": "X",
                           "t0": 2.0, "t1": 2.5, "trace_id": "q"},
              offset_s=0.25)
        m.add("transport", {"rid": 2, "name": "kv", "ph": "i", "t": 3.0,
                            "cat": "transfer"})
        m.add("worker-0", {"rid": "bad", "name": "x", "ph": "X"})
        assert m.flush()
        got.append(_events(P, recording / "m.json"))
    assert got[0] == got[1]
    assert {e["args"]["name"] for e in got[1]
            if e["name"] == "process_name"} == {"worker-0", "transport"}
