"""Port parity: ``mxnet_tpu_torch/profiler.py`` and ``engine.py``
against ``mxnet_tpu/profiler.py`` and ``engine.py`` on the CPU.

The same ``nd`` op sequence runs under ``set_state('run')`` in both
packages: the operator events come in the same (name, category)
order, the aggregate table has the same rows with the same call
counts, and with ``profile_memory`` the live/peak bytes and allocation
counts are equal (f32 arrays of the same shapes).  Times are the host
clock's and differ: they are not compared.  Pause/resume, the user
scopes and counters, ``NaiveEngine`` (``push`` waits for the stream)
and ``nd.waitall`` / ``wait_to_read`` are covered too; ``xla_profile``
starts a ``torch.profiler`` session whose chrome trace lands under
``xla_trace_dir``."""
import gc
import json
import os

import numpy as np
import pytest

import mxnet_tpu as rmx
import mxnet_tpu.profiler as RP
import mxnet_tpu_torch as pmx
import mxnet_tpu_torch.profiler as PP
from mxnet_tpu_torch import engine as PE


def _ops(mx, ctx):
    """One op sequence, the same in both packages."""
    kw = {} if ctx is None else {"ctx": ctx}
    a = mx.nd.ones((16, 16), **kw)
    b = mx.nd.dot(a, a)
    c = mx.nd.softmax(b * 0.01)
    d = mx.nd.Activation(mx.nd.square(c) + a, act_type="relu")
    e = mx.nd.sum(d, axis=1)
    e.wait_to_read()
    return a, b, c, d, e


def _run(mx, P, ctx, path, memory=False):
    P.set_config(filename=str(path), aggregate_stats=True,
                 profile_memory=memory)
    P.set_state("run")
    try:
        arrays = _ops(mx, ctx)
        mem = P.memory_stats() if memory else None
    finally:
        P.set_state("stop")
    with open(P.dump(filename=str(path))) as f:
        events = json.load(f)["traceEvents"]
    table = P.dumps(reset=True)
    P.set_config(profile_memory=False, aggregate_stats=False)
    return arrays, events, table, mem


def _rows(table):
    """(name, calls) of the aggregate table's op rows, sorted by name
    (the table orders them by total time)."""
    out = []
    for line in table.splitlines()[2:]:
        if not line.strip():
            break
        f = line.split()
        out.append((f[0], int(f[1])))
    return sorted(out)


@pytest.mark.parametrize("memory", [False, True], ids=["plain", "memory"])
def test_op_events_and_table_equal(tmp_path, memory):
    _, rev, rtab, rmem = _run(rmx, RP, None, tmp_path / "r.json", memory)
    _, pev, ptab, pmem = _run(pmx, PP, pmx.cpu(), tmp_path / "p.json",
                              memory)
    ops = [(e["name"], e["cat"]) for e in rev if e.get("cat") == "operator"]
    assert ops and ops == [(e["name"], e["cat"]) for e in pev
                           if e.get("cat") == "operator"]
    assert _rows(ptab) == _rows(rtab)
    assert ("Memory Statistics" in ptab) == ("Memory Statistics" in rtab) \
        == memory
    if memory:
        for k in ("ndarray_live_bytes", "ndarray_peak_bytes",
                  "ndarray_allocs"):
            assert pmem[k] == rmem[k], k
        assert pmem["devices"] == {}          # no CUDA device here
        live = [e["args"]["bytes"] for e in pev
                if e.get("ph") == "C" and e["name"] == "ndarray_live_bytes"]
        assert live == [e["args"]["bytes"] for e in rev
                        if e.get("ph") == "C"
                        and e["name"] == "ndarray_live_bytes"]


def test_memory_hook_only_while_profiling_and_frees_counted(tmp_path):
    from mxnet_tpu_torch.ndarray import ndarray as ndmod
    assert ndmod._MEM_HOOK is None
    PP.set_config(filename=str(tmp_path / "m.json"), profile_memory=True)
    PP.set_state("run")
    try:
        assert ndmod._MEM_HOOK is not None
        a = pmx.nd.ones((64, 64), ctx=pmx.cpu())
        b = pmx.nd.dot(a, a)
        before = PP.memory_stats()["ndarray_live_bytes"]
        assert before >= 2 * 64 * 64 * 4
        del a, b
        gc.collect()
        assert PP.memory_stats()["ndarray_live_bytes"] < before
    finally:
        PP.set_state("stop")
        PP.set_config(profile_memory=False)
        PP.dump(filename=str(tmp_path / "m.json"))
    assert ndmod._MEM_HOOK is None


def test_pause_resume_scopes_counters(tmp_path):
    got = []
    for mx, P, kw in ((rmx, RP, {}), (pmx, PP, {"ctx": pmx.cpu()})):
        P.set_config(filename=str(tmp_path / "s.json"))
        P.set_state("run")
        P.pause()
        assert not P.is_recording()
        mx.nd.square(mx.nd.ones((4,), **kw))
        P.resume()
        mx.nd.negative(mx.nd.ones((4,), **kw))
        with P.Task("data_loading"):
            pass
        with P.Frame("frame"):
            pass
        ev = P.Event("event").start()
        ev.stop()
        c = P.Counter("samples", 0)
        c.increment(64)
        c.decrement(4)
        P.Marker("epoch_end").mark()
        P.set_state("stop")
        with open(P.dump()) as f:
            evs = json.load(f)["traceEvents"]
        got.append([(e["name"], e.get("cat"), e["ph"], e.get("args"))
                    for e in evs])
    assert got[0] == got[1]
    names = [g[0] for g in got[1]]
    assert "negative" in names and "square" not in names


def test_record_events_generation_and_state():
    assert PP.state() == "stop" and not PP.is_recording()
    assert PP.record_events([{"name": "x"}]) is False
    g = PP.events_generation()
    PP.set_state("run")
    try:
        assert PP.record_events([{"name": "x", "ph": "i", "ts": 0.0}])
    finally:
        PP.set_state("stop")
    PP.dump()
    assert PP.events_generation() == g + 1
    assert abs(PP.now_us() - RP.now_us()) < 1e6
    with pytest.raises(pmx.MXNetError):
        PP.set_config(no_such_key=1)
    with pytest.raises(pmx.MXNetError):
        PP.set_state("go")


def test_naive_engine_and_waitall(monkeypatch):
    """NaiveEngine routes every op through push (the hook sees it) and
    waits for its stream; waitall and wait_to_read run; bulk restores
    the knob."""
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    naive = PE.Engine()
    assert naive.synchronous and naive.engine_type == "NaiveEngine"
    monkeypatch.setattr(PE.Engine, "_instance", naive)
    seen = []
    naive.add_op_hook(lambda ev, name: seen.append((ev, name)))
    x = pmx.nd.ones((3,), ctx=pmx.cpu())
    y = pmx.nd.square(x * 3.0)
    assert seen == [("start", "_mul_scalar"), ("stop", "_mul_scalar"),
                    ("start", "square"), ("stop", "square")]
    np.testing.assert_array_equal(y.wait_to_read().asnumpy(), 9.0)
    pmx.nd.waitall()
    naive.wait_for_all()
    PE.Engine.wait_for_var([y._data, {"k": x._data}])
    assert PE.set_bulk_size(4) == 15
    with PE.bulk(30):
        assert naive._bulk_size == 30
    assert naive._bulk_size == 4
    monkeypatch.delenv("MXNET_ENGINE_TYPE")
    assert PE.Engine().synchronous is False


def test_device_trace_session(tmp_path):
    """xla_profile=True: a torch.profiler session beside the op hook,
    its chrome trace written under xla_trace_dir at stop."""
    d = tmp_path / "trace"
    PP.set_config(xla_profile=True, xla_trace_dir=str(d),
                  filename=str(tmp_path / "x.json"))
    try:
        PP.set_state("run")
        pmx.nd.square(pmx.nd.ones((8,), ctx=pmx.cpu())).wait_to_read()
        PP.set_state("stop")
    finally:
        PP.set_config(xla_profile=False)
        PP.dump()
    files = os.listdir(d)
    assert len(files) == 1
    with open(d / files[0]) as f:
        assert json.load(f)["traceEvents"]
