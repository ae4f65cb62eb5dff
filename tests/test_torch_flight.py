"""Port parity: the crash-durable flight recorder
(``mxnet_tpu_torch/obs/flight.py``) against the reference's, on the
CPU.  A ring written by either package is read by the other to the same
events; the two write the same bytes but for the clock; torn and
never-written slots are skipped alike; the ring wraps, truncates an
oversized payload, stays off at 0 slots, and is recovered by pid and
swept; ``MergedTraceEmitter.add_flight`` stages the same instant."""
import os
import struct

import pytest

from _torch_port import reference as R  # noqa: F401

import mxnet_tpu_torch.obs as PO
from mxnet_tpu_torch.obs import flight as PF


def _ref_flight():
    from mxnet_tpu.obs import flight
    return flight


EVENTS = [("send", {"rid": 3, "bytes": 4096, "peer": "decode-0"}),
          ("install", {"rid": 3, "pages": [1, 2, 5]}),
          ("step", {"n": 17, "rows": 24, "ok": True}),
          ("recv", {"rid": 4, "what": None, "ms": 0.25})]


def _write(mod, path_dir, pid, events, **kw):
    fr = mod.FlightRecorder(dir=str(path_dir), pid=pid, **kw)
    seqs = [fr.record(kind, **fields) for kind, fields in events]
    return fr, seqs


def _strip(evs):
    return [{k: v for k, v in e.items() if k != "t"} for e in evs]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_reads_the_other_s_ring(tmp_path, writer):
    RF = _ref_flight()
    w, r = (PF, RF) if writer == "port" else (RF, PF)
    fr, seqs = _write(w, tmp_path, 4242, EVENTS)
    assert seqs == [1, 2, 3, 4]
    path = w.flight_path(4242, str(tmp_path))
    assert path == r.flight_path(4242, str(tmp_path))
    got, want = r.read_flight(path), w.read_flight(path)
    assert got == want
    assert _strip(got) == [dict(fields, kind=kind, seq=i + 1)
                           for i, (kind, fields) in enumerate(EVENTS)]
    fr.close()


def test_the_two_rings_hold_the_same_bytes_but_the_clock(tmp_path):
    RF = _ref_flight()
    raw = []
    for i, mod in enumerate((PF, RF)):
        d = tmp_path / str(i)
        d.mkdir()
        fr, _ = _write(mod, d, 77, EVENTS, slots=8, slot_bytes=128)
        fr.close()
        b = bytearray(open(mod.flight_path(77, str(d)), "rb").read())
        for s in range(8):                  # zero each slot's clock
            off = 64 + s * 128 + 8
            b[off:off + 8] = bytes(8)
        raw.append(bytes(b))
    assert raw[0] == raw[1]
    assert PF.DEFAULT_SLOTS == RF.DEFAULT_SLOTS
    assert PF.DEFAULT_SLOT_BYTES == RF.DEFAULT_SLOT_BYTES


def test_torn_and_empty_slots_are_skipped_alike(tmp_path):
    RF = _ref_flight()
    fr, _ = _write(PF, tmp_path, 9, EVENTS, slots=8, slot_bytes=96)
    fr.close()
    path = PF.flight_path(9, str(tmp_path))
    b = bytearray(open(path, "rb").read())
    # slot 1: payload torn mid-write (not JSON); slot 2: payload length
    # past the slot; slot 3's head never written (seq 0)
    b[64 + 96 + 20:64 + 96 + 24] = b"\xff\xfe{]"
    struct.pack_into("<QdI", b, 64 + 2 * 96, 3, 1.0, 1000)
    struct.pack_into("<QdI", b, 64 + 3 * 96, 0, 0.0, 5)
    open(path, "wb").write(bytes(b))
    got = PF.read_flight(path)
    assert got == RF.read_flight(path)
    assert [e["seq"] for e in got] == [1]
    open(path, "wb").write(b"MXFL")           # shorter than a header
    assert PF.read_flight(path) == RF.read_flight(path) == []


def test_wraparound_truncation_and_the_disabled_recorder(tmp_path):
    RF = _ref_flight()
    long = {"blob": "x" * 500}
    outs = []
    for i, mod in enumerate((PF, RF)):
        d = tmp_path / str(i)
        d.mkdir()
        fr = mod.FlightRecorder(slots=4, slot_bytes=64, dir=str(d), pid=5)
        for n in range(9):
            fr.record("tick", n=n)
        fr.record("big", **long)
        outs.append((_strip(mod.read_flight(fr.path)), fr.dropped))
        fr.close(unlink=True)
        assert not os.path.exists(mod.flight_path(5, str(d)))
        off = mod.FlightRecorder(slots=0, dir=str(d), pid=6)
        assert not off.enabled and off.record("x") is None
        assert not os.path.exists(mod.flight_path(6, str(d)))
    assert outs[0] == outs[1]
    evs, dropped = outs[0]
    assert [e["seq"] for e in evs] == [7, 8, 9, 10] and dropped == 1
    assert evs[-1]["kind"] == "big" and "trunc" in evs[-1]


def test_recover_and_sweep(tmp_path, monkeypatch):
    RF = _ref_flight()
    monkeypatch.setenv("MXNET_SERVE_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_SERVE_FLIGHT_SLOTS", "16")
    for pid in (101, 102, 103):
        fr = PF.FlightRecorder(pid=pid)
        fr.record("hello", pid=pid)
        fr.close()
    got = PF.flight_recover(101)
    assert _strip(got) == _strip(RF.flight_recover(101))
    assert _strip(got) == [{"kind": "hello", "pid": 101, "seq": 1}]
    assert PF.flight_recover(101, unlink=True) is not None
    assert PF.flight_recover(101) is None and RF.flight_recover(101) is None
    assert PF.flight_sweep(102) == 1 and PF.flight_sweep(102) == 0
    assert RF.flight_sweep(103) == 1
    for pid in (7, 8):
        PF.FlightRecorder(pid=pid).close()
    assert PF.flight_sweep("*") == 2
    assert not os.listdir(tmp_path)


def test_add_flight_stages_the_reference_s_instant():
    from mxnet_tpu.obs import MergedTraceEmitter as RM
    ev = {"kind": "install", "rid": 3, "seq": 12, "t": 5.5, "pages": 2}
    staged = []
    for cls in (PO.MergedTraceEmitter, RM):
        m = cls()
        m.add_flight("decode-0", dict(ev), offset_s=0.5)
        staged.append(m._pending)
    assert staged[0] == staged[1]
    (e,) = staged[0]
    assert e["name"] == "flight:install" and e["cat"] == "flight"
    assert e["args"] == {"pages": 2, "seq": 12}
