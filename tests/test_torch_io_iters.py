"""The rest of the port's ``io`` and ``native.py`` against the
reference's, on the CPU, from the same inputs.

* ``CSVIter``, ``LibSVMIter`` (CSR batches), ``PrefetchingIter`` and
  ``DevicePrefetchIter(ctx=cpu)`` over ``NDArrayIter``: the same batches
  (copies and stacks: exact), the same padding, the same end of epoch
  and the same partial-superbatch drop; ``reset`` and ``close``; a
  prefetch thread's launches stay out of a capture's counter window.
* The registry: ``list_iters``, ``MXDataIter`` and ``register_iter``;
  ``MXDataIter("ImageRecordIter")`` is ``image``'s ``ImageIter`` behind a
  ``PrefetchingIter`` in both packages.
* ``ImageRecordIter`` with a CPU context on both routes (the native
  loader and the Python loop, chosen by ``native.available()``), bit for
  bit against the reference's same route with random crops and flips
  off, and the Python route with them on (one ``RandomState`` in both).
* ``native.py``: records written by one package's native writer read by
  the other's, the dependency engine's ordering, versions and deferred
  errors, the storage pool's statistics and ``Shm`` segments, against
  the reference's library.
"""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as P
from _torch_port import reference as R


def _ref_native():
    from mxnet_tpu import native
    return native


def _batches(it, cpu=True):
    out = []
    with P.cpu():
        for b in it:
            out.append(([d.asnumpy() if hasattr(d, "asnumpy") else d
                         for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        for x, y in zip(da + la, db + lb):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
        assert pa == pb


# --- CSV and LibSVM --------------------------------------------------------
@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_equals_reference(tmp_path, round_batch):
    rng = np.random.RandomState(0)
    data, label = rng.rand(10, 6).astype(np.float32), rng.rand(10, 1)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4,
              round_batch=round_batch)
    with P.cpu():
        port = P.io.CSVIter(**kw)
        got = _batches(port)
    want = _batches(R.io.CSVIter(**kw))
    _same(want, got)
    assert port.provide_data[0].shape == (4, 2, 3)
    kw.pop("label_csv")
    with P.cpu():
        got = _batches(P.io.CSVIter(**kw))
    _same(_batches(R.io.CSVIter(**kw)), got)


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter_yields_csr_batches(tmp_path, round_batch):
    lines = ["1 0:1.5 3:2.0", "0 1:0.5", "1 2:3.0 4:1.0 5:2.5", "0",
             "1 5:4.0"]
    (tmp_path / "d.svm").write_text("\n".join(lines) + "\n")
    (tmp_path / "l.txt").write_text("1\n2\n3\n4\n5\n")
    for extra in ({}, {"label_libsvm": str(tmp_path / "l.txt"),
                       "label_shape": (1,)}):
        kw = dict(data_libsvm=str(tmp_path / "d.svm"), data_shape=(6,),
                  batch_size=2, round_batch=round_batch, **extra)
        with P.cpu():
            port = P.io.LibSVMIter(**kw)
            got = []
            for b in port:
                assert b.data[0].stype == "csr"
                got.append(([b.data[0].asnumpy()],
                             [b.label[0].asnumpy()], b.pad))
        want = [([b.data[0].asnumpy()], [b.label[0].asnumpy()], b.pad)
                for b in R.io.LibSVMIter(**kw)]
        _same(want, got)
        assert port.provide_data[0].shape == (2, 6)
        port.reset()
        with P.cpu():
            assert port.next().data[0].shape == (2, 6)


# --- prefetching -----------------------------------------------------------
def _ndarray_iter(mod, n=10, bs=3, last="pad"):
    rng = np.random.RandomState(1)
    data = rng.rand(n, 2, 4).astype(np.float32)
    label = np.arange(n, dtype=np.float32)
    return mod.io.NDArrayIter(data, label, batch_size=bs,
                              last_batch_handle=last)


def test_prefetching_iter_equals_reference():
    with P.cpu():
        port = P.io.PrefetchingIter(_ndarray_iter(P))
        got = _batches(port)
        assert port.provide_data[0].shape == (3, 2, 4)
        port.reset()
        again = _batches(port)
    want = _batches(R.io.PrefetchingIter(_ndarray_iter(R)))
    _same(want, got)
    _same(want, again)
    with P.cpu():
        renamed = P.io.PrefetchingIter([_ndarray_iter(P)],
                                       rename_data=[{"data": "x"}])
    assert renamed.provide_data[0].name == "x"


@pytest.mark.parametrize("S", [1, 2, 3])
def test_device_prefetch_iter_on_the_cpu(S):
    """Superbatches of S stacked batches on the CPU context: the
    reference's values, pads and count (a partial superbatch dropped);
    reset starts a new epoch; close stops the worker."""
    with P.cpu():
        port = P.io.DevicePrefetchIter(_ndarray_iter(P), super_size=S,
                                       ctx=P.cpu())
        got = _batches(port)
        assert port.provide_data[0].shape == (S, 3, 2, 4)
        port.reset()
        again = _batches(port)
        port.close()
    ref = R.io.DevicePrefetchIter(_ndarray_iter(R), super_size=S,
                                  ctx=R.cpu())
    want = _batches(ref)
    ref.close()
    assert len(got) == 4 // S
    _same(want, got)
    _same(want, again)
    for d, _, _ in got:
        assert d[0].shape == (S, 3, 2, 4)
    assert not port._st.thread.is_alive()
    with pytest.raises(P.MXNetError):
        P.io.DevicePrefetchIter(_ndarray_iter(P), super_size=0)


def test_device_prefetch_iter_reports_a_failing_base():
    class Boom(P.io.DataIter):
        provide_data, provide_label = [], []

        def next(self):
            raise ValueError("boom")

    with P.cpu():
        it = P.io.DevicePrefetchIter(Boom(2), super_size=2)
    with pytest.raises(P.MXNetError, match="boom"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_counter_window_excludes_a_prefetch_threads_launches():
    """A thread that launches under ``CAPTURE_LOCK`` (the card
    ``DevicePrefetchIter``'s worker) moves no launch counter inside a
    recorded window (a capture's, a warm-up's): its launch is neither in
    the window's change, which each replay of a captured graph adds
    again, nor undone when the window puts the counters back."""
    import threading
    import time
    from mxnet_tpu_torch import _graphs
    from mxnet_tpu_torch.kernels import image_aug as IA
    started = threading.Event()

    def worker():
        started.set()
        with _graphs.CAPTURE_LOCK:
            IA.image_aug.launches += 1

    def window():
        t.start()
        started.wait()
        time.sleep(0.05)            # the worker now waits for the lock
        IA.image_aug.launches += 2  # the window's own launches

    n0 = IA.image_aug.launches
    t = threading.Thread(target=worker)
    try:
        _, counts = _graphs.recorded_launches(window)
        t.join()
        assert counts.changes == [(IA.image_aug, "launches", 2)]
        assert IA.image_aug.launches == n0 + 1
        counts.add()
        assert IA.image_aug.launches == n0 + 3
    finally:
        IA.image_aug.launches = n0


# --- the registry ----------------------------------------------------------
def test_registry_equals_reference(tmp_path):
    assert P.io.list_iters() == R.io.list_iters()
    assert "imagerecorditer" in P.io.list_iters()

    @P.io.register_iter("TestSeqIter")
    class Seq(P.io.NDArrayIter):
        pass

    it = P.io.MXDataIter("TestSeqIter", data=np.ones((4, 2), np.float32),
                         batch_size=2)
    assert isinstance(it, Seq)
    np.savetxt(tmp_path / "d.csv", np.ones((4, 3)), delimiter=",")
    it = P.io.MXDataIter("CSVIter", data_csv=str(tmp_path / "d.csv"),
                         data_shape=(3,), batch_size=2)
    assert isinstance(it, P.io.CSVIter)
    with pytest.raises(P.MXNetError):
        P.io.MXDataIter("NoSuchIter")


def _img(seed, h, w):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx * f + yy * g) for f, g in
                    rng.uniform(0.05, 0.4, (3, 2))], -1)
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def _rec(path, n=7, fmt=".jpg"):
    rec, idx = path + ".rec", path + ".idx"
    w = R.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        w.write_idx(i, R.recordio.pack_img(
            R.recordio.IRHeader(0, float(i), i, 0),
            _img(i, 30 + i, 40 - i)[:, :, ::-1], quality=95, img_fmt=fmt))
    w.close()
    return rec, idx


def test_registry_image_record_iter_is_image_iter(tmp_path):
    rec, idx = _rec(str(tmp_path / "a"))
    kw = dict(batch_size=3, data_shape=(3, 24, 24), path_imgrec=rec,
              path_imgidx=idx, mean_r=1.0, mean_g=2.0, mean_b=3.0,
              std_r=2.0, std_g=2.0, std_b=2.0)
    with P.cpu():
        port = P.io.MXDataIter("ImageRecordIter", **kw)
        got = _batches(port)
    assert isinstance(port, P.io.PrefetchingIter)
    assert isinstance(port.iters[0], P.image.ImageIter)
    _same(_batches(R.io.MXDataIter("ImageRecordIter", **kw)), got)


# --- ImageRecordIter on the CPU --------------------------------------------
ROUTES = [("native", False), ("python", False), ("python", True)]


@pytest.mark.parametrize("route,rand", ROUTES,
                         ids=["native", "python", "python_random"])
def test_cpu_image_record_iter_equals_reference(tmp_path, monkeypatch,
                                                route, rand):
    rec, idx = _rec(str(tmp_path / "r"))
    RN = _ref_native()
    if route == "native":
        if not (RN.available() and P.native.available()):
            pytest.skip("a native library does not build here")
    else:
        monkeypatch.setattr(RN, "available", lambda: False)
        monkeypatch.setattr(P.native, "available", lambda: False)
    kw = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 24, 24),
              batch_size=3, shuffle=rand, seed=4, rand_crop=rand,
              rand_mirror=rand, mean_r=123.68, mean_g=116.78,
              mean_b=103.94, std_r=58.4, std_g=57.12, std_b=57.38,
              preprocess_threads=2)
    port = P.io.ImageRecordIter(ctx=P.cpu(), **kw)
    ref = R.io.ImageRecordIter(**kw)
    assert (port._impl is None) == (route == "python")
    assert port.provide_data[0].shape == (3, 3, 24, 24)
    for epoch in range(2):              # reset: the next epoch's order
        got, want = _batches(port), _batches(ref)
        assert len(got) == 3 and got[-1][2] == 2
        _same(want, got)
        port.reset()
        ref.reset()


def test_card_image_record_iter_refuses_png_before_the_card(tmp_path):
    """The card route decodes JPEG only: a PNG record raises, naming the
    format (the check runs on the host before any decode)."""
    from mxnet_tpu_torch.io.io import _CardImageRecordImpl
    rec, idx = _rec(str(tmp_path / "p"), n=2, fmt=".png")
    impl = _CardImageRecordImpl.__new__(_CardImageRecordImpl)
    P.io.io._PyImageRecordImpl.__init__(impl, rec, idx, 2, (3, 8, 8))
    with pytest.raises(P.MXNetError, match="PNG"):
        impl.read_batch()


# --- native.py -------------------------------------------------------------
def _natives():
    RN = _ref_native()
    if not (RN.available() and P.native.available()):
        pytest.skip("a native library does not build here")
    return RN, P.native


def test_native_surface_and_features():
    RN, PN = _natives()
    assert PN.__all__ == RN.__all__
    assert set(PN._PROTOTYPES) == set(RN._PROTOTYPES)
    assert PN.features() == RN.features()
    with open(os.path.join(os.path.dirname(__file__), "data", "torch_image",
                           "q95_420_37x53.jpg"), "rb") as f:
        buf = f.read()
    np.testing.assert_array_equal(PN.imdecode(buf), RN.imdecode(buf))
    assert set(PN.decode_profile(buf, reps=2)) == \
        set(RN.decode_profile(buf, reps=2))
    PN.decode_profile_reset()
    PN.imdecode(buf)
    assert PN.decode_profile_stats()["jpeg"] == 1


@pytest.mark.parametrize("writer", ["P", "R"])
def test_native_recordio_crosses_packages(tmp_path, writer):
    RN, PN = _natives()
    W, Rd = (PN, RN) if writer == "P" else (RN, PN)
    path = str(tmp_path / "n.rec")
    w = W.RecordIOWriter(path)
    records = [b"abc", b"", b"x" * 1001, b"\x0a\x23\xd7\xce" * 5]
    offsets = []
    for r in records:
        offsets.append(w.tell())
        w.write(r)
    w.close()
    r = Rd.RecordIOReader(path)
    assert [r.read() for _ in records] == records
    assert r.read() is None
    r.seek(offsets[2])
    assert r.read() == records[2]
    r.close()
    assert P.recordio.MXRecordIO(path, "r").read() == records[0]


def _engine_run(N, **kw):
    eng = N.NativeEngine(**kw)
    v, u = eng.new_var(), eng.new_var()
    log = []
    for i in range(5):
        eng.push(lambda i=i: log.append(("w", i)), mutate_vars=[v])
        eng.push(lambda i=i: log.append(("r", i)), const_vars=[v],
                 mutate_vars=[u])

    def fail():
        raise RuntimeError("op failed")

    eng.push(fail, mutate_vars=[u])
    eng.wait_for_var(v)
    versions = (eng.var_version(v), )
    with pytest.raises(Exception, match="op failed"):
        eng.wait_for_var(u)
    eng.wait_for_all()
    stats = N.engine_stats()
    return log, versions, stats


def test_native_engine_equals_reference():
    """Writes to one var run in push order, each read after its write;
    a failing op's error surfaces at the wait on its var; versions count
    the writes — in both packages' engines."""
    RN, PN = _natives()
    a = _engine_run(RN)            # the reference's process engine as is
    b = _engine_run(PN, engine_type="threaded", num_workers=3)
    assert [x for x in b[0] if x[0] == "w"] == [("w", i) for i in range(5)]
    for log in (a[0], b[0]):
        for i in range(5):
            assert log.index(("w", i)) < log.index(("r", i))
    assert a[1] == b[1]
    assert set(a[2]) == set(b[2])
    assert b[2]["workers"] == 3
    PN.NativeEngine("naive")
    out = []
    e = PN.NativeEngine()
    e.push(lambda: out.append(1))
    assert out == [1]          # naive: runs in the caller's thread


def test_native_storage_and_shm_equal_reference():
    RN, PN = _natives()
    figures = []
    for N in (RN, PN):
        N.storage_release_all()
        base = N.storage_stats()
        a = N.storage_alloc(1000)
        b = N.storage_alloc(3 << 20)
        live = N.storage_stats()
        N.storage_free(a)
        N.storage_free(b)
        pooled = N.storage_stats()
        c = N.storage_alloc(1000)          # reuses the pooled block
        again = N.storage_stats()
        N.storage_free(c)
        N.storage_release_all()
        figures.append([{k: v - base.get(k, 0) if k == "num_allocs" else v
                         for k, v in s.items()}
                        for s in (live, pooled, again)])
    assert figures[0] == figures[1]
    name = "/mxt_shm_test_%d" % os.getpid()
    seg = PN.Shm(name, 4 * 12, create=True)
    arr = seg.asarray((3, 4))
    arr[:] = np.arange(12).reshape(3, 4)
    other = RN.Shm(name)                   # the reference attaches
    np.testing.assert_array_equal(other.asarray((3, 4)), arr)
    other.close()
    seg.unlink()
    seg.close()
