"""The port's Gluon data (``mxnet_tpu_torch/gluon/data``) and RecordIO
(``mxnet_tpu_torch/recordio.py``) against the reference's, on the CPU.

* RecordIO: records, continuation records, the index and the headers
  written by one package read back by the other, byte for byte.
* Samplers, datasets and the DataLoader: the same indices, items and
  batches in both packages from the same numpy seed (``RandomSampler``
  shuffles with numpy's global generator in both); batches compare
  exactly (they are copies and stacks).  The port's batches lie on the
  host: ``ctx`` is the CPU, or page-locked memory with
  ``pin_memory=True`` (the ``cuda`` case).
* The synthetic vision datasets draw the same images and labels.
* Each transform that needs no image module, on the same seeded input
  after the same ``random.seed``: equal within rtol 1e-6, atol 1e-6
  (``ToTensor``'s divide and ``Normalize``'s subtract and divide are one
  f32 rounding each; flips, casts and crops are exact).  The transforms
  and datasets that decode or resize through ``mxnet_tpu.image`` raise
  ``NotPorted`` in the port.
* A loader with ``num_workers=2`` gives the ``num_workers=0`` batches of
  a deterministic pipeline, bit for bit, with ``timeout=30`` so that a
  hung worker fails the test.
"""
import random
import struct

import numpy as np
import pytest

import mxnet_tpu_torch as P
from _torch_port import cuda_device  # noqa: F401
from _torch_port import reference as R


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _batches(loader):
    return [_np(b) for b in loader]


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, list):
            _same_batches(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- RecordIO --------------------------------------------------------------
PAYLOADS = [b"record0", b"", b"abc" + struct.pack("<I", 0xced7230a) + b"def"
            + struct.pack("<I", 0xced7230a), b"x" * 13]


@pytest.mark.parametrize("writer,reader", [("P", "R"), ("R", "P"),
                                           ("P", "P")])
def test_recordio_written_by_one_reads_in_the_other(tmp_path, writer,
                                                    reader):
    pw, pr = {"P": P, "R": R}[writer], {"P": P, "R": R}[reader]
    rec, idx = str(tmp_path / "a.rec"), str(tmp_path / "a.idx")
    w = pw.recordio.MXRecordIO(rec, "w")
    for p in PAYLOADS:
        w.write(p)
    w.close()
    r = pr.recordio.MXRecordIO(rec, "r")
    assert [r.read() for _ in PAYLOADS] == PAYLOADS
    assert r.read() is None
    r.close()
    w = pw.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(10):
        w.write_idx(i, b"record%d" % i)
    w.close()
    r = pr.recordio.MXIndexedRecordIO(idx, rec, "r")
    assert r.read_idx(7) == b"record7" and r.read_idx(2) == b"record2"
    assert r.keys == list(range(10))
    r.close()


def test_pack_unpack_match_the_reference():
    for header in (P.recordio.IRHeader(0, 3.0, 7, 0),
                   P.recordio.IRHeader(0, np.array([1.0, 2.0, 3.0]), 9, 1)):
        s = P.recordio.pack(header, b"imagedata")
        assert s == R.recordio.pack(header, b"imagedata")
        h, data = P.recordio.unpack(s)
        h2, data2 = R.recordio.unpack(s)
        assert data == data2 == b"imagedata"
        assert (h.flag, h.id, h.id2) == (h2.flag, h2.id, h2.id2)
        np.testing.assert_array_equal(h.label, h2.label)


def test_pack_img_and_its_opencv_error(monkeypatch):
    img = (np.random.RandomState(0).rand(8, 8, 3) * 255).astype(np.uint8)
    hdr = P.recordio.IRHeader(0, 1.0, 0, 0)
    try:
        import cv2  # noqa: F401
    except ImportError:
        cv2 = None
    if cv2 is not None:
        s = P.recordio.pack_img(hdr, img, quality=1, img_fmt=".png")
        assert s == R.recordio.pack_img(hdr, img, quality=1, img_fmt=".png")
        h, back = P.recordio.unpack_img(s)
        np.testing.assert_array_equal(back, img)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        P.recordio.pack_img(hdr, img)
    with pytest.raises(ImportError, match="OpenCV"):
        P.recordio.unpack_img(b"\0" * 24)


# --- samplers and datasets ---------------------------------------------------
def _samplers(pkg, seed):
    d = pkg.gluon.data
    np.random.seed(seed)
    out = {"seq": list(d.SequentialSampler(5, start=2)),
           "rand": list(d.RandomSampler(20)),
           "interval": list(d.IntervalSampler(7, 3)),
           "interval_norollover": list(d.IntervalSampler(6, 2,
                                                         rollover=False)),
           "filter": list(d.FilterSampler(lambda x: x % 3 == 0,
                                          list(range(10))))}
    for last in ("keep", "discard", "rollover"):
        bs = d.BatchSampler(d.SequentialSampler(7), 3, last)
        out[last] = [list(bs), list(bs), len(bs)]
    return out


def test_samplers_match_the_reference():
    assert _samplers(P, 3) == _samplers(R, 3)


def _datasets(pkg):
    d = pkg.gluon.data
    X = np.arange(34, dtype=np.float32).reshape(17, 2)
    Y = np.arange(17, dtype=np.float32)
    ds = d.ArrayDataset(X, Y)
    simple = d.SimpleDataset(list(range(10)))
    out = {"len": len(ds), "item": _np(ds[3]),
           "first": _np(ds.transform_first(lambda x: x * 2)[4]),
           "eager": [_np(t) for t in ds.transform(
               lambda x, y: (x + y, y), lazy=False)],
           "filter": list(simple.filter(lambda x: x % 2)),
           "shard": [list(simple.shard(3, i)) for i in range(3)],
           "take": list(simple.take(4)), "take_all": len(simple.take(None))}
    return out


def test_datasets_match_the_reference():
    a, b = _datasets(P), _datasets(R)
    assert a.keys() == b.keys()
    _same_batches([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])


def test_record_file_dataset(tmp_path):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = R.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(5):
        w.write_idx(i, b"item%d" % i)
    w.close()
    ds = P.gluon.data.RecordFileDataset(rec)
    assert len(ds) == 5 and [ds[i] for i in range(5)] == \
        [R.gluon.data.RecordFileDataset(rec)[i] for i in range(5)]


# --- the DataLoader ----------------------------------------------------------
def _loader_runs(pkg, **kw):
    d = pkg.gluon.data
    X = np.random.RandomState(0).rand(17, 5).astype(np.float32)
    Y = np.arange(17).astype(np.float32)
    ds = d.ArrayDataset(X, Y)
    np.random.seed(kw.pop("seed", 0))
    return _batches(d.DataLoader(ds, **kw))


@pytest.mark.parametrize("kw", [
    dict(batch_size=5, shuffle=True, last_batch="keep", seed=1),
    dict(batch_size=5, last_batch="discard"),
    dict(batch_size=5, last_batch="rollover", shuffle=True, seed=2),
    dict(batch_size=4, num_workers=2, thread_pool=True),
], ids=["shuffle_keep", "discard", "rollover", "thread_pool"])
def test_loader_matches_the_reference(kw):
    want = _loader_runs(R, **dict(kw))
    got = _loader_runs(P, **dict(kw))
    _same_batches(got, want)


def test_loader_batches_lie_on_the_host():
    with P.cpu():
        ds = P.gluon.data.vision.MNIST(train=False, synthetic=True,
                                       synthetic_size=8)
    for b in P.gluon.data.DataLoader(ds, batch_size=4):
        assert all(x.context == P.cpu() for x in b)
        assert b[0].shape == (4, 28, 28, 1)


def test_loader_argument_errors():
    for pkg in (R, P):
        ds = pkg.gluon.data.SimpleDataset(list(range(4)))
        bs = pkg.gluon.data.BatchSampler(
            pkg.gluon.data.SequentialSampler(4), 2)
        for kw in (dict(), dict(batch_size=2, shuffle=True, sampler=[0]),
                   dict(batch_sampler=bs, batch_size=2)):
            with pytest.raises(pkg.base.MXNetError):
                pkg.gluon.data.DataLoader(ds, **kw)


def _deterministic(pkg, n=40):
    v = pkg.gluon.data.vision
    t = v.transforms
    ds = v.CIFAR10(train=False, synthetic=True, synthetic_size=n)
    return ds.transform_first(t.Compose([
        t.ToTensor(), t.Normalize((0.49, 0.48, 0.45), (0.25, 0.24, 0.26))]))


def test_worker_loader_equals_the_in_process_loader():
    """Two forked workers, four batches in flight, against no workers:
    the same batches bit for bit (and the reference's)."""
    ds = _deterministic(P)
    want = _batches(P.gluon.data.DataLoader(ds, batch_size=8))
    loader = P.gluon.data.DataLoader(ds, batch_size=8, num_workers=2,
                                     timeout=30)
    try:
        got = _batches(loader)
        again = _batches(loader)
    finally:
        loader.close()
    _same_batches(got, want)
    _same_batches(again, want)
    ref = _batches(R.gluon.data.DataLoader(_deterministic(R), batch_size=8))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[0], r[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g[1], r[1])


# --- vision datasets ---------------------------------------------------------
@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_datasets_match_the_reference(name, tmp_path):
    kw = dict(root=str(tmp_path), train=True, synthetic=True,
              synthetic_size=24)
    a = getattr(P.gluon.data.vision, name)(**kw)
    b = getattr(R.gluon.data.vision, name)(**kw)
    assert len(a) == len(b) == 24
    for i in (0, 5, 23):
        (xa, ya), (xb, yb) = a[i], b[i]
        assert ya == yb and xa.context == P.cpu()
        np.testing.assert_array_equal(xa.asnumpy(), xb.asnumpy())


def test_synthetic_instance_seg_dataset_matches_the_reference():
    a = P.gluon.data.vision.SyntheticInstanceSegDataset(4, size=16, seed=3)
    b = R.gluon.data.vision.SyntheticInstanceSegDataset(4, size=16, seed=3)
    for i in range(4):
        (ia, la), (ib, lb) = a[i], b[i]
        np.testing.assert_array_equal(ia.asnumpy(), ib.asnumpy())
        for k in lb:
            np.testing.assert_array_equal(la[k].asnumpy(), lb[k].asnumpy())


def test_mnist_through_to_tensor_and_the_loader():
    ds = P.gluon.data.vision.MNIST(train=True, synthetic=True,
                                   synthetic_size=64)
    tf = P.gluon.data.vision.transforms.ToTensor()
    xb, yb = next(iter(P.gluon.data.DataLoader(
        ds.transform_first(lambda x: tf(x)), batch_size=16)))
    assert xb.shape == (16, 1, 28, 28) and yb.shape == (16,)
    assert float(xb.max().asscalar()) <= 1.0


# --- transforms --------------------------------------------------------------
def _transforms(t):
    return {
        "cast": t.Cast("float16"),
        "to_tensor": t.ToTensor(),
        "normalize": t.Compose([t.ToTensor(), t.Normalize(
            (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
        "flip_lr": t.RandomFlipLeftRight(),
        "flip_tb": t.RandomFlipTopBottom(),
        "brightness": t.RandomBrightness(0.3),
        "gray": t.RandomGray(p=0.5),
        "compose": t.Compose([t.RandomFlipLeftRight(), t.ToTensor()]),
    }


@pytest.mark.parametrize("name", sorted(_transforms(
    P.gluon.data.vision.transforms)))
def test_transform_matches_the_reference(name):
    img = (np.random.RandomState(7).rand(6, 5, 3) * 255).astype(np.uint8)
    outs = []
    for pkg, ctx in ((P, P.cpu()), (R, R.cpu())):
        tf = _transforms(pkg.gluon.data.vision.transforms)[name]
        x = pkg.nd.array(img, dtype="uint8", ctx=ctx)
        random.seed(11)
        outs.append([tf(x).asnumpy() for _ in range(6)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=1e-6,
                                   atol=1e-6)


def test_normalize_makes_its_constants_once_a_device(monkeypatch):
    """``Normalize`` builds its mean and std at its first call on a
    device and reuses them: no host copy on later calls."""
    mod = P.gluon.data.vision.transforms
    made = []
    orig = mod.nd.array
    monkeypatch.setattr(mod.nd, "array",
                        lambda *a, **k: made.append(1) or orig(*a, **k))
    tf = mod.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))
    x = P.nd.ones((2, 3, 4, 4), ctx=P.cpu())
    first = tf(x).asnumpy()
    assert len(made) == 2
    np.testing.assert_array_equal(tf(x).asnumpy(), first)
    assert len(made) == 2


IMAGE_TRANSFORMS = [("Resize", (8,)), ("CenterCrop", (4,)),
                    ("RandomResizedCrop", (4,)), ("RandomCrop", (4,)),
                    ("RandomContrast", (0.2,)), ("RandomSaturation", (0.2,)),
                    ("RandomHue", (0.1,)), ("RandomColorJitter", (0.1, 0.1)),
                    ("RandomLighting", (0.1,))]


@pytest.mark.parametrize("name,args", IMAGE_TRANSFORMS,
                         ids=[n for n, _ in IMAGE_TRANSFORMS])
def test_image_backed_transform_raises_not_ported(name, args):
    tf = getattr(P.gluon.data.vision.transforms, name)(*args)
    x = P.nd.array(np.zeros((6, 6, 3), np.uint8), dtype="uint8",
                   ctx=P.cpu())
    with pytest.raises(P.base.NotPorted, match="mxnet_tpu.image"):
        tf(x)


def test_image_backed_datasets_raise_not_ported(tmp_path):
    v = P.gluon.data.vision
    (tmp_path / "cls").mkdir()
    (tmp_path / "cls" / "a.png").write_bytes(b"")
    (tmp_path / "list.lst").write_text("0\t1.0\tcls/a.png\n")
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = P.recordio.MXIndexedRecordIO(idx, rec, "w")
    w.write_idx(0, P.recordio.pack(P.recordio.IRHeader(0, 1.0, 0, 0), b""))
    w.close()
    folder = v.ImageFolderDataset(str(tmp_path))
    assert folder.synsets == ["cls"] and len(folder) == 1
    lst = v.ImageListDataset(str(tmp_path), str(tmp_path / "list.lst"))
    assert len(lst) == 1
    recds = v.ImageRecordDataset(rec)
    assert len(recds) == 1
    for ds in (folder, lst, recds):
        with pytest.raises(P.base.NotPorted, match="mxnet_tpu.image"):
            ds[0]


# --- on the card -------------------------------------------------------------
@pytest.mark.cuda
def test_pinned_batches_move_to_the_card(cuda_device):
    """``pin_memory=True``: page-locked host batches, with workers and
    without, that reach the card unchanged."""
    ds = _deterministic(P, n=16)
    for workers in (0, 2):
        loader = P.gluon.data.DataLoader(ds, batch_size=8, pin_memory=True,
                                         num_workers=workers, timeout=30)
        try:
            for x, y in loader:
                assert x._data.is_pinned() and y._data.is_pinned()
                g = x.as_in_context(P.gpu(0))
                assert g.context == P.gpu(0)
                np.testing.assert_array_equal(g.asnumpy(), x.asnumpy())
        finally:
            loader.close()


@pytest.mark.cuda
def test_card_normalize_hybridized_matches_cpu(cuda_device):
    """``Normalize`` hybridized on the card (its constants made there
    once, then replayed) against the same batch on the CPU: one subtract
    and one divide, within rtol 1e-6, atol 1e-6."""
    x = np.random.RandomState(8).rand(4, 3, 8, 8).astype(np.float32)
    t = P.gluon.data.vision.transforms
    outs = []
    for ctx, hybrid in ((P.gpu(0), True), (P.cpu(), False)):
        tf = t.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))
        tf.hybridize(hybrid)
        outs.append([tf(P.nd.array(x, ctx=ctx)).asnumpy() for _ in range(3)])
        assert list(tf._consts) == [ctx]
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
