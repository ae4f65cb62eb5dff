"""Data iterators.

Port of ``mxnet_tpu/io/io.py`` (upstream ``python/mxnet/io/io.py``):
``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter`` (with shuffle
and the pad / discard / roll_over last-batch handling), ``ResizeIter``,
``PrefetchingIter`` (threads), ``DevicePrefetchIter``,
``ImageRecordIter``, ``CSVIter``, ``LibSVMIter`` (CSR batches) and the
iterator registry (``register_iter``, ``MXDataIter``, ``list_iters``).
``NDArrayIter`` keeps its source on the host, as numpy arrays (float64
becomes float32, as ``nd.array`` makes it), draws its shuffle from
``np.random`` as the reference does, and builds each batch's NDArrays on
the current context: the card, or the CPU inside ``with mx.cpu():``.

``ImageRecordIter`` runs on the card unless ``ctx`` is a CPU context.  A
CPU context takes the reference's route: the native threaded loader
(``native.py``) when its library builds, else the Python loop.  On the
card a batch's JPEG records decode with nvJPEG into one buffer on the
card (``image/_nvjpeg.py``) and the augment stages run in one kernel
(``kernels/image_aug.py``).  ``DevicePrefetchIter`` fills superbatches on
a stream of its own and the consumer's stream waits on its event.
"""
from __future__ import annotations

import collections
import threading

import numpy as _np
import torch

from .. import ndarray as nd
from ..base import MXNetError, Registry
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "ImageRecordIter", "MXDataIter", "CSVIter", "LibSVMIter",
           "register_iter", "list_iters"]

_ITER_REG = Registry("data_iter")


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape,
                                          self.dtype, self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise MXNetError("Data must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data] if self.data else None
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            type(self).__name__, data_shapes, label_shapes)


class DataIter:
    """Base iterator (reference ``mx.io.DataIter``)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _host(v, name):
    """A host numpy copy of an NDArray or array-like (float64 as
    float32)."""
    if isinstance(v, NDArray):
        return v.asnumpy()
    try:
        a = _np.asarray(v)
    except Exception:
        raise MXNetError("Invalid type '%s' for %s, should be NDArray or "
                         "numpy.ndarray" % (type(v), name))
    return a.astype(_np.float32) if a.dtype == _np.float64 else a


def _init_data(data, allow_empty, default_name):
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise MXNetError(
            "Input must be NDArray, numpy.ndarray, a list of them or "
            "dict with them as values")
    return [(k, _host(v, k)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """In-memory iterator (reference ``mx.io.NDArrayIter``) with
    shuffle and pad/discard/roll_over semantics."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        self.num_source = len(self.data)
        self.cursor = -self.batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source, start=None, end=None):
        assert start is not None or end is not None
        if start is None:
            start = 0
        if end is None:
            end = data_source[0][1].shape[0] if data_source else 0
        s = self.idx[start:end]
        return [x[1][s] for x in data_source]

    def _batchify(self, data_source):
        if self.cursor > self.num_data:
            raise StopIteration
        if self.cursor + self.batch_size <= self.num_data:
            parts = self._getdata(data_source, self.cursor,
                                  self.cursor + self.batch_size)
        else:
            # padding required
            pad = self.batch_size - self.num_data + self.cursor
            first = self._getdata(data_source, self.cursor, self.num_data)
            if self.last_batch_handle == "discard":
                raise StopIteration
            second = self._getdata(data_source, 0, pad)
            parts = [_np.concatenate([a, b], axis=0)
                     for a, b in zip(first, second)]
        return [nd.array(p, dtype=p.dtype) for p in parts]

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if self.last_batch_handle == "discard" and \
                self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def getdata(self):
        return self._batchify(self.data)

    def getlabel(self):
        return self._batchify(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        if self.last_batch_handle == "roll_over" and self.cursor < 0:
            return -self.cursor
        return 0


class ResizeIter(DataIter):
    """Resize an iterator to ``size`` batches per epoch (reference
    ``mx.io.ResizeIter``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetch (reference: ``mx.io.PrefetchingIter``,
    engine analog ``dmlc::ThreadedIter`` double buffering): one thread a
    base iterator fetches its next batch while the consumer works, under
    the context current where the iterator was made."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        ctx = current_context()     # the threads build batches there

        def prefetch_func(self, i):
            with ctx:
                while True:
                    self.data_taken[i].wait()
                    if not self.started:
                        break
                    try:
                        self.next_batch[i] = self.iters[i].next()
                    except StopIteration:
                        self.next_batch[i] = None
                    self.data_taken[i].clear()
                    self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        try:
            self.started = False
            for e in self.data_taken:
                e.set()
            for thread in self.prefetch_threads:
                thread.join(timeout=1)
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            return False
        self.current_batch = self.next_batch[0]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad



class _PrefetchState:
    """Shared state between a DevicePrefetchIter and its worker thread.
    The thread holds ONLY this object — never the iterator — so the
    iterator stays collectable and its finalizer can stop the thread."""
    __slots__ = ("iter", "S", "ctx", "base_ctx", "q", "go", "lock",
                 "thread", "stop", "epoch", "stream")

    def __init__(self):
        self.stop = False
        self.epoch = 0
        self.stream = None


class _PrefetchError(Exception):
    """A worker-side failure tagged with the epoch captured at decode
    START.  Tagging at failure time instead (re-reading ``st.epoch``
    after the stack unwound) would let a concurrent ``reset()`` — which
    can win the lock the moment the failing decode releases it —
    re-tag a stale failure into the NEW epoch, and the consumer would
    rethrow an old epoch's error after a clean reset."""

    def __init__(self, epoch, error):
        super().__init__(error)
        self.epoch = epoch
        self.error = error


def _stack(parts, dev):
    """One (S, ...) tensor on ``dev`` of S batches' arrays: stacked where
    they lie when already on ``dev``, else stacked on the host into
    page-locked memory and copied without blocking (on the current
    stream)."""
    ts = [p._data for p in parts]
    if all(t.device == dev for t in ts):
        return torch.stack(ts)
    host = torch.stack([t.cpu() for t in ts])
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


def _prefetch_fill(st):
    """S batches of the base iterator as one superbatch on ``st.ctx``:
    (data, label, pad), or None at the end of the epoch (a partial
    superbatch is dropped)."""
    ds, ls, pad = [], [], 0
    for _ in range(st.S):
        try:
            b = st.iter.next()
        except StopIteration:
            return None
        ds.append(list(b.data))
        ls.append(list(b.label))
        pad += int(b.pad or 0)
    dev = st.ctx.torch_device
    data = [NDArray(_stack([row[i] for row in ds], dev), st.ctx)
            for i in range(len(ds[0]))]
    label = [NDArray(_stack([row[i] for row in ls], dev), st.ctx)
             for i in range(len(ls[0]))]
    return data, label, pad


def _prefetch_decode_super(st):
    """Fill one superbatch under the lock; returns (epoch, item or
    None).  The epoch is read under the SAME lock, so a concurrent
    reset() cannot tag a fresh-epoch superbatch with the old epoch.  On
    the card the work runs on the worker's own stream, outside any graph
    capture (``_graphs.CAPTURE_LOCK``), and the item carries an event
    the consumer's stream waits on.  Failures raise
    :class:`_PrefetchError` carrying the decode-start epoch."""
    from .._graphs import CAPTURE_LOCK
    with st.lock:
        epoch = st.epoch
        try:
            if st.stream is None:
                host = _prefetch_fill(st)
                ready = None
            else:
                with CAPTURE_LOCK, torch.cuda.stream(st.stream):
                    host = _prefetch_fill(st)
                    ready = torch.cuda.Event()
                    ready.record(st.stream)
        except Exception as e:
            raise _PrefetchError(epoch, e) from e
    if host is None:
        return epoch, None
    data, label, pad = host
    # pad = total padded (wrapped-duplicate) samples across the S
    # stacked batches, so consumers can down-weight them as with any
    # padded DataBatch
    item = DataBatch(data=data, label=label, pad=pad, index=None)
    item._ready = ready
    return epoch, item


def _prefetch_put(st, item):
    import queue
    while not st.stop:
        try:
            st.q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _prefetch_worker(st):
    if st.stream is not None:
        torch.cuda.set_device(st.ctx.torch_device)
    with st.base_ctx:                # where the base iterator builds
        _prefetch_loop(st)


def _prefetch_loop(st):
    while not st.stop:
        try:
            epoch, item = _prefetch_decode_super(st)
        except _PrefetchError as pe:
            # deferred-exception contract: the consumer rethrows in
            # next().  The tag is the epoch captured at DECODE START —
            # a reset() racing this handler cannot re-tag the stale
            # failure into its fresh epoch (see _PrefetchError)
            epoch, item = pe.epoch, pe.error
        if item is None or isinstance(item, Exception):
            # park until reset() re-arms the epoch.  clear() BEFORE the
            # put: if it came after, a consumer that sees the item and
            # calls reset() immediately could set() in between and the
            # clear would erase the wakeup, parking the worker forever
            st.go.clear()
            if not _prefetch_put(st, (epoch, item)):
                return
            # the epoch check breaks the park when a reset() ran before
            # the clear() above (its set() would have been erased)
            while not st.stop and st.epoch == epoch \
                    and not st.go.wait(timeout=0.2):
                pass
        elif not _prefetch_put(st, (epoch, item)):
            return


def _prefetch_close(st):
    st.stop = True
    st.go.set()
    try:                             # unblock a worker stuck on put()
        st.q.get_nowait()
    except Exception:
        pass
    st.thread.join(timeout=2)


class DevicePrefetchIter(DataIter):
    """Prefetch-to-device superbatch iterator.

    Wraps any :class:`DataIter`: a background thread takes ``super_size``
    consecutive batches (under the context current where it was made),
    stacks them into ONE ``(S, B, ...)`` superbatch on ``ctx`` (default:
    that context) while the consumer still trains on the previous one.  Each yielded :class:`DataBatch` holds
    NDArrays on ``ctx`` that feed ``DataParallelTrainer.run_steps``
    (which replays its captured step once a slice)::

        it = DevicePrefetchIter(ImageRecordIter(...), super_size=8,
                                ctx=mx.gpu(0))
        for batch in it:                      # (S, B, C, H, W) on the card
            losses = trainer.run_steps(batch.data[0], batch.label[0])

    On the card the thread works on a CUDA stream of its own: batches
    that lie on the host are stacked into page-locked memory and copied
    without blocking; batches already on the card (``ImageRecordIter``'s
    card route) are stacked there.  It records an event after the
    superbatch, and ``next()`` makes the consumer's current stream wait
    on it (and marks the tensors as used there), so ``run_steps`` copies
    finished data into its captured inputs.  The thread's CUDA work
    waits out a graph capture in another thread and a capture waits for
    it (``_graphs.CAPTURE_LOCK``), so it is never captured.

    A trailing partial superbatch (fewer than ``super_size`` batches
    left in the epoch) is dropped: emitting it would change the step
    count of ``run_steps`` every epoch tail.

    ``close()`` stops the worker thread and releases the queued
    superbatch; it is also registered as a ``weakref.finalize`` so an
    abandoned iterator is torn down when garbage-collected (the thread
    itself only references a private state object, never the iterator,
    so collection actually happens).
    """

    def __init__(self, base_iter, super_size=8, ctx=None):
        super().__init__()
        if super_size < 1:
            raise MXNetError("DevicePrefetchIter: super_size must be >= 1")
        import queue
        import weakref
        self.iter = base_iter
        self.S = int(super_size)
        self.batch_size = getattr(base_iter, "batch_size", 0)
        self.current_batch = None
        self._exhausted = False
        st = self._st = _PrefetchState()
        st.iter = base_iter
        st.S = self.S
        st.base_ctx = current_context()
        st.ctx = st.base_ctx if ctx is None else ctx
        if st.ctx.device_type == "gpu":
            st.stream = torch.cuda.Stream(st.ctx.torch_device)
        st.q = queue.Queue(maxsize=1)
        st.go = threading.Event()
        st.lock = threading.Lock()
        self._finalizer = weakref.finalize(self, _prefetch_close, st)
        st.thread = threading.Thread(target=_prefetch_worker, args=(st,),
                                     daemon=True)
        st.thread.start()

    # -- consumer -----------------------------------------------------------
    def next(self):
        import queue
        st = self._st
        # an exhausted (or closed / worker-failed) iterator keeps
        # raising StopIteration until reset() — the worker is parked
        # then, so blocking on the queue would deadlock the consumer
        if self._exhausted or st.stop:
            raise StopIteration
        while True:
            # timed get re-checking st.stop (mirrors _prefetch_put): a
            # consumer blocked here while another thread close()s the
            # iterator must wake up and stop, not hang forever on a
            # queue no parked/joined worker will ever feed again
            try:
                epoch, item = st.q.get(timeout=0.2)
            except queue.Empty:
                if st.stop:
                    raise StopIteration
                continue
            if epoch != st.epoch:
                continue             # stale item decoded before reset()
            if item is None:
                self._exhausted = True
                raise StopIteration
            if isinstance(item, Exception):
                self._exhausted = True   # worker parked; reset() re-arms
                raise MXNetError(
                    "DevicePrefetchIter worker failed: %r" % item) \
                    from item
            if item._ready is not None:
                cur = torch.cuda.current_stream(st.ctx.torch_device)
                cur.wait_event(item._ready)
                for a in list(item.data) + list(item.label):
                    a._data.record_stream(cur)
            self.current_batch = item
            return item

    def reset(self):
        # invalidate anything decoded so far (epoch tag), reset the
        # underlying iterator (the lock waits out an in-flight decode),
        # and un-park the worker if it hit the end of the epoch
        st = self._st
        with st.lock:
            st.epoch += 1
            st.iter.reset()
        self._exhausted = False
        st.go.set()

    def close(self):
        """Stop the prefetch thread and drop the queued superbatch."""
        self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    @property
    def provide_data(self):
        return [DataDesc(d.name, (self.S,) + tuple(d.shape),
                         getattr(d, "dtype", _np.float32))
                for d in self.iter.provide_data]

    @property
    def provide_label(self):
        return [DataDesc(d.name, (self.S,) + tuple(d.shape),
                         getattr(d, "dtype", _np.float32))
                for d in self.iter.provide_label]


class ImageRecordIter(DataIter):
    """High-throughput image iterator over ``.rec``/``.idx`` packs.

    Reference: ``ImageRecordIter`` of ``src/io/iter_image_recordio_2.cc``:
    sharded RecordIO parse → JPEG decode → augment (resize, crop, flip,
    normalize) → batch → prefetch.  ``ctx`` (default: the current
    context, the card) picks the route:

    * the card: nvJPEG decodes a batch's JPEGs into card memory and the
      ``image_aug`` kernel augments them in one launch, with the native
      loader's arithmetic (its bilinear resizes; its DCT-domain downscale
      under ``dct_scale`` as the decode's box average to libjpeg's size,
      in ``jpeg_color``); crops and
      flips come from ``numpy.random.RandomState(seed)``.  A PNG record
      raises (nvJPEG reads JPEG only);
    * a CPU context: the native threaded loader (``native.py``) when its
      library builds, else a Python decode loop with the same semantics
      (slow, correctness only), each batch on ``ctx``.

    ``layout="NHWC"`` lays each image out channels-last instead.
    """

    def __init__(self, path_imgrec, path_imgidx=None, data_shape=(3, 224, 224),
                 batch_size=32, shuffle=False, seed=0, part_index=0,
                 num_parts=1, rand_crop=False, rand_mirror=False,
                 resize=0, label_width=1, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=4, layout="NCHW", round_batch=True,
                 dct_scale=True, data_name="data",
                 label_name="softmax_label", ctx=None, **kwargs):
        super().__init__(batch_size)
        if path_imgidx is None:
            path_imgidx = path_imgrec[:-4] + ".idx" \
                if path_imgrec.endswith(".rec") else path_imgrec + ".idx"
        self._layout = layout
        c, h, w = data_shape
        self._data_shape = (batch_size, c, h, w) if layout == "NCHW" \
            else (batch_size, h, w, c)
        self._label_shape = (batch_size, label_width) if label_width > 1 \
            else (batch_size,)
        self.data_name = data_name
        self.label_name = label_name
        self._ctx = current_context() if ctx is None else ctx
        self._pad = 0
        self._batch = None
        opts = dict(shuffle=shuffle, seed=seed, part_index=part_index,
                    num_parts=num_parts, rand_crop=rand_crop,
                    rand_mirror=rand_mirror, resize=resize,
                    label_width=label_width, mean=(mean_r, mean_g, mean_b),
                    std=(std_r, std_g, std_b), scale=scale, layout=layout,
                    round_batch=round_batch)
        from .. import native
        self._impl = self._py = None
        if self._ctx.device_type == "gpu":
            self._py = _CardImageRecordImpl(
                path_imgrec, path_imgidx, batch_size, data_shape,
                self._ctx.torch_device, dct_scale=dct_scale, **opts)
        elif native.available():
            self._impl = native.ImageRecordLoader(
                path_imgrec, path_imgidx, batch_size, data_shape,
                num_threads=preprocess_threads, dct_scale=dct_scale, **opts)
        else:
            self._py = _PyImageRecordImpl(
                path_imgrec, path_imgidx, batch_size, data_shape, **opts)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, self._data_shape,
                         layout=self._layout)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, self._label_shape)]

    def reset(self):
        (self._impl or self._py).reset()

    def iter_next(self):
        res = (self._impl or self._py).next()
        if res is None:
            return False
        data, label, pad = res
        if isinstance(data, torch.Tensor):
            self._batch = (NDArray(data, self._ctx),
                           NDArray(label, self._ctx))
        else:
            self._batch = (nd.array(data, ctx=self._ctx),
                           nd.array(label, ctx=self._ctx))
        self._pad = pad
        return True

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=[self._batch[0]], label=[self._batch[1]],
                         pad=self._pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def getdata(self):
        return [self._batch[0]]

    def getlabel(self):
        return [self._batch[1]]

    def getpad(self):
        return self._pad


class _PyImageRecordImpl:
    """Pure-Python loader of ImageRecordIter on the CPU: the record
    format and augmentation order of the native pipeline, one sample at
    a time (the reference's own fallback: OpenCV's cubic resize of the
    short side, its linear resize up to the crop)."""

    def __init__(self, path_imgrec, path_imgidx, batch_size, data_shape,
                 shuffle=False, seed=0, part_index=0, num_parts=1,
                 rand_crop=False, rand_mirror=False, resize=0, label_width=1,
                 mean=(0, 0, 0), std=(1, 1, 1), scale=1.0, layout="NCHW",
                 round_batch=True):
        from .. import recordio
        self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
        n = len(self._rec.keys)
        begin, end = n * part_index // num_parts, \
            n * (part_index + 1) // num_parts
        self._keys = self._rec.keys[begin:end]
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.label_width = label_width
        self.mean = _np.asarray(mean, dtype=_np.float32)
        self.std = _np.asarray(std, dtype=_np.float32)
        self.scale = scale
        self.layout = layout
        self.round_batch = round_batch
        self._rng = _np.random.RandomState(seed)
        self._order = None
        self._cursor = 0
        self.reset()

    def reset(self):
        self._order = _np.arange(len(self._keys))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _label(self, header):
        label = header.label
        if isinstance(label, (int, float)):
            return _np.full((self.label_width,), label, dtype=_np.float32)
        return _np.asarray(label, dtype=_np.float32)[:self.label_width]

    def _load_one(self, key):
        from .. import recordio
        from ..context import cpu
        from ..image import image as img_mod
        header, blob = recordio.unpack(self._rec.read_idx(key))
        im = img_mod.imdecode(blob, ctx=cpu())   # HWC RGB uint8
        c, h, w = self.data_shape
        if self.resize > 0:
            im = img_mod.resize_short(im, self.resize)
        ih, iw = im.shape[:2]
        if ih < h or iw < w:
            im = img_mod.imresize(im, max(iw, w), max(ih, h))
            ih, iw = im.shape[:2]
        im = im.asnumpy()
        if self.rand_crop:
            y0 = self._rng.randint(0, ih - h + 1)
            x0 = self._rng.randint(0, iw - w + 1)
        else:
            y0, x0 = (ih - h) // 2, (iw - w) // 2
        im = im[y0:y0 + h, x0:x0 + w]
        if self.rand_mirror and self._rng.randint(2):
            im = im[:, ::-1]
        # the native loader's (pix * scale - mean) * (1 / std), which the
        # reference's loop computes too
        out = (im.astype(_np.float32) * _np.float32(self.scale)
               - self.mean) * (_np.float32(1) / self.std)
        if self.layout == "NCHW":
            out = out.transpose(2, 0, 1)
        return out, self._label(header)

    def _batch_slots(self):
        """The batch's (positions in the epoch order, pad), or None at
        the end of the epoch."""
        n_total = len(self._order)
        if self._cursor >= n_total:
            return None
        idxs, pad = [], 0
        for i in range(self.batch_size):
            idx = self._cursor + i
            if idx >= n_total:
                if not self.round_batch:
                    return None
                idx %= n_total
                pad += 1
            idxs.append(idx)
        self._cursor += self.batch_size
        return idxs, pad

    def next(self):
        slots = self._batch_slots()
        if slots is None:
            return None
        idxs, pad = slots
        c, h, w = self.data_shape
        shape = (self.batch_size, c, h, w) if self.layout == "NCHW" \
            else (self.batch_size, h, w, c)
        data = _np.zeros(shape, dtype=_np.float32)
        label = _np.zeros((self.batch_size, self.label_width),
                          dtype=_np.float32)
        for i, idx in enumerate(idxs):
            data[i], label[i] = self._load_one(self._keys[self._order[idx]])
        if self.label_width == 1:
            label = label[:, 0]
        return data, label, pad


class _CardImageRecordImpl(_PyImageRecordImpl):
    """ImageRecordIter's card route: a batch's records read on the host,
    their JPEGs decoded by nvJPEG into one buffer on ``device`` (with
    ``jpeg_color``, which also takes the DCT scaling) and augmented by
    the ``image_aug`` kernel, on the current stream; the epoch order,
    shard and padding of the Python loader."""

    def __init__(self, path_imgrec, path_imgidx, batch_size, data_shape,
                 device, dct_scale=True, **kw):
        from ..image import _nvjpeg
        super().__init__(path_imgrec, path_imgidx, batch_size, data_shape,
                         **kw)
        self.device = device
        self.dct_scale = dct_scale
        self.codec = _nvjpeg.decoder(device)

    def read_batch(self):
        """The next batch's (JPEG blobs, labels (B, label_width), pad) from
        the records, or None at the end of the epoch."""
        from .. import recordio
        from ..image.image import _is_png
        slots = self._batch_slots()
        if slots is None:
            return None
        idxs, pad = slots
        blobs = []
        label = _np.zeros((self.batch_size, self.label_width),
                          dtype=_np.float32)
        for i, idx in enumerate(idxs):
            header, blob = recordio.unpack(
                self._rec.read_idx(self._keys[self._order[idx]]))
            if _is_png(blob):
                raise MXNetError("ImageRecordIter on the card: record %d is "
                                 "a PNG, which is not decoded on the card "
                                 "(nvJPEG reads JPEG only); pass "
                                 "ctx=mx.cpu()"
                                 % self._keys[self._order[idx]])
            blobs.append(blob)
            label[i] = self._label(header)
        return blobs, label, pad

    def decode(self, blobs):
        """The batch's JPEGs decoded on the card with the native loader's
        DCT scaling: (buffer, [(h, w)] as written)."""
        from ..kernels.jpeg_color import min_short, pick_denom
        infos = [self.codec.info(b) for b in blobs]
        keep = min_short(self.data_shape, self.rand_crop, self.resize,
                         self.dct_scale)
        denoms = [pick_denom(inf[0], inf[1], keep) for inf in infos]
        return self.codec.decode_batch(blobs, infos, denoms)

    def table(self, sizes):
        """The next batch's ``image_aug`` table of the decoded ``sizes``
        (its crops and flips drawn from the iterator's generator)."""
        from ..kernels.image_aug import aug_table
        return aug_table(sizes, self.data_shape, self._rng,
                         rand_crop=self.rand_crop,
                         rand_mirror=self.rand_mirror, resize=self.resize)

    def next(self):
        from ..kernels.image_aug import image_aug
        got = self.read_batch()
        if got is None:
            return None
        blobs, label, pad = got
        buf, sizes = self.decode(blobs)
        table = self.table(sizes)
        data = image_aug(buf, table.to(self.device), self.data_shape,
                         self.mean, self.std, self.scale, self.layout)
        label = torch.from_numpy(label[:, 0] if self.label_width == 1
                                 else label).to(self.device)
        return data, label, pad


_ITER_REG.register("ImageRecordIter")(ImageRecordIter)


def register_iter(name):
    return _ITER_REG.register(name)


def MXDataIter(name, **kwargs):
    """Create a registered iterator by name (reference: the C++ iterator
    registry behind ``MXDataIterCreateIter``)."""
    return _ITER_REG.create(name, **kwargs)


def list_iters():
    return _ITER_REG.list()


class CSVIter(DataIter):
    """Iterate rows of CSV files (reference: ``src/io/iter_csv.cc``).

    ``data_csv``/``label_csv`` name CSV files; ``data_shape`` is the
    per-row shape.  Rows are read eagerly into host memory and served
    batch-by-batch with ``round_batch`` padding semantics."""

    def __init__(self, data_csv=None, data_shape=None, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            # no label_csv → all-zero dummy label, matching the reference
            # iter_csv.cc ("if label_csv is not available, all labels
            # will be returned as 0") so batch.label[0] stays valid
            label = _np.zeros((data.shape[0],) + tuple(label_shape),
                              dtype=dtype)
        # round_batch=True: wrap the final short batch with leading
        # samples and report pad (the reference BatchLoader contract,
        # same as ImageRecordIter above); False: drop the short batch
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="pad"
                                  if round_batch else "discard")
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """Iterate LibSVM-format sparse records (reference:
    ``src/io/iter_libsvm.cc``): ``label idx:val idx:val ...`` per line.
    Batches are served as CSR NDArrays (dense fallback available via
    ``.tostype('default')``)."""

    @staticmethod
    def _parse(path, ncol):
        labels, rows = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = {}
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    row[int(i)] = float(v)
                rows.append(row)
        dense = _np.zeros((len(rows), ncol), dtype="float32")
        for r, row in enumerate(rows):
            for c, v in row.items():
                dense[r, c] = v
        return dense, _np.asarray(labels, dtype="float32")

    def __init__(self, data_libsvm=None, data_shape=None,
                 label_libsvm=None, label_shape=None, batch_size=1,
                 round_batch=True, **kwargs):
        ncol = int(data_shape[0])
        self._dense, lead_labels = self._parse(data_libsvm, ncol)
        if label_libsvm is not None:
            # separate label file: dense value(s) per line (the common
            # scalar-per-line case, or label_shape values per line)
            lcol = int(label_shape[0]) if label_shape else 1
            vals = []
            with open(label_libsvm) as f:
                for line in f:
                    if line.strip():
                        vals.append([float(t) for t in line.split()])
            self._labels = _np.asarray(vals, dtype="float32") \
                .reshape(-1, lcol)
        else:
            self._labels = lead_labels.reshape(-1, 1)
        self._bs = batch_size
        self._round = round_batch
        self._pos = 0
        super().__init__(batch_size)
        self._provide_data = [DataDesc("data", (batch_size, ncol))]
        self._provide_label = [DataDesc(
            "softmax_label", (batch_size,) + tuple(self._labels.shape[1:]))]

    @property
    def provide_data(self):
        return self._provide_data

    @property
    def provide_label(self):
        return self._provide_label

    def reset(self):
        self._pos = 0

    def next(self):
        from ..ndarray import sparse as sp
        if self._pos >= len(self._dense):
            raise StopIteration
        end = self._pos + self._bs
        d = self._dense[self._pos:end]
        l = self._labels[self._pos:end]
        pad = 0
        if len(d) < self._bs:
            if not self._round:
                # round_batch=False: drop the final short batch
                raise StopIteration
            pad = self._bs - len(d)
            d = _np.concatenate([d, self._dense[:pad]])
            l = _np.concatenate([l, self._labels[:pad]])
        self._pos = end
        data = sp.csr_matrix(d)
        return DataBatch(data=[data], label=[nd.array(l)], pad=pad)


_ITER_REG.register("CSVIter")(CSVIter)
_ITER_REG.register("LibSVMIter")(LibSVMIter)
