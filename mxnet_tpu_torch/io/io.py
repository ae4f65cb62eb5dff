"""Data iterators.

Port of ``DataDesc``, ``DataBatch``, ``DataIter``, ``NDArrayIter`` (with
shuffle and the pad / discard / roll_over last-batch handling) and
``ResizeIter`` from ``mxnet_tpu/io/io.py`` (upstream
``python/mxnet/io/io.py``).  ``NDArrayIter`` keeps its source on the
host, as numpy arrays (float64 becomes float32, as ``nd.array`` makes
it), draws its shuffle from ``np.random`` as the reference does, and
builds each batch's NDArrays on the current context: the card, or the
CPU inside ``with mx.cpu():``.
"""
from __future__ import annotations

import collections

import numpy as _np

from .. import ndarray as nd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter"]


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
