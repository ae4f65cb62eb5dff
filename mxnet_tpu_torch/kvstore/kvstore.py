"""KVStore implementations for one process.

Port of ``mxnet_tpu/kvstore/kvstore.py`` (MXNet's ``kvstore_local.h``
and ``comm.h``).  ``local``, ``device`` and ``nccl`` (with their
aliases) are one store: ``push`` sums a key's values left to right into
the first value's context (``v0 + v1.as_in_context(ctx0) + ...``),
merges ``row_sparse`` values by the union of their rows, compresses
each context's contribution when 2-bit compression is on, and hands
the sum to the updater (``set_optimizer``, MXNet's
``update_on_kvstore``) or stores it.  ``pull`` writes the stored value
into each ``out`` on that array's own context.

The port's contexts are ``cpu(i)`` (the host, as many as the caller
names) and the cards.  Values on two or more distinct CUDA devices are
refused: the multi-card reduce is not ported (``ROADMAP.md`` item 7b).
``dist_*`` names go to the parameter server, ``parallel/dist.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..base import MXNetError, Registry, not_ported
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["KVStoreBase", "KVStore", "create"]

_REG = Registry("kvstore")


class KVStoreBase:
    """The registry of store types (reference ``kvstore/base.py``)."""

    @staticmethod
    def register(name=None, aliases=()):
        return _REG.register(name, list(aliases))


def one_card(arrays):
    """Refuse values that lie on two or more distinct CUDA devices."""
    cards = {a._data.device for a in arrays
             if isinstance(a, NDArray) and a._data.is_cuda}
    if len(cards) > 1:
        raise not_ported(
            "a kvstore over several CUDA devices (%s; ROADMAP.md item 7b)"
            % ", ".join(sorted(str(c) for c in cards)),
            "mxnet_tpu.kvstore")


class KVStore:
    """The single-process store (types ``local``, ``device``, ``nccl``;
    one reduce for all three, the names kept for scripts)."""

    def __init__(self, name="local"):
        self.type = name
        self._data: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compressor = None

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        keys, values = _normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._data:
                continue
            self._data[k] = v.copy() if isinstance(v, NDArray) else v

    def push(self, key, value, priority=0):
        """Sum each key's values into the stored value (or through the
        updater); the sum runs left to right on the first value's
        context (reference ``KVStoreLocal::Push``)."""
        from ..ndarray.sparse import RowSparseNDArray, add_n
        keys, values = _normalize(key, value)
        for k, vlist in zip(keys, values):
            if not isinstance(vlist, (list, tuple)):
                vlist = [vlist]
            if k not in self._data:
                raise MXNetError("key %s was not initialized" % str(k))
            one_card(vlist)
            if all(isinstance(v, RowSparseNDArray) for v in vlist):
                # the union of the rows stays row_sparse; a lone value is
                # copied, so the caller may write its gradient afterwards
                reduced = add_n(vlist) if len(vlist) > 1 else vlist[0].copy()
                stored = self._data[k]
                if self._updater is not None:
                    self._updater(k, reduced, stored)
                elif stored.stype == "row_sparse":
                    reduced.copyto(stored)
                elif stored.stype == "default":
                    stored._set_data(reduced._to_dense())
                else:
                    raise MXNetError(
                        "push of row_sparse values into a %r-stored key is "
                        "not supported (reference supports default/"
                        "row_sparse targets only)" % stored.stype)
                continue
            target_ctx = vlist[0].context
            if self._compressor is not None and len(vlist) > 1:
                # each context's contribution is compressed before the
                # sum; the residual is kept per (key, context[, n]), n
                # counting repeats of one context in the list
                seen = {}
                slots = []
                for v in vlist:
                    c = str(v.context)
                    n = seen.get(c, 0)
                    seen[c] = n + 1
                    slots.append((k, c) if n == 0 else (k, c, n))
                vlist = [self._dequant(s, v) for s, v in zip(slots, vlist)]
            reduced = vlist[0]
            for v in vlist[1:]:
                reduced = reduced + v.as_in_context(target_ctx)
            if self._updater is not None:
                self._updater(k, reduced, self._data[k])
            else:
                self._data[k]._set_data(
                    reduced.as_in_context(self._data[k].context)._data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _normalize(key, out)
        for k, olist in zip(keys, outs):
            if not isinstance(olist, (list, tuple)):
                olist = [olist]
            one_card(olist)
            src = self._data[k]
            for o in olist:
                if src.stype != "default":
                    # a copy: the target must not share the stored block
                    src.copy().copyto(o)
                else:
                    o._set_data(src.as_in_context(o.context)._data)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names (reference
        ``KVStoreLocal::PullRowSparse``): ``retain`` of a row_sparse
        store, a row gather on the device of a dense one."""
        from ..ndarray import sparse as _sp
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys, outs = _normalize(key, out)
        # row_ids has one entry a key only when the key is a list; a
        # plain list for one key is that key's row ids
        if isinstance(key, (list, tuple)):
            if not isinstance(row_ids, (list, tuple)) or \
                    len(row_ids) != len(keys):
                raise MXNetError("row_sparse_pull: need one row_ids entry "
                                 "per key")
            rid_list = list(row_ids)
        else:
            rid_list = [row_ids]
        for k, olist, rid in zip(keys, outs, rid_list):
            if not isinstance(olist, (list, tuple)):
                olist = [olist]
            src = self._data[k]
            if src.stype == "row_sparse":
                picked = _sp.retain(src, rid)
            else:
                rows = np.unique(np.asarray(
                    rid.asnumpy() if isinstance(rid, NDArray) else rid
                ).astype(np.int64))
                dev = src._data.device
                picked = _sp.RowSparseNDArray(
                    src._data.detach().index_select(
                        0, torch.from_numpy(rows).to(dev)),
                    {"indices": torch.from_numpy(rows.astype(np.int32))
                     .to(dev)}, src.shape)
            for o in olist:
                picked.copyto(o)

    # -- the optimizer on the store (update_on_kvstore) -------------------
    def set_optimizer(self, optimizer):
        from .. import optimizer as opt
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback of each context's
        contribution to a push (reference
        ``KVStoreLocal::SetGradientCompression``)."""
        from ..parallel.compression import create_compressor
        self._compressor = create_compressor(compression_params)

    def _dequant(self, slot, v):
        payload, shape, dtype = self._compressor.compress(slot, v.asnumpy())
        arr = self._compressor.decompress(payload, shape, dtype)
        return nd.array(arr, ctx=v.context)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("Cannot save states for distributed training")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("Cannot load states for distributed training")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), {k: v.context for k, v
                                                in self._data.items()})

    def barrier(self):
        nd.waitall()

    def _send_command_to_servers(self, head, body):
        pass


def _normalize(key, value):
    if isinstance(key, (list, tuple)):
        return list(key), list(value)
    return [key], [value]


for _name, _aliases in [("local", ("local_allreduce_cpu",)),
                        ("device", ("local_allreduce_device", "nccl"))]:
    _REG.register(_name, list(_aliases))(
        (lambda n: (lambda: KVStore(n)))(_name))


def create(name="local"):
    """A store by type name (reference ``mx.kv.create``); ``dist_*``
    names make the parameter server's worker store."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name.startswith("dist"):
        from ..parallel import dist
        return dist.create_dist_kvstore(name)
    return _REG.create(name)
