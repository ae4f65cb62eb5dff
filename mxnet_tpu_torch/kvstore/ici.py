"""The bucketed all-reduce store (type ``ici``).

Port of ``mxnet_tpu/kvstore/ici.py``.  Where the ``device`` store sums
a key's values one after another through the first context, this store
sums them as one reduction over a stacked axis: values that share a
context are first summed locally (plain adds), each context then gives
one flat buffer a bucket, and the bucket's (contexts, numel) stack is
summed over its first axis once.  A multi-key push packs the keys of
one context set and dtype into flat buckets of at most
``MXNET_KV_BUCKET_BYTES`` (default 4 MiB; ``0`` is one reduction a
key).  The sum is elementwise over the stacked axis, so bucketed and
per-key results are bit for bit the same.

``stats()`` counts the buckets (``buckets``) and, of them, the
reductions across contexts that stand for separate devices
(``collectives``): on the CPU each ``cpu(i)`` plays one of the
reference's chips.  On one card the values lie on ``gpu(0)`` or the
host, so a bucket is summed on the card after one copy from the host,
a local sum and no collective.  Values on two or more CUDA devices are
refused (``ROADMAP.md`` item 7b).  ``row_sparse`` values and gradient
compression raise, as in the reference: a union of rows has no fixed
shape, and the 2-bit codec is a wire format.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _tagged
from .kvstore import KVStore, KVStoreBase, _normalize, one_card

__all__ = ["ICIKVStore"]


def _env_bucket_bytes() -> int:
    raw = os.environ.get("MXNET_KV_BUCKET_BYTES", "")
    if not raw:
        return 4 << 20
    try:
        v = int(raw)
        if v < 0:
            raise ValueError(raw)
    except ValueError:
        raise MXNetError(
            "MXNET_KV_BUCKET_BYTES must be a non-negative integer, "
            "got %r" % raw)
    return v


@KVStoreBase.register("ici", aliases=("ici_allreduce",))
class ICIKVStore(KVStore):
    """The single-process store whose cross-context reduce is one
    stacked sum a bucket (type ``ici``)."""

    def __init__(self, bucket_bytes=None):
        super().__init__("ici")
        self.bucket_bytes = (_env_bucket_bytes() if bucket_bytes is None
                             else int(bucket_bytes))
        self._mu = threading.Lock()
        self._collectives = 0
        self._buckets = 0
        self._reduced_bytes = 0

    def set_gradient_compression(self, compression_params):
        raise MXNetError(
            "kvstore 'ici': gradient compression is N/A — 2-bit "
            "compression is a host-side wire codec for TCP parameter "
            "servers; the ICI allreduce moves raw buffers over the "
            "interconnect.  Use kvstore 'device' or 'dist_sync' for "
            "compressed sync.")

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError(
            "kvstore 'ici': row_sparse_pull is N/A — a row-sparse "
            "retain is data-dependent-shape and has no fixed-shape "
            "collective.  Use kvstore 'device' or 'dist_*' for "
            "row_sparse keys.")

    def push(self, key, value, priority=0):
        """Sum each key's values with one stacked sum a flat bucket, then
        apply the updater or store the sum (the ``device`` store's
        semantics)."""
        from ..ndarray.sparse import RowSparseNDArray
        keys, values = _normalize(key, value)
        todo: List[Tuple] = []
        for k, vlist in zip(keys, values):
            if not isinstance(vlist, (list, tuple)):
                vlist = [vlist]
            if k not in self._data:
                raise MXNetError("key %s was not initialized" % str(k))
            if any(isinstance(v, RowSparseNDArray) for v in vlist):
                raise MXNetError(
                    "kvstore 'ici': push of row_sparse values is N/A "
                    "(no fixed-shape collective for a union-merge) — "
                    "use kvstore 'device' or 'dist_*' for key %r" % (k,))
            one_card(vlist)
            todo.append((k, list(vlist)))
        for k, reduced in self._reduce_bucketed(todo):
            stored = self._data[k]
            if self._updater is not None:
                self._updater(k, reduced, stored)
            else:
                stored._set_data(reduced.as_in_context(stored.context)._data)

    def _reduce_bucketed(self, todo):
        """``(key, sum)`` for every pending key; keys of one context set
        and dtype share flat buckets of at most ``bucket_bytes``."""
        groups: Dict[Tuple, List] = {}
        for k, vlist in todo:
            locals_, ctxs = self._local_partials(vlist)
            if len(ctxs) == 1:
                yield k, _tagged(NDArray(locals_[0]), ctxs[0])
                continue
            groups.setdefault((ctxs, locals_[0].dtype), []).append(
                (k, locals_))
        for (ctxs, _), entries in groups.items():
            bucket: List = []
            bucket_sz = 0
            for entry in entries:
                sz = entry[1][0].numel() * entry[1][0].element_size()
                if bucket and bucket_sz + sz > max(self.bucket_bytes, sz):
                    yield from self._reduce_flat(ctxs, bucket)
                    bucket, bucket_sz = [], 0
                bucket.append(entry)
                bucket_sz += sz
                if self.bucket_bytes == 0:
                    yield from self._reduce_flat(ctxs, bucket)
                    bucket, bucket_sz = [], 0
            if bucket:
                yield from self._reduce_flat(ctxs, bucket)

    @staticmethod
    def _local_partials(vlist):
        """One tensor a context: values that share a context are summed
        there first (in list order), so each context gives one buffer and
        two contexts add in one rounding."""
        per_ctx: Dict = {}
        order: List = []
        for v in vlist:
            c = v.context
            if c in per_ctx:
                per_ctx[c] = per_ctx[c] + v._data
            else:
                per_ctx[c] = v._data
                order.append(c)
        return [per_ctx[c] for c in order], tuple(order)

    def _reduce_flat(self, ctxs, bucket):
        """One stacked sum for one bucket: each context's tensors raveled
        and concatenated, the rows stacked on the first context's device
        and summed over the stack; each key's slice comes back there."""
        dev = bucket[0][1][0].device
        sizes = [locals_[0].numel() for _, locals_ in bucket]
        shapes = [locals_[0].shape for _, locals_ in bucket]
        rows = []
        for i in range(len(ctxs)):
            flat = torch.cat([locals_[i].detach().reshape(-1)
                              for _, locals_ in bucket]) \
                if len(bucket) > 1 else bucket[0][1][i].detach().reshape(-1)
            rows.append(flat.to(dev))
        reduced = torch.stack(rows).sum(dim=0, dtype=rows[0].dtype)
        spans = sum(c.device_type == "cpu" for c in ctxs) > 1
        with self._mu:
            self._buckets += 1
            self._collectives += spans
            self._reduced_bytes += reduced.numel() * reduced.element_size()
        off = 0
        for (k, _), sz, shape in zip(bucket, sizes, shapes):
            yield k, _tagged(NDArray(reduced[off:off + sz].view(shape)),
                             ctxs[0])
            off += sz

    def stats(self):
        """The buckets summed, the collectives among them and the bytes
        of the sums since construction."""
        with self._mu:
            return {"collectives": self._collectives,
                    "buckets": self._buckets,
                    "reduced_bytes": self._reduced_bytes}
