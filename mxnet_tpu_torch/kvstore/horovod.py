"""The Horovod-style allreduce store (type ``horovod``).

Port of ``mxnet_tpu/kvstore/horovod.py``: a stateless backend whose API
is ``broadcast`` and ``pushpull`` (a combined allreduce), registered
through the public ``KVStoreBase`` registry.  In one process its
allreduce is the ``device`` store's sum over the caller's value list.
On a job of several processes (``parallel.multihost``) it refuses, as
the reference does: a sum over one process's values would let each
process's gradients drift apart.
"""
from __future__ import annotations

from ..base import MXNetError
from .kvstore import KVStoreBase, one_card


@KVStoreBase.register("horovod")
class HorovodKVStore:
    """Allreduce-semantics store: stateless, no weights on a server."""

    def __init__(self):
        self.type = "horovod"
        self._pending = None
        self._check_scope()

    @staticmethod
    def _refuse_multiprocess(nproc: int):
        raise MXNetError(
            "kvstore 'horovod' is single-process scope in this "
            "framework (local-device allreduce only); on a %d-process "
            "job use kvstore 'dist_sync' or the GSPMD "
            "DataParallelTrainer, whose collectives span processes"
            % nproc)

    def _check_scope(self):
        """Refuse a job of several processes (``multihost``)."""
        from ..parallel import multihost
        if multihost.is_initialized() and multihost.num_hosts() > 1:
            self._refuse_multiprocess(multihost.num_hosts())

    @property
    def rank(self) -> int:
        from ..parallel import multihost
        return multihost.rank() if multihost.is_initialized() else 0

    @property
    def num_workers(self) -> int:
        from ..parallel import multihost
        return multihost.num_hosts() if multihost.is_initialized() else 1

    def broadcast(self, key, value, out=None, priority=0):
        """The root's value into every ``out`` replica (reference
        ``KVStoreHorovod.broadcast``)."""
        self._check_scope()
        if out is None:
            return value
        outs = out if isinstance(out, (list, tuple)) else [out]
        one_card(outs + [value])
        for o in outs:
            o._set_data(value.as_in_context(o.context)._data)
        return out

    def pushpull(self, key, value, out=None, priority=0):
        """Sum the values left to right and give every ``out`` replica
        the sum (reference ``KVStoreHorovod.pushpull``, an allreduce
        without averaging)."""
        self._check_scope()
        vals = value if isinstance(value, (list, tuple)) else [value]
        if not vals:
            raise MXNetError("pushpull: empty value list")
        outs = [] if out is None else \
            (out if isinstance(out, (list, tuple)) else [out])
        one_card(list(vals) + list(outs))
        reduced = vals[0]
        for v in vals[1:]:
            reduced = reduced + v.as_in_context(reduced.context)
        if out is None:
            return reduced
        for o in outs:
            o._set_data(reduced.as_in_context(o.context)._data)
        return out

    # the classic API, so Trainer-style callers keep working
    def init(self, key, value):
        return None

    def push(self, key, value, priority=0):
        self._pending = (key, value)

    def pull(self, key, out=None, priority=0):
        if self._pending is None or self._pending[0] != key:
            raise MXNetError(
                "horovod backend: pull(%r) without a matching push — "
                "use pushpull (allreduce semantics, no server state)"
                % (key,))
        key, value = self._pending
        self._pending = None
        return self.pushpull(key, value, out=out)

    @staticmethod
    def is_capable(capability: str) -> bool:
        return capability.lower() in ("dist_sync",)
