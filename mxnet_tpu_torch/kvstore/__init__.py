"""KVStore: the data-parallel gradient store.

Port of ``mxnet_tpu/kvstore/``: ``local``/``device``/``nccl``
(``kvstore.py``), ``ici`` (``ici.py``), ``horovod`` (``horovod.py``),
and ``dist_*`` through ``parallel/dist.py``.
"""
from .kvstore import KVStore, KVStoreBase, create  # noqa: F401
from . import horovod  # noqa: F401  (registers the allreduce backend)
from . import ici  # noqa: F401  (registers the bucketed store)
