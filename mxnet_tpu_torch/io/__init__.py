"""IO API (port of ``mxnet_tpu/io/``): ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` and ``ResizeIter``."""
from .io import DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter
from ..base import not_ported as _not_ported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("io.%s" % name, "mxnet_tpu.io.io")
