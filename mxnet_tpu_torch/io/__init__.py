"""IO API (port of ``mxnet_tpu/io/``): ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter``, ``ResizeIter``, ``PrefetchingIter``,
``DevicePrefetchIter``, ``ImageRecordIter``, ``CSVIter``, ``LibSVMIter``
and the iterator registry."""
from .io import *
from .io import DataDesc, DataBatch, DataIter, NDArrayIter, ResizeIter
