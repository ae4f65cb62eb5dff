"""``mx.mod``: the symbolic Module training API.

Port of ``mxnet_tpu/module/`` (upstream ``python/mxnet/module/``):
``BaseModule``, ``Module``, ``BucketingModule`` and
``SequentialModule``.
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from ..base import not_ported as _not_ported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("mod.%s" % name, "mxnet_tpu.module")
