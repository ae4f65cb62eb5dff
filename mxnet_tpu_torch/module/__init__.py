"""``mx.mod``: the symbolic Module training API.

Port of ``mxnet_tpu/module/`` (upstream ``python/mxnet/module/``):
``BaseModule``, ``Module`` and ``BucketingModule``.  ``SequentialModule``
is not ported yet (its reference test trains with Adam, which the port's
optimizer registry does not have; ``ROADMAP.md`` A.3).
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from ..base import not_ported as _not_ported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("mod.%s" % name, "mxnet_tpu.module")
