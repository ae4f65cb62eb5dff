"""``mx.sym``: the symbolic (lazy graph) namespace.

Port of ``mxnet_tpu/symbol/__init__.py``: one ``sym.<Op>`` stub for
every op of the port's registry (the one that serves ``nd``), plus
``Variable``/``var``, ``Group``, ``load``/``load_json``, the
``Executor`` and the graph ``passes``.  An op the reference has and the
port does not raises ``NotImplementedError``.
"""
from .. import ops as _ops  # noqa: F401  (fills the registry)
from ..base import not_ported as _not_ported
from .symbol import (Symbol, Variable, var, Group, load, load_json,
                     populate as _populate)
from .executor import Executor
from . import passes

_populate(globals())


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("sym.%s" % name, "mxnet_tpu.symbol / mxnet_tpu.ops")
