"""``mx.sym``: the symbolic (lazy graph) namespace.

Port of ``mxnet_tpu/symbol/__init__.py``: one ``sym.<Op>`` stub for
every op of the port's registry (the one that serves ``nd``), plus
``Variable``/``var``, ``Group``, ``zeros``/``ones``, ``sym.contrib``
(the ``_contrib_*`` ops by their short names),
``load``/``load_json``, the
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


def zeros(shape, dtype="float32", name=None, **kw):
    """A graph node of zeros of ``shape``."""
    from .symbol import _apply_op
    return _apply_op("_zeros", [], {"shape": tuple(shape), "dtype": dtype},
                     name=name)


def ones(shape, dtype="float32", name=None, **kw):
    """A graph node of ones of ``shape``."""
    from .symbol import _apply_op
    return _apply_op("_ones", [], {"shape": tuple(shape), "dtype": dtype},
                     name=name)


class _SymContrib:
    """``sym.contrib``: a stub for each ``_contrib_*`` op, by its short
    name."""


contrib = _SymContrib()


def _populate_sym_contrib():
    from ..ops import registry as _registry
    from .symbol import _make_sym_stub
    for _name in _registry.list_ops():
        if _name.startswith("_contrib_"):
            _short = _name[len("_contrib_"):]
            if not hasattr(contrib, _short):
                setattr(contrib, _short, _make_sym_stub(
                    _registry.get_op(_name)))


_populate_sym_contrib()


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("sym.%s" % name, "mxnet_tpu.symbol / mxnet_tpu.ops")
