"""Generated ``nd`` namespace: one function per registered op.

Port of ``mxnet_tpu/ndarray/register.py``: a stub takes NDArrays first
(a list of them is spread, as the reference's variadic calls pass
``*[w, g, m] * n``), then positional attributes, keyword attributes and
``out=``.
"""
from __future__ import annotations

from ..base import not_ported
from ..ops import registry as _registry
from .ndarray import NDArray


def _make_stub(op):
    def stub(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        if kwargs.pop("ctx", None) is not None:
            raise not_ported("ctx= on an op call (creation ops)",
                             "mxnet_tpu.ops.registry.invoke ctx=")
        flat = []
        for a in args:
            if isinstance(a, (list, tuple)) and a and \
                    all(isinstance(x, NDArray) for x in a):
                flat.extend(a)
            else:
                flat.append(a)
        arrays, pos_attrs = [], []
        for a in flat:
            if isinstance(a, NDArray) and not pos_attrs:
                arrays.append(a)
            else:
                pos_attrs.append(a)
        return _registry.invoke(op, arrays, tuple(pos_attrs), kwargs,
                                out=out)

    stub.__name__ = op.name
    stub.__doc__ = op.doc
    return stub


def populate(namespace: dict):
    """Install a stub for every registered op into ``namespace``."""
    for name in _registry.list_ops():
        if name not in namespace:
            namespace[name] = _make_stub(_registry.get_op(name))
