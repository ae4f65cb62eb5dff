"""Generated ``nd`` namespace: one function per registered op.

Port of ``mxnet_tpu/ndarray/register.py``: a stub takes NDArrays first
(a list of them is spread, as the reference's variadic calls pass
``*[w, g, m] * n``), then positional attributes, keyword attributes,
``out=`` and ``ctx=`` (where an op that creates its tensors puts
them).
"""
from __future__ import annotations

import numpy as np

from ..ops import registry as _registry
from .ndarray import NDArray, _lead_ctx, array


def _make_stub(op):
    def stub(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        ctx = kwargs.pop("ctx", None)
        flat = []
        for a in args:
            if isinstance(a, (list, tuple)) and a and \
                    all(isinstance(x, NDArray) for x in a):
                flat.extend(a)
            else:
                flat.append(a)
        arrays, pos_attrs = [], []
        for a in flat:
            if isinstance(a, (NDArray, np.ndarray)) and not pos_attrs:
                arrays.append(a)
            else:
                pos_attrs.append(a)
        if any(isinstance(a, np.ndarray) for a in arrays):
            # a numpy operand (the reference's ops take one where they
            # take an array) becomes an array where the others lie
            at = _lead_ctx(arrays) or ctx or next(
                (a.context for a in arrays if isinstance(a, NDArray)),
                None)
            arrays = [array(a, ctx=at) if isinstance(a, np.ndarray) else a
                      for a in arrays]
        return _registry.invoke(op, arrays, tuple(pos_attrs), kwargs,
                                out=out, ctx=ctx)

    stub.__name__ = op.name
    stub.__doc__ = op.doc
    return stub


def populate(namespace: dict):
    """Install a stub for every registered op into ``namespace``."""
    for name in _registry.list_ops():
        if name not in namespace:
            namespace[name] = _make_stub(_registry.get_op(name))
