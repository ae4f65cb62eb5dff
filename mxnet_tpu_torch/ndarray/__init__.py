"""``mx.nd``: the imperative NDArray API.

Port of ``mxnet_tpu/ndarray/__init__.py``: the creation functions, the
``.params`` container and one function per registered op.  A name the
reference has and the port does not raises ``NotImplementedError``.
"""
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concat, stack, from_numpy, save, load, waitall)
from . import ndarray as _ndmod
from . import register as _register
from .. import ops as _ops  # noqa: F401  (fills the registry)
from ..base import not_ported as _not_ported

_register.populate(globals())
_ndmod._install_methods()
from . import contrib  # noqa: E402,F401
from . import sparse  # noqa: E402,F401  (row_sparse / csr storage types)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    from ..ops.registry import get_op, invoke
    return invoke(get_op("_eye"), [], attrs={"N": N, "M": M, "k": k,
                                             "dtype": dtype}, ctx=ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    from ..ops.registry import get_op, invoke
    return invoke(get_op("_linspace"), [],
                  attrs={"start": start, "stop": stop, "num": num,
                         "endpoint": endpoint, "dtype": dtype}, ctx=ctx)


def zeros_like(data, **kw):
    from ..ops.registry import get_op, invoke
    return invoke(get_op("zeros_like"), [data])


def ones_like(data, **kw):
    from ..ops.registry import get_op, invoke
    return invoke(get_op("ones_like"), [data])


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("nd.%s" % name, "mxnet_tpu.ndarray / mxnet_tpu.ops")
