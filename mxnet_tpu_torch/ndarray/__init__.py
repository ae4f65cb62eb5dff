"""``mx.nd``: the imperative NDArray API.

Port of ``mxnet_tpu/ndarray/__init__.py``: the creation functions, the
``.params`` container and one function per registered op.  A name the
reference has and the port does not raises ``NotImplementedError``.
"""
from .ndarray import NDArray, array, zeros, ones, save, load, waitall
from . import ndarray as _ndmod
from . import register as _register
from .. import ops as _ops  # noqa: F401  (fills the registry)
from ..base import not_ported as _not_ported

_register.populate(globals())
_ndmod._install_methods()


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("nd.%s" % name, "mxnet_tpu.ndarray / mxnet_tpu.ops")
