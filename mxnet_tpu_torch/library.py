"""Extension libraries: ``mx.library.load``.

Port of ``mxnet_tpu/library.py`` (upstream ``python/mxnet/library.py``,
``MXLoadLib``): register operators and passes from outside the framework
without rebuilding it.

* a **Python extension** (a ``.py`` file or an importable module name)
  is executed and may call ``mxnet_tpu_torch.ops.registry.register`` or
  the Gluon API directly;
* a **native extension** (``.so``) is opened with ``ctypes`` and its
  exported ``MXTPULibInit(void)`` hook, the reference's name for
  upstream's ``initialize(int version)``, is called and must return 0.
"""
from __future__ import annotations

import ctypes
import importlib
import importlib.util
import logging
import os
import sys

from .base import MXNetError

__all__ = ["load", "loaded_libs"]

LIB_API_VERSION = 1

_loaded = {}


def _load_native(path):
    if not os.path.exists(path):
        raise MXNetError("extension library not found: %r" % path)
    try:
        handle = ctypes.CDLL(path, ctypes.RTLD_LOCAL)
    except OSError as e:
        raise MXNetError("cannot dlopen %r: %s" % (path, e))
    init = getattr(handle, "MXTPULibInit", None)
    if init is None:
        raise MXNetError("%r exports no MXTPULibInit: not an extension "
                         "library" % path)
    init.restype = ctypes.c_int
    init.argtypes = []
    ret = init()
    if ret != 0:
        raise MXNetError("MXTPULibInit(%r) failed with code %d" % (path, ret))
    return handle


def _load_python(path):
    if not os.path.exists(path):
        raise MXNetError("extension library not found: %r" % path)
    name = "_mxtorch_ext_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    handle = importlib.util.module_from_spec(spec)
    sys.modules[name] = handle
    try:
        spec.loader.exec_module(handle)
    except Exception as e:
        sys.modules.pop(name, None)
        raise MXNetError("error executing extension %r: %s" % (path, e))
    return handle


def load(path, verbose=True):
    """Load an extension library (upstream ``mx.library.load``).

    ``path``: a ``.py`` file, an importable module name or a native
    ``.so``.  Returns the module (Python) or the ``ctypes.CDLL``
    (native); loading the same path again returns the same handle."""
    if path in _loaded:
        return _loaded[path]
    if path.endswith(".so"):
        handle = _load_native(path)
    elif path.endswith(".py"):
        handle = _load_python(path)
    else:
        try:
            handle = importlib.import_module(path)
        except ImportError as e:
            raise MXNetError("cannot import extension module %r: %s"
                             % (path, e))
    _loaded[path] = handle
    if verbose:
        logging.getLogger("mxnet_tpu_torch").info("loaded library %r", path)
    return handle


def loaded_libs():
    """Paths or names of the extensions loaded so far."""
    return list(_loaded)
