"""Framework utilities: the NumPy-semantics switch.

Port of ``mxnet_tpu/util.py``.  Both array types share one substrate
(``mx.np.ndarray`` is an ``NDArray`` subclass), so the switch records
which flavor the caller asked for; classic and numpy arrays always mix.
The switch is per thread.
"""
from __future__ import annotations

import functools
import threading

_state = threading.local()


def is_np_array() -> bool:
    """True when the np-array semantics switch is on (reference:
    ``mx.util.is_np_array``)."""
    return getattr(_state, "np_array", False)


def is_np_shape() -> bool:
    """Zero-dim and zero-size shape semantics: always on (torch has
    them)."""
    return True


def set_np(shape=True, array=True):
    """Enable NumPy semantics (reference: ``mx.npx.set_np``)."""
    _state.np_array = bool(array)


def reset_np():
    """Disable NumPy semantics (reference: ``mx.npx.reset_np``)."""
    _state.np_array = False


def set_np_shape(active=True):
    return True


class _NumpyArrayScope:
    def __init__(self, is_np):
        self._is_np = is_np
        self._old = None

    def __enter__(self):
        self._old = is_np_array()
        _state.np_array = self._is_np
        return self

    def __exit__(self, *args):
        _state.np_array = self._old


def np_array(active=True):
    """Context manager scoping the np-array switch."""
    return _NumpyArrayScope(active)


def use_np(func):
    """Decorator running ``func`` (or all methods of a class) under np
    semantics (reference: ``@mx.util.use_np``)."""
    if isinstance(func, type):
        # class decorator: wrap callable attributes
        for name in ("forward", "hybrid_forward", "__call__"):
            if name in func.__dict__:
                setattr(func, name, use_np(func.__dict__[name]))
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with _NumpyArrayScope(True):
            return func(*args, **kwargs)
    return wrapper


def use_np_array(func):
    return use_np(func)


def wrap_np_unary_func(func):
    return func


def wrap_np_binary_func(func):
    return func


def get_cuda_compute_capability(ctx):
    """The card's compute capability as an int (90 for an H100), None
    for a CPU context."""
    if ctx.device_type != "gpu":
        return None
    import torch
    major, minor = torch.cuda.get_device_capability(ctx.device_id)
    return major * 10 + minor
