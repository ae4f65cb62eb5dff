"""Gluon utilities: ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1`` and ``download``.

Port of ``mxnet_tpu/gluon/utils.py``, function for function.
"""
from __future__ import annotations

import hashlib
import math
import warnings

from ..base import MXNetError
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` cut into ``num_slice`` slices along ``batch_axis`` (the
    last takes the remainder unless ``even_split`` refuses one)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    return [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, one slice on each context of
    ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their global 2-norm is at most
    ``max_norm``.  The norm is read on the host once (the reference
    does, ``utils.py:58``), warning when it is not finite; returns it as
    a float, or as an NDArray when ``check_isfinite`` is false."""
    assert len(arrays) > 0
    ctx = arrays[0].context

    def _norm(array):
        x = array.reshape((-1,))
        return nd.dot(x, x)

    total_norm = nd.sqrt(nd.add_n(*[_norm(arr).as_in_context(ctx)
                                    for arr in arrays]))
    total = float(total_norm.asscalar())
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total if check_isfinite else total_norm


def check_sha1(filename, sha1_hash):
    """True when the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for block in iter(lambda: f.read(1048576), b""):
            sha1.update(block)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Refused, as in the reference (``utils.py:85``): the package
    fetches nothing over the network; place the file locally."""
    raise MXNetError("download is not supported: place files locally "
                     "instead of downloading.")
