"""Reductions with MXNet's axis semantics.

Port of ``sum`` and ``mean`` from ``mxnet_tpu/ops/reduce.py``:
``axis=None`` reduces every axis, ``keepdims`` keeps them as size 1, and
``exclude=True`` reduces every axis except the given ones.
"""
from __future__ import annotations

import torch

from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None:
        ax = None
    elif isinstance(axis, int):
        ax = (axis,)
    else:
        ax = tuple(axis)
    if ax is not None:
        ax = tuple(a % ndim for a in ax)
    if exclude:
        ax = tuple(sorted(set(range(ndim)) - set(ax or ())))
    return ax


def _reduce(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def impl(data, axis=None, keepdims=False, exclude=False, **kw):
        ax = _norm_axis(axis, data.dim(), exclude)
        if ax is None:
            ax = tuple(range(data.dim()))
        if not ax:
            return data
        return fn(data, dim=ax, keepdim=bool(keepdims))
    impl.__name__ = name
    return impl


_reduce("sum", torch.sum, aliases=("sum_axis",))
_reduce("mean", torch.mean)
