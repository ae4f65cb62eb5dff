"""Elementwise arithmetic: ``negative``, ``square``, the binary ops with
broadcasting, and the scalar ops behind NDArray's Python operators.

Port of the arithmetic of ``mxnet_tpu/ops/elemwise.py``, what NDArray's
operators, ResNet and the losses call.
"""
from __future__ import annotations

import torch

from .registry import register


@register("negative")
def negative(data, **kw):
    return -data


@register("square")
def square(data, **kw):
    return data * data


def _binary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def impl(lhs, rhs, **kw):
        return fn(lhs, rhs)
    impl.__name__ = name
    return impl


_binary("broadcast_add", lambda a, b: a + b,
        aliases=("elemwise_add", "_plus", "_add", "broadcast_plus"))
_binary("broadcast_sub", lambda a, b: a - b,
        aliases=("elemwise_sub", "_sub", "_minus", "broadcast_minus"))
_binary("broadcast_mul", lambda a, b: a * b,
        aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", lambda a, b: a / b,
        aliases=("elemwise_div", "_div"))


def _tc(x, s):
    """The scalar in the array's type (reference ``_tc``): an integral
    float stays an int for an integer array, else the array's dtype."""
    if x.is_floating_point():
        return s
    if float(s) == int(s):
        return int(s)
    return torch.tensor(s, dtype=x.dtype, device=x.device)


def _scalar(name, fn):
    @register(name)
    def impl(data, scalar=0.0, **kw):
        return fn(data, _tc(data, scalar))
    impl.__name__ = name
    return impl


_scalar("_plus_scalar", lambda x, s: x + s)
_scalar("_minus_scalar", lambda x, s: x - s)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", lambda x, s: x * s)
_scalar("_div_scalar", lambda x, s: x / s)
_scalar("_rdiv_scalar", lambda x, s: s / x)
