"""Elementwise arithmetic: ``negative``, ``square``, the unary math
ops, the binary ops with broadcasting, the scalar ops behind NDArray's
and Symbol's Python operators, ``BlockGrad``, ``Cast`` and ``amp_cast``.

Port of the arithmetic of ``mxnet_tpu/ops/elemwise.py``, what NDArray's
operators, ResNet, the losses and the Symbol graphs call.
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


def _unary(name, fn, aliases=()):
    @register(name, aliases=aliases)
    def impl(data, **kw):
        return fn(data)
    impl.__name__ = name
    return impl


_unary("abs", torch.abs)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("tanh", torch.tanh)
_unary("relu", lambda x: torch.clamp(x, min=0))
_unary("sigmoid", torch.sigmoid)
_unary("identity", lambda x: x, aliases=("_copy",))


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data, **kw):
    return data.detach()


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32", **kw):
    return data.to(_dtype(dtype))


@register("amp_cast")
def amp_cast(data, dtype="float32", **kw):
    """The cast ``contrib.amp.convert_symbol`` inserts."""
    return data.to(_dtype(dtype))


def _dtype(name):
    return getattr(torch, str(name))


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
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))


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
_scalar("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar("_maximum_scalar", lambda x, s: torch.clamp(x, min=s))
_scalar("_minimum_scalar", lambda x, s: torch.clamp(x, max=s))
