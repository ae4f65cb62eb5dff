"""Elementwise and broadcast ops: the unary math functions, the binary
ops with broadcasting, comparisons and logic (``no_grad``, in the
array's dtype), the scalar ops behind NDArray's and Symbol's Python
operators, ``clip``, ``where``, ``add_n``, ``BlockGrad``, ``Cast``,
``amp_cast``/``amp_multicast`` and the finiteness checks.

Port of ``mxnet_tpu/ops/elemwise.py``, name for name.  Rounding follows
the reference's numpy functions: ``round`` and ``rint`` round half to
even, ``fix`` toward zero.  ``gamma`` is ``exp(gammaln(x))`` as there.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _dtype(name):
    """The torch dtype of a dtype name, numpy dtype or torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    name = str(name)
    if isinstance(getattr(torch, name, None), torch.dtype):
        return getattr(torch, name)
    return torch.from_numpy(np.zeros(0, np.dtype(name))).dtype


class _ZeroGrad(torch.autograd.Function):
    """``fn(*xs)`` with a zero gradient for every tensor of ``xs``: an
    output that the reference computes through a bool cast or a
    rounding, which it differentiates to zero."""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.specs = [(x.shape, x.dtype, x.device)
                     if isinstance(x, torch.Tensor) else None for x in xs]
        return fn(*xs)

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(
            None if s is None else torch.zeros(s[0], dtype=s[1],
                                               device=s[2])
            for s in ctx.specs)


def zero_grad(fn, *xs):
    """``fn(*xs)``, differentiable with a zero gradient where autograd
    records (see :class:`_ZeroGrad`)."""
    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in xs):
        return _ZeroGrad.apply(fn, *xs)
    return fn(*xs)


def _unary(name, fn, aliases=(), no_grad=False):
    @register(name, aliases=aliases, no_grad=no_grad)
    def impl(data, **kw):
        return fn(data)
    impl.__name__ = name
    return impl


def sqrt(x):
    """Correctly rounded square root.  torch's vectorized float32 sqrt on
    the CPU is off by one ulp in about 0.5% of elements; there it is
    taken in float64 and rounded, as IEEE (the card's ``sqrtf``, XLA)
    has it."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _cbrt(x):
    return torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)


_unary("negative", lambda x: -x)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("square", lambda x: x * x)
_unary("sqrt", sqrt)
_unary("rsqrt", lambda x: 1.0 / sqrt(x))
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("expm1", torch.expm1)
_unary("log", torch.log)
_unary("log2", torch.log2)
_unary("log10", torch.log10)
_unary("log1p", torch.log1p)
_unary("reciprocal", lambda x: 1.0 / x)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", torch.rad2deg)
_unary("radians", torch.deg2rad)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("trunc", torch.trunc)
_unary("rint", torch.round)
_unary("round", torch.round)
_unary("fix", torch.trunc)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("relu", lambda x: torch.clamp(x, min=0))
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (1 + x.abs()))
_unary("hard_sigmoid", lambda x: torch.clamp(0.2 * x + 0.5, 0, 1))
_unary("logical_not", lambda x: zero_grad(
    lambda t: (t == 0).to(t.dtype), x))
_unary("identity", lambda x: x, aliases=("_copy",))
_unary("erfc", torch.erfc)
_unary("digamma", torch.digamma)


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data, **kw):
    return data.detach()


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
              **kw):
    return data * grad_scale if grad_scale != 1.0 else data


@register("clip")
def clip(data, a_min=None, a_max=None, **kw):
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


@register("smooth_l1")
def smooth_l1(data, scalar=1.0, **kw):
    s2 = scalar * scalar
    return torch.where(data.abs() < 1.0 / s2, 0.5 * s2 * data * data,
                       data.abs() - 0.5 / s2)


@register("Cast", aliases=("cast",))
def cast(data, dtype="float32", **kw):
    return data.to(_dtype(dtype))


@register("amp_cast")
def amp_cast(data, dtype="float32", **kw):
    """The cast ``contrib.amp.convert_symbol`` inserts."""
    return data.to(_dtype(dtype))


@register("amp_multicast", variadic=True, num_outputs=-1)
def amp_multicast(data, num_outputs=None, cast_narrow=False, **kw):
    """Every input cast to the widest (``cast_narrow``: the narrowest)
    of their float types, the first of equal width winning."""
    widths = [d.element_size() for d in data]
    pick = int(np.argmin(widths)) if cast_narrow else int(np.argmax(widths))
    return tuple(d.to(data[pick].dtype) for d in data)


def _binary(name, fn, aliases=(), no_grad=False):
    @register(name, aliases=aliases, no_grad=no_grad)
    def impl(lhs, rhs, **kw):
        return fn(lhs, rhs)
    impl.__name__ = name
    return impl


def _cmp(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _logic(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_binary("broadcast_add", lambda a, b: a + b,
        aliases=("elemwise_add", "_plus", "_add", "broadcast_plus"))
_binary("broadcast_sub", lambda a, b: a - b,
        aliases=("elemwise_sub", "_sub", "_minus", "broadcast_minus"))
_binary("broadcast_mul", lambda a, b: a * b,
        aliases=("elemwise_mul", "_mul"))
_binary("broadcast_div", lambda a, b: a / b,
        aliases=("elemwise_div", "_div"))
_binary("broadcast_mod", torch.remainder, aliases=("_mod",))
_binary("broadcast_power", torch.pow, aliases=("_power", "pow"))
_binary("_broadcast_floordiv", lambda a, b: _floordiv(a, b))
_binary("broadcast_maximum", torch.maximum, aliases=("_maximum", "maximum"))
_binary("broadcast_minimum", torch.minimum, aliases=("_minimum", "minimum"))
_binary("broadcast_hypot", torch.hypot)
_binary("arctan2", torch.atan2)
_binary("broadcast_equal", _cmp(torch.eq), aliases=("_equal",),
        no_grad=True)
_binary("broadcast_not_equal", _cmp(torch.ne), aliases=("_not_equal",),
        no_grad=True)
_binary("broadcast_greater", _cmp(torch.gt), aliases=("_greater",),
        no_grad=True)
_binary("broadcast_greater_equal", _cmp(torch.ge),
        aliases=("_greater_equal",), no_grad=True)
_binary("broadcast_lesser", _cmp(torch.lt), aliases=("_lesser",),
        no_grad=True)
_binary("broadcast_lesser_equal", _cmp(torch.le),
        aliases=("_lesser_equal",), no_grad=True)
_binary("broadcast_logical_and", _logic(torch.logical_and), no_grad=True)
_binary("broadcast_logical_or", _logic(torch.logical_or), no_grad=True)
_binary("broadcast_logical_xor", _logic(torch.logical_xor), no_grad=True)
_binary("_npi_matmul", torch.matmul, aliases=("matmul",))


def _floordiv(a, b):
    """``floor(a / b)`` as numpy computes it, with the reference's zero
    gradient (torch gives ``floor_divide`` none)."""
    return zero_grad(torch.floor_divide, a, b)


@register("add_n", aliases=("ElementWiseSum", "_sum"), variadic=True)
def add_n(args, **kw):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


def _tc(x, s):
    """The scalar in the array's type (reference ``_tc``): an integral
    float stays an int for an integer array, else the array's dtype."""
    if x.is_floating_point():
        return s
    if float(s) == int(s):
        return int(s)
    return torch.tensor(s, dtype=x.dtype, device=x.device)


def _scalar(name, fn, no_grad=False, typed=True):
    @register(name, no_grad=no_grad)
    def impl(data, scalar=0.0, **kw):
        return fn(data, _tc(data, scalar) if typed else scalar)
    impl.__name__ = name
    return impl


_scalar("_plus_scalar", lambda x, s: x + s)
_scalar("_minus_scalar", lambda x, s: x - s)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", lambda x, s: x * s)
_scalar("_div_scalar", lambda x, s: x / s)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_mod_scalar", torch.remainder)
_scalar("_rmod_scalar", lambda x, s: torch.remainder(
    torch.as_tensor(s, dtype=x.dtype, device=x.device), x))
_scalar("_power_scalar", lambda x, s: torch.pow(x, s))
_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar("_floordiv_scalar", lambda x, s: _floordiv(
    x, torch.as_tensor(s, dtype=x.dtype, device=x.device)))
_scalar("_maximum_scalar", lambda x, s: torch.clamp(x, min=s))
_scalar("_minimum_scalar", lambda x, s: torch.clamp(x, max=s))
_scalar("_equal_scalar", _cmp(torch.eq), no_grad=True, typed=False)
_scalar("_not_equal_scalar", _cmp(torch.ne), no_grad=True, typed=False)
_scalar("_greater_scalar", _cmp(torch.gt), no_grad=True, typed=False)
_scalar("_greater_equal_scalar", _cmp(torch.ge), no_grad=True, typed=False)
_scalar("_lesser_scalar", _cmp(torch.lt), no_grad=True, typed=False)
_scalar("_lesser_equal_scalar", _cmp(torch.le), no_grad=True, typed=False)


@register("where")
def where(condition, x, y, **kw):
    return torch.where(condition != 0, x, y)


@register("all_finite")
def all_finite(data, init_output=True, **kw):
    return torch.isfinite(data).all().reshape(1).float()


@register("multi_all_finite", variadic=True)
def multi_all_finite(data, num_arrays=None, init_output=True, **kw):
    ok = torch.ones((), dtype=torch.bool, device=data[0].device)
    for d in data:
        ok = ok & torch.isfinite(d).all()
    return ok.reshape(1).float()


@register("isnan", no_grad=True)
def isnan(data, **kw):
    return torch.isnan(data).float()


@register("isinf", no_grad=True)
def isinf(data, **kw):
    return torch.isinf(data).float()


@register("isfinite", no_grad=True)
def isfinite(data, **kw):
    return torch.isfinite(data).float()
