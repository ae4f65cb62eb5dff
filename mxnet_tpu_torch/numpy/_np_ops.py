"""NumPy-semantics operators (the ``_np_*`` registry namespace).

Port of ``mxnet_tpu/numpy/_np_ops.py``.  The reference's impls are
``jax.numpy`` calls run without x64, so its results follow jnp's dtype
rules, not NumPy's and not torch's: a sum or cumulative sum of an
integer or bool array is int32, a mean, std or var of one float32,
index outputs (``argsort``, ``nonzero``, ``searchsorted``, ...) int32,
and an integer input to a transcendental function becomes float32.
The impls here are torch functions that keep those dtypes; a float64
input stays float64 (the port has float64, the reference turns it into
float32).  ``_np_reshape`` and the axis arguments follow NumPy, not
MXNet's reshape codes.  Every op registers under the reference's name,
with its ``no_grad``, ``variadic`` and output count, so autograd, AMP
and hybridize reach them through the one ``invoke``.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops.elemwise import _dtype
from ..ops.registry import creation_device, register

# --------------------------------------------------------------- helpers --

def _is_float(t):
    return t.is_floating_point() or t.is_complex()


def _flt(x):
    """``x`` as a float tensor: jnp turns an integer or bool input of a
    transcendental function into float32."""
    return x if _is_float(x) else x.to(torch.float32)


def _acc_int(t):
    """The dtype jnp accumulates integers in without x64: int32 (int64
    stays int64 here: the port has it)."""
    return torch.int64 if t.dtype == torch.int64 else torch.int32


def _pair(a, b):
    """Two operands of a binary op as tensors on one device; a Python
    number becomes a 0-dim tensor, which torch promotes as jnp does a
    weakly typed scalar (it does not widen the array's dtype)."""
    if not isinstance(a, torch.Tensor):
        a = torch.tensor(a, device=b.device)
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, device=a.device)
    return a, b


def _same(a, b):
    """Two operands promoted to one dtype (ops that refuse mixed ones)."""
    a, b = _pair(a, b)
    dt = torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim for a in axis)
    return (int(axis) % ndim,)


def _fold(x, ax):
    """``x`` with the axes ``ax`` folded into one last axis."""
    rest = [i for i in range(x.dim()) if i not in ax]
    return x.permute(rest + list(ax)).reshape(
        [x.shape[i] for i in rest] + [-1])


def _over_axes(fn, x, axis, keepdims):
    """``fn(t, dim=-1)`` over ``axis`` (None: every axis) of ``x``."""
    if x.dim() == 0:
        return fn(x.reshape(1), dim=-1).reshape(())
    ax = _axes(axis, x.dim())
    out = fn(_fold(x, ax), dim=-1)
    if keepdims:
        out = out.reshape([1 if i in ax else x.shape[i]
                           for i in range(x.dim())])
    return out


def _int32(t):
    return t.to(torch.int32)


# ------------------------------------------------------------ manipulation --

@register("_np_reshape")
def _np_reshape(a, newshape=None, order="C", **kw):
    shape = (newshape,) if isinstance(newshape, int) else tuple(newshape)
    if order == "F":
        rev = list(reversed(range(a.dim())))
        out = a.permute(rev).reshape(tuple(reversed(shape)))
        return out.permute(list(reversed(range(out.dim()))))
    return a.reshape(shape)


@register("_np_transpose")
def _np_transpose(a, axes=None, **kw):
    if axes is None:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*axes)


def _cat_dtype(seq):
    dt = seq[0].dtype
    for t in seq[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in seq]


@register("_np_concatenate", variadic=True)
def _np_concatenate(seq, axis=0, **kw):
    seq = _cat_dtype(list(seq))
    if axis is None:
        return torch.cat([t.reshape(-1) for t in seq])
    return torch.cat(seq, dim=axis)


@register("_np_stack", variadic=True)
def _np_stack(seq, axis=0, **kw):
    return torch.stack(_cat_dtype(list(seq)), dim=axis)


@register("_np_split", num_outputs=-1)
def _np_split(a, indices_or_sections=None, axis=0, **kw):
    if isinstance(indices_or_sections, int):
        if a.shape[axis] % indices_or_sections:
            raise MXNetError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(a, indices_or_sections, dim=axis))
    return tuple(torch.tensor_split(a, list(indices_or_sections), dim=axis))


@register("_np_pad")
def _np_pad(a, pad_width=None, mode="constant", constant_values=0, **kw):
    pw = _np.broadcast_to(_np.asarray(pad_width, dtype=_np.int64),
                          (a.dim(), 2))
    out = a
    if mode == "constant":
        cv = _np.broadcast_to(_np.asarray(constant_values), (a.dim(), 2))
        for i in range(a.dim()):
            parts = []
            for side in (0, 1):
                n = int(pw[i, side])
                if n:
                    shape = list(out.shape)
                    shape[i] = n
                    parts.append(torch.full(shape, cv[i, side].item(),
                                            dtype=out.dtype,
                                            device=out.device))
                else:
                    parts.append(None)
            out = torch.cat([p for p in (parts[0], out, parts[1])
                             if p is not None], dim=i)
        return out
    if mode not in ("edge", "reflect", "symmetric", "wrap"):
        raise MXNetError("pad: mode %r is not supported" % (mode,))
    for i in range(a.dim()):
        idx = _np.pad(_np.arange(out.shape[i]), tuple(pw[i]), mode=mode)
        out = torch.index_select(out, i, torch.as_tensor(
            idx, device=out.device))
    return out


@register("_np_moveaxis")
def _np_moveaxis(a, source=None, destination=None, **kw):
    return torch.movedim(a, source, destination)


@register("_np_rollaxis")
def _np_rollaxis(a, axis=0, start=0, **kw):
    n = a.dim()
    axis %= n
    if start < 0:
        start += n
    if axis < start:
        start -= 1
    idx = list(range(n))
    idx.remove(axis)
    idx.insert(start, axis)
    return a.permute(idx)


@register("_np_roll")
def _np_roll(a, shift=None, axis=None, **kw):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


@register("_np_rot90")
def _np_rot90(a, k=1, axes=(0, 1), **kw):
    return torch.rot90(a, k, tuple(axes))


@register("_np_flip")
def _np_flip(a, axis=None, **kw):
    return torch.flip(a, _axes(axis, a.dim()))


@register("_np_trace")
def _np_trace(a, offset=0, axis1=0, axis2=1, **kw):
    d = torch.diagonal(a, offset, axis1, axis2).sum(-1)
    return d.to(_acc_int(a)) if not _is_float(a) else d


@register("_np_tril")
def _np_tril(a, k=0, **kw):
    return torch.tril(a, k)


@register("_np_triu")
def _np_triu(a, k=0, **kw):
    return torch.triu(a, k)


@register("_np_diag")
def _np_diag(a, k=0, **kw):
    return torch.diag(a, k)


@register("_np_diagonal")
def _np_diagonal(a, offset=0, axis1=0, axis2=1, **kw):
    return torch.diagonal(a, offset, axis1, axis2)


# ------------------------------------------------------------------ linalg --

@register("_np_matmul")
def _np_matmul(a, b, **kw):
    return torch.matmul(*_same(a, b))


@register("_np_tensordot")
def _np_tensordot(a, b, axes=2, **kw):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return torch.tensordot(*_same(a, b), dims=axes)


@register("_np_einsum", variadic=True)
def _np_einsum(operands, subscripts=None, **kw):
    return torch.einsum(subscripts, *_cat_dtype(list(operands)))


@register("_np_outer")
def _np_outer(a, b, **kw):
    a, b = _same(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


@register("_np_inner")
def _np_inner(a, b, **kw):
    return torch.inner(*_same(a, b))


@register("_np_kron")
def _np_kron(a, b, **kw):
    return torch.kron(*_same(a, b))


@register("_np_vdot")
def _np_vdot(a, b, **kw):
    a, b = _same(a, b)
    return torch.dot(a.reshape(-1), b.reshape(-1))


@register("_np_cross")
def _np_cross(a, b, axis=-1, **kw):
    return torch.linalg.cross(*_same(a, b), dim=axis)


def _linalg(name, fn, num_outputs=1, no_grad=False):
    @register("_np_linalg_" + name, num_outputs=num_outputs, no_grad=no_grad)
    def impl(*arrays, **kw):
        return fn(*arrays, **{k: v for k, v in kw.items()
                              if k != "_training"})
    impl.__name__ = "_np_linalg_" + name
    return impl


def _norm(a, ord=None, axis=None, keepdims=False):
    a = _flt(a)
    if isinstance(axis, list):
        axis = tuple(axis)
    if ord is None and axis is None:
        out = torch.linalg.vector_norm(a.reshape(-1), 2)
        return out.reshape([1] * a.dim()) if keepdims else out
    return torch.linalg.norm(a, ord=ord, dim=axis, keepdim=keepdims)


_linalg("norm", _norm)
_linalg("inv", lambda a: torch.linalg.inv(a))
_linalg("det", lambda a: torch.linalg.det(a))
_linalg("slogdet", lambda a: tuple(torch.linalg.slogdet(a)), num_outputs=2)
_linalg("cholesky", lambda a: torch.linalg.cholesky(a))
_linalg("qr", lambda a: tuple(torch.linalg.qr(a, mode="reduced")),
        num_outputs=2)
_linalg("svd", lambda a: tuple(torch.linalg.svd(a, full_matrices=False)),
        num_outputs=3)
_linalg("eigh", lambda a: tuple(torch.linalg.eigh(a)), num_outputs=2)
_linalg("eigvalsh", lambda a: torch.linalg.eigvalsh(a))
_linalg("solve", lambda a, b: torch.linalg.solve(a, b))
_linalg("lstsq", lambda a, b: torch.linalg.pinv(a) @ b)
_linalg("pinv", lambda a: torch.linalg.pinv(a))
_linalg("matrix_rank", lambda a: _int32(torch.linalg.matrix_rank(a)),
        no_grad=True)
_linalg("matrix_power", lambda a, n=1: torch.linalg.matrix_power(a, n))


# -------------------------------------------------------------- reductions --

def _np_reduce(name, fn, no_grad=False):
    @register("_np_" + name, no_grad=no_grad)
    def impl(a, axis=None, keepdims=False, **kw):
        if isinstance(axis, list):
            axis = tuple(axis)
        return fn(a, axis, keepdims, kw)
    impl.__name__ = "_np_" + name
    return impl


def _sum(a, ax, kd, kw):
    dt = kw.get("dtype")
    if dt is not None:
        a = a.to(_dtype(dt))
    elif not _is_float(a):
        a = a.to(_acc_int(a))
    return torch.sum(a, dim=_axes(ax, a.dim()), keepdim=kd,
                     dtype=a.dtype) if a.dim() else a.clone()


def _mean(a, ax, kd, kw):
    dt = kw.get("dtype")
    a = a.to(_dtype(dt)) if dt is not None else _flt(a)
    return torch.mean(a, dim=_axes(ax, a.dim()), keepdim=kd) if a.dim() \
        else a.clone()


def _prod(a, ax, kd, kw):
    dt = kw.get("dtype")
    if dt is not None:
        a = a.to(_dtype(dt))
    elif not _is_float(a):
        a = a.to(_acc_int(a))
    return _over_axes(torch.prod, a, ax, kd).to(a.dtype)


def _var(a, ax, kd, kw, std=False):
    a = _flt(a)
    out = torch.var(a, dim=_axes(ax, a.dim()), correction=kw.get("ddof", 0),
                    keepdim=kd)
    return torch.sqrt(out) if std else out


def _median(x, dim):
    return torch.quantile(x, 0.5, dim=dim)


def _bool(a):
    return a if a.dtype == torch.bool else a != 0


_np_reduce("sum", _sum)
_np_reduce("mean", _mean)
_np_reduce("prod", _prod)
_np_reduce("max", lambda a, ax, kd, kw:
           torch.amax(a, dim=_axes(ax, a.dim()), keepdim=kd))
_np_reduce("min", lambda a, ax, kd, kw:
           torch.amin(a, dim=_axes(ax, a.dim()), keepdim=kd))
_np_reduce("std", lambda a, ax, kd, kw: _var(a, ax, kd, kw, std=True))
_np_reduce("var", _var)
_np_reduce("median", lambda a, ax, kd, kw:
           _over_axes(_median, _flt(a), ax, kd))
_np_reduce("all", lambda a, ax, kd, kw:
           _over_axes(torch.all, _bool(a), ax, kd), no_grad=True)
_np_reduce("any", lambda a, ax, kd, kw:
           _over_axes(torch.any, _bool(a), ax, kd), no_grad=True)
_np_reduce("nanmean", lambda a, ax, kd, kw:
           torch.nanmean(_flt(a), dim=_axes(ax, a.dim()), keepdim=kd))


@register("_np_average")
def _np_average(a, weights=None, axis=None, **kw):
    a = _flt(a)
    if weights is None:
        return torch.mean(a, dim=_axes(axis, a.dim()))
    w = weights.to(a.dtype)
    if w.dim() == 1 and a.dim() > 1:
        shape = [1] * a.dim()
        shape[axis % a.dim()] = -1
        w = w.reshape(shape)
    w = torch.broadcast_to(w, a.shape)
    ax = _axes(axis, a.dim())
    return torch.sum(a * w, dim=ax) / torch.sum(w, dim=ax)


def _cum(fn, a, axis, dtype):
    if dtype is not None:
        a = a.to(_dtype(dtype))
    elif not _is_float(a):
        a = a.to(_acc_int(a))
    if axis is None:
        a, axis = a.reshape(-1), 0
    return fn(a, dim=axis, dtype=a.dtype)


@register("_np_cumsum")
def _np_cumsum(a, axis=None, dtype=None, **kw):
    return _cum(torch.cumsum, a, axis, dtype)


@register("_np_cumprod")
def _np_cumprod(a, axis=None, dtype=None, **kw):
    return _cum(torch.cumprod, a, axis, dtype)


@register("_np_ptp", no_grad=True)
def _np_ptp(a, axis=None, keepdims=False, **kw):
    ax = _axes(axis, a.dim())
    return torch.amax(a, dim=ax, keepdim=keepdims) \
        - torch.amin(a, dim=ax, keepdim=keepdims)


# ---------------------------------------------------------- search / logic --

@register("_np_unique", no_grad=True, num_outputs=1)
def _np_unique(a, **kw):
    return torch.unique(a.reshape(-1), sorted=True)


@register("_np_nonzero", no_grad=True, num_outputs=-1)
def _np_nonzero(a, **kw):
    return tuple(_int32(ix) for ix in torch.nonzero(a.reshape(
        a.shape or (1,)), as_tuple=True))


@register("_np_bincount", no_grad=True)
def _np_bincount(a, minlength=0, **kw):
    return _int32(torch.bincount(a.reshape(-1).long(), minlength=minlength))


@register("_np_searchsorted", no_grad=True)
def _np_searchsorted(a, v, side="left", **kw):
    a, v = _same(a, v)
    return _int32(torch.searchsorted(a, v.contiguous(), side=side))


@register("_np_where")
def _np_where(cond, x, y, **kw):
    x, y = _pair(x, y)
    if not isinstance(cond, torch.Tensor):
        cond = torch.tensor(cond, device=x.device)
    return torch.where(_bool(cond), x, y)


@register("_np_meshgrid", variadic=True, num_outputs=-1)
def _np_meshgrid(seq, indexing="xy", **kw):
    return tuple(torch.meshgrid(*seq, indexing=indexing))


@register("_np_isclose", no_grad=True)
def _np_isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False, **kw):
    a, b = _same(a, b)
    if not _is_float(a):
        a, b = a.float(), b.float()
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


@register("_np_allclose", no_grad=True)
def _np_allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False, **kw):
    return torch.all(_np_isclose(a, b, rtol, atol, equal_nan))


@register("_np_array_equal", no_grad=True)
def _np_array_equal(a, b, **kw):
    a, b = _pair(a, b)
    if a.shape != b.shape:
        return torch.tensor(False, device=a.device)
    return torch.all(a == b)


# --------------------------------------------------------- missing elemwise --

def _np_binary(name, fn, no_grad=False):
    @register("_np_" + name, no_grad=no_grad)
    def impl(a, b, **kw):
        return fn(*_pair(a, b))
    impl.__name__ = "_np_" + name
    return impl


def _fmod(a, b):
    a, b = _same(a, b)
    return torch.fmod(a, b)


def _divmod(a, b):
    """jnp's ``divmod``: the truncated remainder, then one step of the
    divisor where its sign disagrees (floats: the quotient from the
    remainder; integers: floor division and Python's modulo)."""
    a, b = _same(a, b)
    if not _is_float(a):
        return (torch.div(a, b, rounding_mode="floor"),
                torch.remainder(a, b))
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return (torch.round(torch.where(ind, div - 1, div)),
            torch.where(ind, mod + b, mod))


def _heaviside(a, b):
    """0 below zero, 1 above, ``b`` at zero; differentiable in ``b``
    (torch's ``heaviside`` has no gradient)."""
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a),
                                   torch.broadcast_to(b, a.shape)))


def _flt_pair(a, b):
    a, b = _pair(a, b)
    dt = torch.result_type(a, b)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    return a.to(dt), b.to(dt)


_np_binary("floor_divide", lambda a, b: _divmod(a, b)[0])
_np_binary("fmod", _fmod)
_np_binary("arctan2", lambda a, b: torch.atan2(*_flt_pair(a, b)))
_np_binary("hypot", lambda a, b: torch.hypot(*_flt_pair(a, b)))
_np_binary("copysign", lambda a, b: torch.copysign(*_flt_pair(a, b)))
_np_binary("logaddexp", lambda a, b: torch.logaddexp(*_flt_pair(a, b)))
_np_binary("heaviside", lambda a, b: _heaviside(*_same(a, b)))
_np_binary("bitwise_and", lambda a, b: torch.bitwise_and(a, b),
           no_grad=True)
_np_binary("bitwise_or", lambda a, b: torch.bitwise_or(a, b),
           no_grad=True)
_np_binary("bitwise_xor", lambda a, b: torch.bitwise_xor(a, b),
           no_grad=True)
_np_binary("left_shift", lambda a, b: torch.bitwise_left_shift(a, b),
           no_grad=True)
_np_binary("right_shift", lambda a, b: torch.bitwise_right_shift(a, b),
           no_grad=True)


@register("_np_interp", no_grad=True)
def _np_interp(x, xp, fp, **kw):
    """jnp's ``interp``: the segment by ``searchsorted(side='right')``,
    clipped to the table; the end values outside it."""
    x, xp, fp = _flt(x), _flt(xp), _flt(fp)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + (delta / torch.where(dx == 0,
                                                     torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@register("_np_clip")
def _np_clip(a, a_min=None, a_max=None, **kw):
    if a_min is not None:
        a = torch.maximum(*_pair(a, a_min))
    if a_max is not None:
        a = torch.minimum(*_pair(a, a_max))
    return a


@register("_np_round")
def _np_round(a, decimals=0, **kw):
    if not _is_float(a):
        return a.clone()
    if decimals == 0:
        return torch.round(a)
    f = 10.0 ** decimals
    return torch.round(a * f) / f


@register("_np_nan_to_num")
def _np_nan_to_num(a, nan=0.0, posinf=None, neginf=None, **kw):
    return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


@register("_np_take")
def _np_take(a, indices, axis=None, mode="clip", **kw):
    if axis is None:
        a, axis = a.reshape(-1), 0
    n = a.shape[axis]
    if not isinstance(indices, torch.Tensor):
        indices = torch.tensor(indices, device=a.device)
    idx = indices.long()
    if mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise MXNetError("take: mode %r is not supported" % (mode,))
    out = torch.index_select(a, axis, idx.reshape(-1))
    shape = list(a.shape[:axis]) + list(idx.shape) + \
        list(a.shape[axis + 1:])
    return out.reshape(shape)


@register("_np_take_along_axis")
def _np_take_along_axis(a, indices, axis=None, **kw):
    if axis is None:
        return torch.take_along_dim(a.reshape(-1), indices.reshape(-1).long())
    return torch.take_along_dim(a, indices.long(), dim=axis)


@register("_np_repeat")
def _np_repeat(a, repeats=1, axis=None, **kw):
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


@register("_np_tile")
def _np_tile(a, reps=None, **kw):
    return torch.tile(a, (reps,) if isinstance(reps, int) else tuple(reps))


@register("_np_broadcast_to")
def _np_broadcast_to(a, shape=None, **kw):
    return torch.broadcast_to(a, tuple(shape))


@register("_np_expand_dims")
def _np_expand_dims(a, axis=0, **kw):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    n = a.dim() + len(axes)
    for ax in sorted(x % n for x in axes):
        a = a.unsqueeze(ax)
    return a


@register("_np_squeeze")
def _np_squeeze(a, axis=None, **kw):
    if axis is None:
        return a.squeeze()
    axes = _axes(axis, a.dim())
    for ax in axes:
        if a.shape[ax] != 1:
            raise MXNetError("cannot select an axis to squeeze out which "
                             "has size not equal to one")
    return a.squeeze(axes)


@register("_np_swapaxes")
def _np_swapaxes(a, axis1=0, axis2=1, **kw):
    return torch.swapaxes(a, axis1, axis2)


@register("_np_flatten")
def _np_ravel(a, **kw):
    return a.reshape(-1)


@register("_np_sort")
def _np_sort(a, axis=-1, **kw):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.sort(a, dim=axis, stable=True).values


@register("_np_argsort", no_grad=True)
def _np_argsort(a, axis=-1, **kw):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return _int32(torch.argsort(a, dim=axis, stable=True))


def _gradient_1d(f, axis):
    n = f.shape[axis]
    if n < 2:
        raise MXNetError("gradient: each axis needs at least 2 points")
    lo = f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)
    hi = f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)
    mid = (f.narrow(axis, 2, n - 2) - f.narrow(axis, 0, n - 2)) / 2
    return torch.cat([lo, mid, hi], dim=axis)


@register("_np_gradient", num_outputs=-1)
def _np_gradient(a, axis=None, **kw):
    a = _flt(a)
    axes = _axes(axis, a.dim())
    outs = tuple(_gradient_1d(a, ax) for ax in axes)
    return outs[0] if len(outs) == 1 else outs


def _quantile(a, q, axis, keepdims):
    a = _flt(a)
    qt = torch.as_tensor(_np.asarray(q, dtype=_np.float64),
                         device=a.device).to(a.dtype)
    if a.dim() == 0:
        a = a.reshape(1)
    ax = _axes(axis, a.dim())
    out = torch.quantile(_fold(a, ax), qt, dim=-1)
    if keepdims:
        shape = [1 if i in ax else a.shape[i] for i in range(a.dim())]
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@register("_np_percentile", no_grad=True)
def _np_percentile(a, q=None, axis=None, keepdims=False, **kw):
    return _quantile(a, _np.asarray(q, dtype=_np.float64) / 100.0, axis,
                     keepdims)


@register("_np_quantile", no_grad=True)
def _np_quantile(a, q=None, axis=None, keepdims=False, **kw):
    return _quantile(a, q, axis, keepdims)


@register("_np_cov")
def _np_cov(m, rowvar=True, bias=False, ddof=None, **kw):
    m = _flt(m)
    if m.dim() > 1 and not rowvar:
        m = m.t()
    corr = ddof if ddof is not None else (0 if bias else 1)
    return torch.cov(m, correction=corr)


@register("_np_histogram", no_grad=True, num_outputs=2)
def _np_histogram(a, bins=10, range=None, **kw):
    """jnp's ``histogram``: ``bins`` equal bins over ``range`` (the data's
    span, widened by 0.5 each side when it is a point), counts in the
    data's float dtype (jnp adds unit weights), the last edge inclusive."""
    a = _flt(a).reshape(-1)
    if range is None:
        lo, hi = float(a.min()), float(a.max())
    else:
        lo, hi = float(range[0]), float(range[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    edges = torch.linspace(lo, hi, bins + 1, dtype=a.dtype, device=a.device)
    idx = torch.searchsorted(edges, a.contiguous(), right=True)
    idx = torch.where(a == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.zeros(bins + 2, dtype=a.dtype, device=a.device)
    counts.index_add_(0, idx, torch.ones_like(a))
    return counts[1:bins + 1], edges


@register("_np_column_stack", variadic=True)
def _np_column_stack(seq, **kw):
    seq = _cat_dtype([t.reshape(-1, 1) if t.dim() < 2 else t for t in seq])
    return torch.cat(seq, dim=1)


@register("_np_digitize", no_grad=True)
def _np_digitize(x, bins, right=False, **kw):
    x, bins = _same(x, bins)
    inc = bins.shape[0] < 2 or bool(bins[-1] >= bins[0])
    if inc:
        return _int32(torch.searchsorted(bins, x.contiguous(),
                                         right=not right))
    rb = torch.flip(bins, (0,))
    n = bins.shape[0]
    return _int32(n - torch.searchsorted(rb, x.contiguous(), right=right))


@register("_np_diff")
def _np_diff(a, n=1, axis=-1, **kw):
    return torch.diff(a, n=n, dim=axis)


@register("_np_trapz")
def _np_trapz(y, dx=1.0, axis=-1, **kw):
    return torch.trapezoid(_flt(y), dx=dx, dim=axis)


@register("_np_ediff1d")
def _np_ediff1d(ary, **kw):
    return torch.diff(ary.reshape(-1))


# ------------------------------------------------------ generated long tail --

def _reg(name, fn, no_grad=False, num_outputs=1):
    def impl(*args, **kw):
        kw.pop("out", None)
        kw.pop("_training", None)
        return fn(*args, **kw)

    impl.__name__ = name
    impl.__doc__ = "NumPy-semantics %r" % name[len("_np_"):]
    register(name, no_grad=no_grad, num_outputs=num_outputs)(impl)


def _nanfill(a, fill):
    return torch.where(torch.isnan(a), torch.full_like(a, fill), a)


def _nanmax(a, axis=None, keepdims=False, sign=1):
    ax = _axes(axis, a.dim())
    fill = -math.inf if sign > 0 else math.inf
    red = torch.amax if sign > 0 else torch.amin
    out = red(_nanfill(a, fill), dim=ax, keepdim=keepdims)
    allnan = _over_axes(torch.all, torch.isnan(a), axis, keepdims)
    return torch.where(allnan, torch.full_like(out, math.nan), out)


def _nanvar(a, axis=None, ddof=0, keepdims=False, std=False):
    a = _flt(a)
    ax = _axes(axis, a.dim())
    ok = ~torch.isnan(a)
    cnt = ok.sum(dim=ax, keepdim=True).to(a.dtype)
    z = torch.where(ok, a, torch.zeros_like(a))
    mean = z.sum(dim=ax, keepdim=True) / cnt
    dev = torch.where(ok, a - mean, torch.zeros_like(a))
    out = (dev * dev).sum(dim=ax, keepdim=True) / torch.clamp(cnt - ddof,
                                                              min=0)
    if not keepdims:
        out = out.reshape([s for i, s in enumerate(a.shape) if i not in ax])
    return torch.sqrt(out) if std else out


def _nanarg(a, axis=None, sign=1):
    fill = -math.inf if sign > 0 else math.inf
    fn = torch.argmax if sign > 0 else torch.argmin
    x = _nanfill(_flt(a), fill)
    if axis is None:
        return _int32(fn(x.reshape(-1)))
    return _int32(fn(x, dim=axis))


def _angle(x):
    return torch.angle(_flt(x))


def _conv1d(a, v, mode, kind):
    """jnp's ``convolve``/``correlate`` of two 1-D arrays."""
    a, v = _flt_pair(a, v)
    if a.shape[0] < v.shape[0]:
        a, v = v, a
        swapped = True
    else:
        swapped = False
    if kind == "convolve":
        v = torch.flip(v, (0,))
    k = v.shape[0]
    if mode == "full":
        pad = (k - 1, k - 1)
    elif mode == "same":
        pad = (k // 2, k - 1 - k // 2)
    elif mode == "valid":
        pad = (0, 0)
    else:
        raise MXNetError("mode must be one of full, same, valid")
    out = F.conv1d(F.pad(a, pad).reshape(1, 1, -1), v.reshape(1, 1, -1))
    out = out.reshape(-1)
    if swapped and kind == "correlate":
        out = torch.flip(out, (0,))
    return out


def _unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = _flt(p)
    if discont is None:
        discont = period / 2
    dd = torch.diff(p, dim=axis)
    half = period / 2
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(torch.abs(dd) < discont, torch.zeros_like(dd),
                       ddmod - dd)
    first = p.narrow(axis, 0, 1)
    rest = p.narrow(axis, 1, p.shape[axis] - 1) + torch.cumsum(corr, axis)
    return torch.cat([first, rest], dim=axis)


def _vander(x, N=None, increasing=False):
    x = _flt(x)
    n = x.shape[0] if N is None else N
    iota = torch.arange(n, device=x.device)
    if not increasing:
        iota = torch.flip(iota, (0,))
    return torch.pow(x[..., None], iota.to(x.dtype))


def _spacing(x):
    x = _flt(x)
    to = torch.where(x < 0, torch.full_like(x, -math.inf),
                     torch.full_like(x, math.inf))
    return torch.nextafter(x, to) - x


def _window(name, M, beta=None):
    dev = creation_device()
    if M < 1:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    if M == 1:
        return torch.ones(1, dtype=torch.float32, device=dev)
    if name == "bartlett":
        n = torch.arange(1 - M, M, 2, device=dev).to(torch.float32)
        return torch.where(n <= 0, 1 + n / (M - 1), 1 - n / (M - 1))
    n = torch.arange(0, M, device=dev).to(torch.float32)
    if name == "kaiser":
        beta = torch.tensor(float(beta), dtype=torch.float32, device=dev)
        alpha = (M - 1) / 2.0
        return torch.special.i0(beta * torch.sqrt(
            1 - ((n - alpha) / alpha) ** 2)) / torch.special.i0(beta)
    c = torch.cos(2 * math.pi * n / (M - 1))
    if name == "blackman":
        return 0.42 - 0.5 * c + 0.08 * torch.cos(4 * math.pi * n / (M - 1))
    if name == "hamming":
        return 0.54 - 0.46 * c
    return 0.5 - 0.5 * c                          # hanning


def _tri(N, M=None, k=0, dtype=None):
    M = N if M is None else M
    dev = creation_device()
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return (j <= i + k).to(_dtype(dtype or "float32"))


def _indices(dimensions, dtype=None):
    dev = creation_device()
    grids = torch.meshgrid(*[torch.arange(d, device=dev)
                             for d in dimensions], indexing="ij")
    return torch.stack(grids).to(_dtype(dtype or "int32"))


def _ldexp(a, b):
    """``a * 2**b``, exact (torch's ``ldexp`` raises 2 to an integer
    exponent in integers, which is 0 below 0)."""
    a = _flt(a)
    return a * torch.pow(2.0, b.to(a.dtype))


def _modf(x):
    x = _flt(x)
    whole = torch.trunc(x)
    return x - whole, whole


def _float_power(a, b):
    a, b = _pair(a, b)
    wide = torch.float64 in (a.dtype, b.dtype)
    out = torch.float_power(a, b)
    return out if wide else out.to(torch.float32)


def _count_nonzero(a, axis=None, keepdims=False):
    out = _int32((a != 0).sum(dim=_axes(axis, a.dim()), keepdim=keepdims))
    return out


for _n, _f in [("real", lambda x: x.clone()),
               ("imag", lambda x: torch.zeros_like(x)),
               ("conj", lambda x: x.clone()),
               ("angle", _angle),
               ("sinc", lambda x: torch.sinc(_flt(x))),
               ("i0", lambda x: torch.special.i0(_flt(x))),
               ("deg2rad", lambda x: torch.deg2rad(_flt(x))),
               ("rad2deg", lambda x: torch.rad2deg(_flt(x))),
               ("positive", lambda x: x.clone()),
               ("fliplr", lambda x: torch.flip(x, (1,))),
               ("flipud", lambda x: torch.flip(x, (0,))),
               ("fmax", lambda a, b: torch.fmax(*_same(a, b))),
               ("fmin", lambda a, b: torch.fmin(*_same(a, b))),
               ("float_power", _float_power),
               ("ldexp", lambda a, b: _ldexp(*_pair(a, b))),
               ("logaddexp2", lambda a, b: torch.logaddexp2(
                   *_flt_pair(a, b))),
               ("nextafter", lambda a, b: torch.nextafter(*_flt_pair(a, b))),
               ("nanmax", lambda a, axis=None, keepdims=False:
                _nanmax(a, axis, keepdims, 1)),
               ("nanmin", lambda a, axis=None, keepdims=False:
                _nanmax(a, axis, keepdims, -1)),
               ("nanstd", lambda a, axis=None, ddof=0, keepdims=False:
                _nanvar(a, axis, ddof, keepdims, std=True)),
               ("nanvar", lambda a, axis=None, ddof=0, keepdims=False:
                _nanvar(a, axis, ddof, keepdims)),
               ("convolve", lambda a, v, mode="full":
                _conv1d(a, v, mode, "convolve")),
               ("correlate", lambda a, v, mode="valid":
                _conv1d(a, v, mode, "correlate")),
               ("unwrap", _unwrap),
               ("vander", _vander)]:
    _reg("_np_" + _n, _f)

for _n, _f in [("signbit", lambda x: torch.signbit(_flt(x))),
               ("gcd", lambda a, b: torch.gcd(*_same(a, b))),
               ("lcm", lambda a, b: torch.lcm(*_same(a, b))),
               ("nanargmax", lambda a, axis=None: _nanarg(a, axis, 1)),
               ("nanargmin", lambda a, axis=None: _nanarg(a, axis, -1)),
               ("count_nonzero", _count_nonzero),
               ("isin", lambda a, b, assume_unique=False, invert=False:
                torch.isin(*_same(a, b), assume_unique=assume_unique,
                           invert=invert)),
               ("argwhere", lambda a: _int32(torch.argwhere(a))),
               ("flatnonzero", lambda a: _int32(torch.nonzero(
                   a.reshape(-1)).reshape(-1))),
               ("tri", _tri),
               ("indices", _indices),
               ("spacing", _spacing)]:
    _reg("_np_" + _n, _f, no_grad=True)

for _n in ("bartlett", "blackman", "hamming", "hanning", "kaiser"):
    _reg("_np_" + _n, lambda M, *a, _w=_n, **kw: _window(_w, M, *a, **kw),
         no_grad=True)

# frexp's exponent is an integer: no_grad, as the reference's
_reg("_np_frexp", lambda x: tuple(torch.frexp(_flt(x))), num_outputs=2,
     no_grad=True)
_reg("_np_modf", _modf, num_outputs=2)
_reg("_np_divmod", lambda a, b: _divmod(a, b), num_outputs=2)


@register("_np_polyval")
def _np_polyval(p, x, **kw):
    p, x = _same(p, x)
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@register("_np_in1d", no_grad=True)
def _np_in1d(ar1, ar2, **kw):
    return torch.isin(*_same(ar1, ar2), **kw).reshape(-1)
