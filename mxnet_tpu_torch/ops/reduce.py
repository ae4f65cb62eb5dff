"""Reductions, sorting and top-k with MXNet's axis semantics.

Port of ``mxnet_tpu/ops/reduce.py``: ``axis=None`` reduces every axis,
``keepdims`` keeps them as size 1, and ``exclude=True`` reduces every
axis except the given ones.  ``argmax``/``argmin``/``argmax_channel``
return float32 indices, as the reference; ``sort``, ``argsort`` and
``topk`` flip an ascending result for ``is_ascend=False``; ``topk``
with ``ret_typ="mask"`` passes the incoming gradient to the selected
positions (the reference's scatter backward).
"""
from __future__ import annotations

import torch

from .elemwise import _dtype
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


def _over_one_axis(fn, x, ax, keepdim):
    """``fn(t, dim=-1)`` over the axes ``ax`` of ``x`` folded into one
    last axis (for torch reductions that take a single dim)."""
    rest = [i for i in range(x.dim()) if i not in ax]
    y = x.permute(rest + list(ax)).reshape(
        [x.shape[i] for i in rest] + [-1])
    out = fn(y, dim=-1)
    if keepdim:
        out = out.reshape([1 if i in ax else x.shape[i]
                           for i in range(x.dim())])
    return out


def _prod(x, dim, keepdim):
    return _over_one_axis(torch.prod, x, dim, keepdim)


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


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
_reduce("prod", _prod)
_reduce("max", torch.amax, aliases=("max_axis",))
_reduce("min", torch.amin, aliases=("min_axis",))
_reduce("nansum", torch.nansum)
_reduce("nanprod", _nanprod)


def _arg(fn, data, axis, keepdims):
    if axis is None:
        return fn(data.reshape(-1)).float()
    out = fn(data, dim=axis)
    if keepdims:
        out = out.unsqueeze(axis)
    return out.float()


@register("argmax", no_grad=True)
def argmax(data, axis=None, keepdims=False, **kw):
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", no_grad=True)
def argmin(data, axis=None, keepdims=False, **kw):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", no_grad=True)
def argmax_channel(data, **kw):
    return torch.argmax(data, dim=1).float()


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False, **kw):
    ax = _norm_axis(axis, data.dim())
    ax = tuple(range(data.dim())) if ax is None else ax
    if ord == 1:
        return data.abs().sum(dim=ax, keepdim=keepdims)
    return torch.sqrt((data * data).sum(dim=ax, keepdim=keepdims))


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance", **kw):
    if mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        ax = tuple(range(1, data.dim()))
    return data / torch.sqrt((data * data).sum(dim=ax, keepdim=True) + eps)


@register("sort")
def sort(data, axis=-1, is_ascend=True, **kw):
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.sort(data, dim=axis).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", no_grad=True)
def argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.argsort(data, dim=axis)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(_dtype(dtype))


class _TopkMask(torch.autograd.Function):
    """The 0/1 mask of the top ``k`` along the last axis; its gradient
    is the incoming gradient at the selected positions."""

    @staticmethod
    def forward(ctx, data, k, largest):
        idx = torch.topk(data, k, dim=-1, largest=largest).indices
        m = torch.zeros_like(data).scatter_(-1, idx, 1.0)
        ctx.save_for_backward(m)
        return m

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        return g * m, None, None


@register("topk", num_outputs=-1,
          no_grad=lambda attrs: attrs.get("ret_typ",
                                          "indices") == "indices")
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32", **kw):
    axis = -1 if axis is None else axis
    moved = torch.movedim(data, axis, -1)
    if ret_typ == "mask":
        return torch.movedim(_TopkMask.apply(moved, k, not is_ascend), -1,
                             axis)
    vals, idx = torch.topk(moved, k, dim=-1, largest=not is_ascend)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(_dtype(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    raise ValueError("unknown ret_typ %r" % ret_typ)


@register("cumsum")
def cumsum(data, axis=None, dtype=None, **kw):
    if axis is None:
        data, axis = data.reshape(-1), 0
    # integers keep their type (int32 for bool), as in the reference
    keep = None if data.is_floating_point() else (
        torch.int32 if data.dtype == torch.bool else data.dtype)
    out = torch.cumsum(data, dim=axis, dtype=keep)
    return out if dtype is None else out.to(_dtype(dtype))
