"""Shape and indexing ops.

Port of a subset of ``mxnet_tpu/ops/shape_ops.py``: ``reshape``,
``Flatten``, ``Concat`` and ``pick``.
"""
from __future__ import annotations

import torch

from ..base import not_ported
from .registry import register


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False, **kw):
    """MXNet reshape with the special values 0 (keep this dim) and -1
    (infer); -2, -3 and -4 are not ported."""
    if reverse or any(s < -1 for s in shape):
        raise not_ported("reshape with reverse or -2/-3/-4",
                         "mxnet_tpu.ops.shape_ops.reshape")
    tgt = [data.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return data.reshape(tgt)


@register("Flatten", aliases=("flatten",))
def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)


@register("Concat", aliases=("concat",), variadic=True)
def concat(data, dim=1, num_args=None, **kw):
    return torch.cat(data, dim=dim)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    """``data`` at ``index`` along ``axis``; indices are clipped into
    range (the reference clips whatever ``mode`` says)."""
    ax = axis % data.dim()
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = data.gather(ax, idx)
    return out if keepdims else out.squeeze(ax)

