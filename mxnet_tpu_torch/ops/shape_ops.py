"""Shape and indexing ops.

Port of a subset of ``mxnet_tpu/ops/shape_ops.py``: ``reshape``,
``Flatten``, ``Concat``, ``pick``, ``pad``, ``space_to_depth`` and
``depth_to_space``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, not_ported
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



_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=None, constant_value=0.0, **kw):
    """Pad every axis by MXNet's flat ``pad_width`` (before, after for
    axis 0, then axis 1, ...): ``constant``, ``edge`` (the border value
    repeated) or ``reflect`` (mirrored without the border), numpy's
    modes as the reference's ``jnp.pad`` takes them."""
    pw = list(zip(pad_width[::2], pad_width[1::2]))
    if mode == "constant":
        return F.pad(data, [x for p in reversed(pw) for x in p],
                     value=constant_value)
    if mode not in _PAD_MODES:
        raise MXNetError("unknown pad mode %r" % mode)
    # torch pads only the last 1-3 axes of an (N, C, ...) tensor in these
    # modes: fold the unpadded leading axes into N, with C = 1
    lead = next((i for i, p in enumerate(pw) if any(p)), len(pw))
    k = len(pw) - lead
    if k == 0:
        return data
    if k > 3:
        raise not_ported("pad mode %r over %d axes" % (mode, k),
                         "mxnet_tpu.ops.shape_ops.pad")
    x = data.reshape((-1, 1) + tuple(data.shape[lead:]))
    out = F.pad(x, [v for p in reversed(pw[lead:]) for v in p],
                mode=_PAD_MODES[mode])
    return out.reshape(tuple(data.shape[:lead]) + tuple(out.shape[2:]))


@register("space_to_depth")
def space_to_depth(data, block_size=1, **kw):
    """(N, C, H, W) -> (N, C*b*b, H/b, W/b), output channel
    ``(di*b + dj)*C + c`` holding pixel (b*y + di, b*x + dj) of channel
    c: the reference's (di, dj, c) order, on which
    ``SpaceToDepthStem.convert_weight`` relies."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def depth_to_space(data, block_size=1, **kw):
    """The inverse of :func:`space_to_depth`."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)
