"""Shape, indexing and layout ops, and the creation ops.

Port of ``mxnet_tpu/ops/shape_ops.py``, name for name: ``reshape`` with
MXNet's special values (0 keep, -1 infer, -2 copy the rest, -3 merge
two, -4 split one), ``transpose``, ``slice`` (negative steps included),
``take``/``pick``/``gather_nd``/``scatter_nd``/``one_hot``, ``split``,
``stack``, ``tile``, ``repeat``, ``flip``, the broadcasts, the
``Sequence*`` ops, ``pad`` (``constant``, ``edge`` and ``reflect`` over
any axes), ``boolean_mask`` (a host read of the mask, as in the
reference) and the creation ops ``_zeros``, ``_ones``, ``_arange``,
``_eye``, ``_linspace``, which put their tensors on
:func:`.registry.creation_device`.  Index outputs are int32 where the
reference casts to int32; ``shape_array``/``size_array`` are int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .elemwise import _dtype
from .registry import creation_device, register


def _mx_reshape_shape(src_shape, target):
    """The target shape of MXNet's reshape codes: 0 copy a dim, -1
    infer, -2 copy the rest, -3 merge two, -4 split one into the next
    two target values (-1 allowed in the pair)."""
    src = list(src_shape)
    out = []
    i = 0
    t = list(target)
    k = 0
    while k < len(t):
        d = t[k]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = t[k + 1], t[k + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            k += 2
        else:
            out.append(d)
            i += 1
        k += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = int(np.prod(src_shape)) // known
    return tuple(out)


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False, **kw):
    """MXNet reshape.  ``reverse`` is accepted and, as in the reference,
    does not change the result."""
    if shape is None:
        raise MXNetError("reshape requires shape")
    if isinstance(shape, int):
        shape = (shape,)
    return data.reshape(_mx_reshape_shape(data.shape, tuple(shape)))


@register("reshape_like")
def reshape_like(lhs, rhs, **kw):
    return lhs.reshape(rhs.shape)


@register("shape_array", no_grad=True)
def shape_array(data, **kw):
    return torch.tensor(list(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", no_grad=True)
def size_array(data, **kw):
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@register("transpose")
def transpose(data, axes=None, **kw):
    if not axes:
        return data.permute(*reversed(range(data.dim())))
    return data.permute(*axes)


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0, **kw):
    return torch.swapaxes(data, dim1, dim2)


@register("expand_dims")
def expand_dims(data, axis=0, **kw):
    return data.unsqueeze(axis if axis >= 0 else data.dim() + 1 + axis)


@register("squeeze")
def squeeze(data, axis=None, **kw):
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axes:
        if data.shape[a] != 1:
            raise MXNetError("squeeze: axis %d has size %d"
                             % (a, data.shape[a]))
    return data.squeeze(tuple(a % data.dim() for a in axes))


@register("Flatten", aliases=("flatten",))
def flatten(data, **kw):
    return data.reshape(data.shape[0], -1)


@register("flip", aliases=("reverse",))
def flip(data, axis=None, **kw):
    if axis is None:
        axis = tuple(range(data.dim()))
    return torch.flip(data, (axis,) if isinstance(axis, int)
                      else tuple(axis))


@register("tile")
def tile(data, reps=None, **kw):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(data, reps)


@register("repeat")
def repeat(data, repeats=1, axis=None, **kw):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), repeats)
    return torch.repeat_interleave(data, repeats, dim=axis)


@register("broadcast_to")
def broadcast_to(data, shape=None, **kw):
    """Broadcast to ``shape``, right-aligned; a 0 keeps the input's
    dim."""
    tgt = list(shape)
    lead = len(tgt) - data.dim()
    if lead < 0:
        raise MXNetError("broadcast_to: target rank %d < data rank %d"
                         % (len(tgt), data.dim()))
    for i, d in enumerate(data.shape):
        if tgt[lead + i] == 0:
            tgt[lead + i] = d
    return data.broadcast_to(tgt)


@register("_onnx_expand")
def _onnx_expand(data, shape=None, **kw):
    """ONNX Expand: numpy broadcasting of ``data`` against ``shape``
    both ways."""
    return data.broadcast_to(torch.broadcast_shapes(tuple(data.shape),
                                                    tuple(shape)))


@register("broadcast_like")
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None, **kw):
    return lhs.broadcast_to(rhs.shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=None, size=None, **kw):
    if axis is None:
        return data
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return data.broadcast_to(tgt)


@register("Concat", aliases=("concat",), variadic=True)
def concat(data, dim=1, num_args=None, **kw):
    return torch.cat(data, dim=dim)


@register("stack", variadic=True)
def stack(data, axis=0, num_args=None, **kw):
    return torch.stack(data, dim=axis)


def _split(data, sections, axis, squeeze_axis):
    """numpy's ``split``: ``sections`` equal parts (an int) or the
    parts between the given indices."""
    n = data.shape[axis]
    if isinstance(sections, int):
        if n % sections:
            raise MXNetError("split: axis of size %d does not divide into "
                             "%d parts" % (n, sections))
        bounds = [n // sections * i for i in range(sections + 1)]
    else:
        bounds = [0] + [min(int(i), n) for i in sections] + [n]
    parts = [data.narrow(axis, lo, max(hi - lo, 0))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("split", aliases=("SliceChannel",), num_outputs=-1)
def split(data, num_outputs=None, axis=1, squeeze_axis=False, **kw):
    return _split(data, int(num_outputs), axis, squeeze_axis)


@register("split_v2", num_outputs=-1)
def split_v2(data, indices_or_sections=None, axis=0, squeeze_axis=False,
             sections=0, **kw):
    if sections and not indices_or_sections:
        indices_or_sections = sections
    return _split(data, indices_or_sections, axis, squeeze_axis)


def _slice_axis(x, axis, b, e, s):
    """``x[..., b:e:s, ...]`` along ``axis`` with numpy's rules (a
    negative step counts down)."""
    if s is None or s > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(b, e, s)
        return x[tuple(idx)]
    rows = list(range(*slice(b, e, s).indices(x.shape[axis])))
    return x.index_select(axis, torch.tensor(rows, dtype=torch.long,
                                             device=x.device))


@register("slice", aliases=("crop",))
def slice_op(data, begin=None, end=None, step=None, **kw):
    step = step or [None] * len(begin)
    out = data
    for a, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _slice_axis(out, a, b, e, s)
    return out


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None, **kw):
    return _slice_axis(data, axis, begin, end, None)


@register("slice_like")
def slice_like(data, shape_like, axes=(), **kw):
    if not axes:
        axes = range(min(data.dim(), shape_like.dim()))
    out = data
    for a in axes:
        out = _slice_axis(out, a, 0, shape_like.shape[a], None)
    return out


def _take_along(a, idx, axis):
    """``a`` at the (in-range) ``idx`` along ``axis``, shaped
    ``a.shape[:axis] + idx.shape + a.shape[axis+1:]``."""
    axis = axis % a.dim()
    flat = a.index_select(axis, idx.reshape(-1))
    return flat.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                        + tuple(a.shape[axis + 1:]))


@register("take")
def take(a, indices, axis=0, mode="clip", **kw):
    n = a.shape[axis]
    idx = indices.to(torch.int32).long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    return _take_along(a, idx, axis)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    """``data`` at ``index`` along ``axis``; indices are clipped into
    range (the reference clips whatever ``mode`` says)."""
    ax = axis % data.dim()
    idx = index.long().clamp(0, data.shape[ax] - 1).unsqueeze(ax)
    out = data.gather(ax, idx)
    return out if keepdims else out.squeeze(ax)


@register("gather_nd")
def gather_nd(data, indices, **kw):
    idx = indices.to(torch.int32).long()
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd")
def scatter_nd(data, indices, shape=None, **kw):
    idx = indices.to(torch.int32).long()
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data,
                         accumulate=True)


@register("one_hot", no_grad=True)
def one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
            dtype="float32", **kw):
    """One-hot rows (an index outside [0, depth) gives a row of
    ``off_value``), ``* (on - off) + off`` as in the reference."""
    classes = torch.arange(depth, device=indices.device)
    oh = (indices.to(torch.int32).long().unsqueeze(-1) == classes) \
        .to(_dtype(dtype))
    return oh * (on_value - off_value) + off_value


def _batch_axis(axis):
    return 1 if axis == 0 else 0


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kw):
    if not use_sequence_length or sequence_length is None:
        return data
    T = data.shape[axis]
    bshape = [1] * data.dim()
    bshape[axis] = T
    steps = torch.arange(T, device=data.device).reshape(bshape)
    lshape = [1] * data.dim()
    b = _batch_axis(axis)
    lshape[b] = data.shape[b]
    mask = steps < sequence_length.reshape(lshape)
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kw):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.to(torch.int32).long() - 1
    moved = torch.movedim(data, axis, 0)
    return moved[last, torch.arange(moved.shape[1], device=data.device)]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0, **kw):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    moved = torch.movedim(data, axis, 0)
    T = moved.shape[0]
    lens = sequence_length.to(torch.int32).long()
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < lens[None, :], lens[None, :] - 1 - t, t)
    src = src.reshape(tuple(src.shape) + (1,) * (moved.dim() - 2)) \
        .expand(moved.shape)
    return torch.movedim(moved.gather(0, src), 0, axis)


def _pad_rows(n, lo, hi, mode, device):
    """numpy's source rows of ``edge`` or ``reflect`` padding of an axis
    of size ``n`` by ``lo`` before and ``hi`` after, made on ``device``
    (a host-to-device copy would break a CUDA graph's capture)."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return j.clamp(0, n - 1)
    period = 2 * (n - 1)
    if not period:
        return torch.zeros_like(j)
    r = j.abs() % period
    return torch.where(r >= n, period - r, r)


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=None, constant_value=0.0, **kw):
    """Pad every axis by MXNet's flat ``pad_width`` (before, after for
    axis 0, then axis 1, ...): ``constant``, ``edge`` (the border value
    repeated) or ``reflect`` (mirrored without the border), numpy's
    modes as the reference's ``jnp.pad`` takes them, over any axes."""
    pw = list(zip(pad_width[::2], pad_width[1::2]))
    if mode == "constant":
        return torch.nn.functional.pad(
            data, [x for p in reversed(pw) for x in p], value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError("unknown pad mode %r" % mode)
    out = data
    for a, (lo, hi) in enumerate(pw):
        if lo or hi:
            out = out.index_select(a, _pad_rows(out.shape[a], lo, hi, mode,
                                                out.device))
    return out


@register("diag")
def diag(data, k=0, axis1=0, axis2=1, **kw):
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


@register("zeros_like")
def zeros_like(data, **kw):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data, **kw):
    return torch.ones_like(data)


@register("_full_like")
def full_like(data, fill_value=0.0, **kw):
    return torch.full_like(data, fill_value)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros", no_grad=True)
def _zeros(shape=None, dtype="float32", **kw):
    return torch.zeros(_shape(shape), dtype=_dtype(dtype or "float32"),
                       device=creation_device())


@register("_ones", no_grad=True)
def _ones(shape=None, dtype="float32", **kw):
    return torch.ones(_shape(shape), dtype=_dtype(dtype or "float32"),
                      device=creation_device())


def _host(values, dtype):
    """A host-computed numpy array on the creation device."""
    return torch.from_numpy(np.ascontiguousarray(values)).to(
        device=creation_device(), dtype=_dtype(dtype))


@register("_arange", no_grad=True)
def _arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32", **kw):
    """numpy's ``arange`` in ``dtype`` (the reference's ``jnp.arange``
    of host numbers computes it so), each value ``repeat`` times."""
    out = np.arange(start, stop, step, dtype=np.dtype(dtype))
    if repeat > 1:
        out = np.repeat(out, repeat)
    return _host(out, dtype)


@register("_eye", no_grad=True)
def _eye(N=0, M=0, k=0, dtype="float32", **kw):
    return _host(np.eye(int(N), int(M) if M else None, k=int(k),
                        dtype=np.dtype(dtype)), dtype)


@register("_linspace", no_grad=True)
def _linspace(start=0, stop=1, num=50, endpoint=True, dtype="float32",
              **kw):
    return _host(np.linspace(start, stop, int(num), endpoint=endpoint)
                 .astype(np.dtype(dtype)), dtype)


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


@register("batch_take", aliases=("choose_element_0index",
                                 "_choose_element_0index"))
def batch_take(a, indices, **kw):
    """``out[i] = a[i, indices[i]]``."""
    idx = indices.to(torch.int32).long()
    return a.gather(1, idx[:, None])[:, 0]


@register("unravel_index", aliases=("_unravel_index",), no_grad=True)
def unravel_index(data, shape=None, **kw):
    """Flat indices -> their coordinates, shape ``(len(shape),) +
    data.shape``, int32."""
    flat = data.to(torch.int32).long().reshape(-1)
    coords = []
    for d in reversed(tuple(shape)):
        coords.append(torch.remainder(flat, d))
        flat = torch.div(flat, d, rounding_mode="floor")
    out = torch.stack(coords[::-1], dim=0).to(torch.int32)
    return out.reshape((len(shape),) + tuple(data.shape))


@register("ravel_multi_index", aliases=("_ravel_multi_index",),
          no_grad=True)
def ravel_multi_index(data, shape=None, **kw):
    """Coordinates (D, N) -> flat indices, int32."""
    strides = np.concatenate([np.cumprod(list(shape)[::-1])[::-1][1:],
                              [1]]).astype(np.int32)
    s = torch.as_tensor(strides, device=data.device)
    return (data.to(torch.int32) * s[:, None]).sum(0, dtype=torch.int32)


@register("_contrib_arange_like", aliases=("arange_like",), no_grad=True)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, **kw):
    """``start + step * i`` shaped like the input (or its ``axis``),
    each value ``repeat`` times, float32."""
    repeat = int(repeat)
    n = data.numel() if axis is None else data.shape[axis]
    vals = start + step * torch.arange(-(-n // repeat), dtype=torch.float32,
                                       device=data.device)
    if repeat != 1:
        vals = torch.repeat_interleave(vals, repeat)[:n]
    return vals.reshape(data.shape) if axis is None else vals


@register("_contrib_index_copy", aliases=("index_copy",))
def index_copy(old, index, new, **kw):
    """``old`` with the rows at ``index`` replaced by ``new``."""
    return old.index_copy(0, index.to(torch.int32).long(),
                          new.to(old.dtype))


@register("_contrib_index_array", aliases=("index_array",), no_grad=True)
def index_array(data, axes=None, **kw):
    """``out[..., k]`` = the coordinate along ``axes[k]`` (all axes
    when None), int32."""
    sel = tuple(axes) if axes is not None else tuple(range(data.dim()))
    grids = torch.meshgrid(*[torch.arange(s, device=data.device)
                             for s in data.shape], indexing="ij")
    return torch.stack([grids[a] for a in sel], dim=-1).to(torch.int32)


@register("_contrib_boolean_mask", aliases=("boolean_mask",))
def boolean_mask(data, index, axis=0, **kw):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero.
    The output's length depends on the data, so the mask is read on
    the host (as in the reference), which a CUDA graph cannot
    capture."""
    keep = torch.nonzero(index != 0).reshape(-1)
    return data.index_select(axis, keep.to(data.device))


@register("fill_element_0index", aliases=("_fill_element_0index",))
def fill_element_0index(lhs, mhs, rhs, **kw):
    """``lhs`` with ``out[i, rhs[i]] = mhs[i]``."""
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, rhs.to(torch.int32).long()),
                         mhs.to(lhs.dtype))
