"""Neural-network ops, NC(D)HW layout.

Port of a subset of ``mxnet_tpu/ops/nn.py``: ``dot``, ``FullyConnected``,
``Convolution``, ``Pooling`` (max and avg, windowed or global),
``Activation``, ``softmax``, ``log_softmax``, ``BatchNorm``, the
``SoftmaxOutput`` head, ``Dropout`` and ``Embedding``.  Where the
reference left the math to XLA (matmul, convolution), the port leaves it
to cuBLAS and cuDNN through torch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, not_ported
from .registry import register


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """MXNet ``dot``: the last axis of ``lhs`` against the first of
    ``rhs``; ``transpose_a``/``transpose_b`` reverse an operand's axes
    first."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("FullyConnected")
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


def _tup(v, n):
    if v is None:
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=1024, **kw):
    """1-3 spatial dims, symmetric padding, grouped; the bias is added
    after the convolution, as in the reference."""
    nd = data.dim() - 2
    if nd not in _CONV:
        raise MXNetError("Convolution supports 1/2/3 spatial dims")
    if layout not in (None, "NCW", "NCHW", "NCDHW"):
        raise not_ported("Convolution layout %r" % layout,
                         "mxnet_tpu.ops.nn.convolution")
    out = _CONV[nd](data, weight, None, stride=_tup(stride or 1, nd),
                    padding=_tup(pad or 0, nd),
                    dilation=_tup(dilate or 1, nd), groups=num_group)
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None, cudnn_off=False, p_value=2,
            **kw):
    """Max or average pooling.  The input is padded explicitly (-inf for
    max, 0 otherwise) with the reference's pads, the ``full``
    convention's extra high padding included, then pooled unpadded, so
    the windows are the reference's ``reduce_window`` windows."""
    nd = data.dim() - 2
    if nd < 1:
        raise MXNetError("Pooling: data must be 3-D/4-D/5-D (N, C, "
                         "spatial...), got %d-D" % data.dim())
    if pool_type not in ("max", "avg"):
        raise not_ported("Pooling pool_type=%r" % pool_type,
                         "mxnet_tpu.ops.nn.pooling")
    if global_pool:
        ax = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=ax, keepdim=True)
        return data.mean(dim=ax, keepdim=True)
    if not kernel:
        raise MXNetError("Pooling: kernel is required unless "
                         "global_pool=True")
    kernel = _tup(kernel, nd)
    stride = _tup(stride or 1, nd)
    pad = _tup(pad or 0, nd)
    pads = [(p, p) for p in pad]
    if pooling_convention == "full":
        for i, (k_, s_, p_) in enumerate(zip(kernel, stride, pad)):
            size = data.shape[2 + i]
            out_full = -(-(size + 2 * p_ - k_) // s_) + 1
            pads[i] = (p_, max((out_full - 1) * s_ + k_ - size - p_, p_))
    flat = [x for lo_hi in reversed(pads) for x in lo_hi]   # F.pad order
    if pool_type == "max":
        return _MAXPOOL[nd](F.pad(data, flat, value=-math.inf), kernel,
                            stride)
    mean = _AVGPOOL[nd](F.pad(data, flat), kernel, stride)
    if count_include_pad:
        return mean
    # divide by the window's unpadded count instead of its full size
    counts = _AVGPOOL[nd](F.pad(torch.ones_like(data[:1, :1]), flat),
                          kernel, stride)
    return mean / counts


_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": lambda x: x / (1 + x.abs())}


@register("Activation")
def activation(data, act_type="relu", **kw):
    if act_type not in _ACT:
        raise MXNetError("unknown act_type %r" % act_type)
    return _ACT[act_type](data)


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None, **kw):
    if use_length:
        raise not_ported("softmax use_length", "mxnet_tpu.ops.nn.softmax")
    x = data if temperature is None or temperature == 1.0 \
        else data / temperature
    out = torch.softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None, **kw):
    x = data if not temperature or temperature == 1.0 else data / temperature
    out = torch.log_softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


def _dtype(name):
    return getattr(torch, str(name))


@register("BatchNorm", aliases=("BatchNorm_v1",), mutate=(3, 4),
          training_aware=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=False, **kw):
    """Batch normalization (reference ``batch_norm``, ``nn.py:485``).

    Training normalises by the batch mean and the *biased* batch
    variance and moves the running statistics by MXNet's convention,
    ``new = momentum * old + (1 - momentum) * batch`` (torch's
    ``momentum`` is the other weight, and its running variance is
    unbiased, so ``F.batch_norm`` is not used).  Statistics accumulate
    in f32.  The output is ``data * scale + shift`` as in the reference;
    the new running statistics come back detached, after the output, for
    the mutate contract to write into ``moving_mean`` / ``moving_var``."""
    if output_mean_var:
        raise not_ported("BatchNorm output_mean_var",
                         "mxnet_tpu.ops.nn.batch_norm")
    axis = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    f32 = torch.float32
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _training and not use_global_stats:
        if data.dtype == f32:
            mean = data.mean(dim=red)
            var = data.var(dim=red, unbiased=False)
        else:
            mean = data.mean(dim=red, dtype=f32)
            ex2 = data.float().square().mean(dim=red)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
        with torch.no_grad():
            new_mean = (moving_mean.float() * momentum
                        + mean * (1 - momentum)).to(moving_mean.dtype)
            new_var = (moving_var.float() * momentum
                       + var * (1 - momentum)).to(moving_var.dtype)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mean, new_var = moving_mean, moving_var
    inv = 1.0 / torch.sqrt(var + eps)
    scale = (g.float() * inv).reshape(bshape).to(data.dtype)
    shift = (beta.float() - mean * g.float() * inv).reshape(bshape) \
        .to(data.dtype)
    return data * scale + shift, new_mean, new_var


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot) * scale``, the fused
    loss gradient of the reference's custom VJP, which ignores the
    incoming gradient and gives the label none."""

    @staticmethod
    def forward(ctx, data, label, axis, grad_scale, ignore_label, use_ignore,
                normalization, smooth_alpha):
        p = torch.softmax(data, dim=axis)
        ctx.save_for_backward(p, label)
        ctx.attrs = (axis, grad_scale, ignore_label, use_ignore,
                     normalization, smooth_alpha)
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        axis, grad_scale, ignore_label, use_ignore, normalization, \
            smooth_alpha = ctx.attrs
        k = p.shape[axis]
        # one-hot by comparison: a label outside [0, k) (an ignored -1)
        # gives a zero row, as jax.nn.one_hot does
        classes = torch.arange(k, device=p.device).reshape(
            [k if i == axis % p.dim() else 1 for i in range(p.dim())])
        oh = (label.long().unsqueeze(axis) == classes).to(p.dtype)
        if smooth_alpha:
            oh = oh * (1 - smooth_alpha) + smooth_alpha / (k - 1) * (1 - oh)
        grad = p - oh
        if use_ignore:
            keep = (label != ignore_label).to(p.dtype)
            grad = grad * keep.unsqueeze(axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / p.shape[0]
        elif normalization == "valid":
            # the count of non-ignored labels under use_ignore (at least
            # 1), else every label position
            if use_ignore:
                valid = (label != ignore_label).sum().clamp(min=1)
                scale = scale / valid.to(p.dtype)
            else:
                scale = scale / label.numel()
        grad = grad * scale
        return (grad.to(p.dtype),) + (None,) * 7


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0, **kw):
    """Softmax over the last axis (axis 1 with ``multi_output``) whose
    gradient is the softmax cross-entropy's, ``(p - onehot(label)) *
    grad_scale``, divided by the batch (``normalization="batch"``) or
    by the valid label count (``"valid"``: the non-ignored labels under
    ``use_ignore``, else ``label.size``); ignored labels get no
    gradient and ``smooth_alpha`` smooths the one-hot (reference
    ``softmax_output``, ``nn.py:363``)."""
    return _SoftmaxOutput.apply(data, label, 1 if multi_output else -1,
                                float(grad_scale), float(ignore_label),
                                bool(use_ignore), normalization,
                                float(smooth_alpha))


@register("Dropout", needs_rng=True, training_aware=True)
def dropout(gen, data, p=0.5, mode="training", axes=(), cudnn_off=False,
            _training=False, **kw):
    """Inverted dropout (reference ``dropout``, ``nn.py:583``): in
    training (or ``mode="always"``) each element, or each slice along
    the axes not in ``axes``, is kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``; the keep mask is drawn from ``gen``
    (torch's default generator of the device when None).  The
    reference's ``jax.random`` stream is not reproduced: the keep rate
    and the scaling are."""
    if not _training and mode != "always":
        return data
    if p <= 0:
        return data
    shape = list(data.shape)
    if axes:
        for i in range(len(shape)):
            if i not in axes:
                shape[i] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device, generator=gen) < keep
    return torch.where(mask, data / keep, 0.0).to(data.dtype)


@register("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False, **kw):
    """Rows of ``weight`` at the indices in ``data`` (a float or integer
    tensor, truncated to integers as the reference's ``astype``)."""
    return F.embedding(data.long(), weight)
