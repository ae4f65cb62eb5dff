"""Neural-network ops, NC(D)HW layout.

Port of ``mxnet_tpu/ops/nn.py``, name for name: ``dot``/``batch_dot``/
``khatri_rao``, ``FullyConnected``, ``Convolution``/``Deconvolution``,
``Pooling`` (max, avg, sum and lp, windowed or global), ``UpSampling``,
``Activation``/``LeakyReLU`` (every ``act_type``), the softmax family
(``use_length``, ``softmin``, ``masked_softmax``), the output heads
with their fused-loss gradients (``SoftmaxOutput``, the
``*RegressionOutput`` ops), Batch/Layer/Instance/Group norm,
``Dropout``, ``Embedding``, ``CTCLoss`` (the reference's optax
recursion), ``LRN``, ``im2col``/``col2im``, ``Crop`` and
``IdentityAttachKLSparseReg``.  Where the reference left the math to
XLA (matmul, convolution), the port leaves it to cuBLAS and cuDNN
through torch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, not_ported
from .elemwise import _dtype
from .registry import register


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """MXNet ``dot``: the last axis of ``lhs`` against the first of
    ``rhs``; ``transpose_a``/``transpose_b`` reverse an operand's axes
    first."""
    a = lhs.permute(*reversed(range(lhs.dim()))) if transpose_a else lhs
    b = rhs.permute(*reversed(range(rhs.dim()))) if transpose_b else rhs
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    a = lhs.transpose(-1, -2) if transpose_a else lhs
    b = rhs.transpose(-1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


@register("khatri_rao", variadic=True)
def khatri_rao(args, **kw):
    """The column-wise Kronecker product of the inputs (rows of the
    first vary slowest)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            (-1,) + tuple(out.shape[1:]))
    return out


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


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, target_shape=None,
                  num_filter=None, num_group=1, no_bias=True, layout=None,
                  **kw):
    """Transposed convolution, weight (in, out/group, *kernel): the
    reference's lhs-dilated convolution with the flipped kernel, pads
    ``(k-1)*d - p`` low and that plus ``adj`` high (``target_shape`` is
    ignored there too)."""
    nd = data.dim() - 2
    if nd not in _DECONV:
        raise MXNetError("Deconvolution supports 1/2/3 spatial dims")
    out = _DECONV[nd](data, weight, None, stride=_tup(stride or 1, nd),
                      padding=_tup(pad or 0, nd),
                      output_padding=_tup(adj or 0, nd), groups=num_group,
                      dilation=_tup(dilate or 1, nd))
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
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError("unknown pool_type %r" % pool_type)
    if global_pool:
        ax = tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=ax, keepdim=True)
        if pool_type == "avg":
            return data.mean(dim=ax, keepdim=True)
        if pool_type == "lp":
            return torch.pow(torch.pow(data.abs(), p_value).sum(
                dim=ax, keepdim=True), 1.0 / p_value)
        return data.sum(dim=ax, keepdim=True)
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
    if pool_type == "sum":
        return _window_sum(F.pad(data, flat), kernel, stride)
    if pool_type == "lp":
        return torch.pow(_window_sum(F.pad(torch.pow(data.abs(), p_value),
                                           flat), kernel, stride),
                         1.0 / p_value)
    mean = _AVGPOOL[nd](F.pad(data, flat), kernel, stride)
    if count_include_pad:
        return mean
    # divide by the window's unpadded count instead of its full size
    counts = _AVGPOOL[nd](F.pad(torch.ones_like(data[:1, :1]), flat),
                          kernel, stride)
    return mean / counts


def _window_sum(x, kernel, stride):
    """The sum over each (unpadded) pooling window."""
    nd = x.dim() - 2
    if nd == 1:
        return _window_sum(x.unsqueeze(-1), kernel + (1,),
                           stride + (1,)).squeeze(-1)
    pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("UpSampling", variadic=True)
def upsampling(data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", **kw):
    """Nearest upsampling by ``scale`` (each pixel repeated), the inputs
    summed or concatenated on the channels."""
    outs = [d.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                 dim=3)
            for d in data]
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": lambda x: x / (1 + x.abs())}


@register("Activation")
def activation(data, act_type="relu", **kw):
    if act_type not in _ACT:
        raise MXNetError("unknown act_type %r" % act_type)
    return _ACT[act_type](data)


_SELU = (1.6732632423543772, 1.0507009873554805)


@register("LeakyReLU")
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kw):
    """``leaky``, ``prelu`` (the slope ``gamma`` per channel), ``elu``,
    ``selu``, ``gelu`` (erf) and ``rrelu`` (the mean of its bounds as
    the slope, deterministic as in the reference)."""
    neg = None
    if act_type == "leaky":
        neg = slope * data
    elif act_type == "prelu":
        g = gamma
        if g.dim() == 1 and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        neg = g * data
    elif act_type == "elu":
        neg = slope * torch.expm1(data)
    elif act_type == "selu":
        alpha, lam = _SELU
        return lam * torch.where(data >= 0, data, alpha * torch.expm1(data))
    elif act_type == "gelu":
        return F.gelu(data)
    elif act_type == "rrelu":
        neg = (lower_bound + upper_bound) / 2.0 * data
    else:
        raise MXNetError("unknown act_type %r" % act_type)
    return torch.where(data >= 0, data, neg)


def _length_mask(x, length, axis):
    steps = torch.arange(x.shape[axis], device=x.device)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return steps.reshape(shape) < length.unsqueeze(axis)


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None, **kw):
    """Softmax along ``axis``; with ``use_length`` only the first
    ``length`` positions of each row (a tensor input after ``data``, or
    the ``length`` attribute) take part and the rest output 0."""
    if isinstance(axis, torch.Tensor):      # nd.softmax(x, length, ...)
        length, axis = axis, -1
    length = getattr(length, "_data", length)
    x = data if temperature is None or temperature == 1.0 \
        else data / temperature
    if use_length and length is not None:
        mask = _length_mask(x, length, axis % x.dim())
        out = torch.softmax(x.masked_fill(~mask, -math.inf), dim=axis)
        out = out.masked_fill(~mask, 0.0)
    else:
        out = torch.softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None, **kw):
    x = data if not temperature or temperature == 1.0 else data / temperature
    out = torch.log_softmax(x, dim=axis)
    return out if dtype is None else out.to(_dtype(dtype))


@register("softmin")
def softmin(data, axis=-1, **kw):
    return softmax(-data, axis=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label, **kw):
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.to(torch.int32).long()[:, None]).sum()


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
    in f32.  The output is ``data * scale + shift`` as in the reference
    (``output_mean_var`` changes nothing there either);
    the new running statistics come back detached, after the output, for
    the mutate contract to write into ``moving_mean`` / ``moving_var``."""
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


class _RegressionOutput(torch.autograd.Function):
    """``out(x)`` forward; backward ``(out(x) - label) * grad_scale / N``
    (``sign`` of it for MAE), ignoring the incoming gradient and giving
    the label none, as the reference's custom VJPs."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out.clone() if out is data else out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        return diff * (ctx.grad_scale / out.shape[0]), None, None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, "linear", float(grad_scale))


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, "logistic",
                                   float(grad_scale))


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionOutput.apply(data, label, "mae", float(grad_scale))


def _bshape(data, axis):
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return shape


@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
               **kw):
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, unbiased=False, keepdim=True)
    inv = 1.0 / torch.sqrt(var + eps)
    b = _bshape(data, axis % data.dim())
    return (data - mean) * inv * gamma.reshape(b) + beta.reshape(b)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3, **kw):
    ax = tuple(range(2, data.dim()))
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, unbiased=False, keepdim=True)
    out = (data - mean) / torch.sqrt(var + eps)
    b = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(b) + beta.reshape(b)


@register("GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5, **kw):
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups)
                     + tuple(data.shape[2:]))
    ax = tuple(range(2, x.dim()))
    mean = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, unbiased=False, keepdim=True)
    x = ((x - mean) / torch.sqrt(var + eps)).reshape(data.shape)
    b = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(b) + beta.reshape(b)


_LOG_EPS = -1e5     # optax's log(0) in its CTC recursion


def _ctc_nll(logits, logit_pad, labels, label_pad, blank_id):
    """Per-sequence CTC negative log-likelihood: optax's
    ``ctc_loss_with_forward_probs`` recursion (the reference's
    ``CTCLoss``), with its ``-1e5`` for log 0, so an impossible
    alignment gives a large finite loss, not torch's infinity.
    ``logits`` (B, T, K), paddings 1.0 where padded."""
    B, _, K = logits.shape
    N = labels.shape[1]
    logp = torch.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(dim=1).to(torch.int32)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = F.pad(repeat, (0, 1))
    lp_phi = logp[:, :, blank_id:blank_id + 1].transpose(0, 1)  # T B 1
    onehot = (labels.unsqueeze(-1) == torch.arange(
        K, device=labels.device)).to(logits.dtype)                # B N K
    lp_emit = torch.einsum("btk,bnk->btn", logp, onehot).transpose(0, 1)
    phi = torch.full((B, N + 1), _LOG_EPS, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((B, N), _LOG_EPS, dtype=logits.dtype,
                      device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], -1)

    pads = logit_pad.transpose(0, 1)
    for t in range(lp_emit.shape[0]):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + _LOG_EPS * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = update_phi(prev_phi + lp_phi[t],
                              emit + lp_phi[t] + _LOG_EPS * (1.0 - repeat))
        pad = pads[t].reshape(B, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    pick = (labellens.long().unsqueeze(-1) == torch.arange(
        N + 1, device=labels.device)).to(logits.dtype)
    return -(last * pick).sum(-1)


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kw):
    """CTC loss of ``data`` (T, N, C) logits against ``label`` (N, L):
    the blank is class 0 (``"first"``; labels <= 0 are padding) or C-1
    (``"last"``; labels < 0 are padding), or the given lengths mark
    the padding."""
    logits = data.transpose(0, 1)
    B, T, C = logits.shape
    blank_id = 0 if blank_label == "first" else C - 1
    labels = label.to(torch.int32).long()
    f32 = torch.float32
    if use_data_lengths and data_lengths is not None:
        logit_pad = (torch.arange(T, device=data.device)[None, :]
                     >= data_lengths.to(torch.int32)[:, None]).to(f32)
    else:
        logit_pad = torch.zeros((B, T), dtype=f32, device=data.device)
    L = labels.shape[1]
    if use_label_lengths and label_lengths is not None:
        label_pad = (torch.arange(L, device=data.device)[None, :]
                     >= label_lengths.to(torch.int32)[:, None]).to(f32)
    elif blank_label == "first":
        label_pad = (labels <= 0).to(f32)
    else:
        label_pad = (labels < 0).to(f32)
    return _ctc_nll(logits, logit_pad.to(data.dtype), labels,
                    label_pad.to(data.dtype), blank_id)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalization across the channels, in f32."""
    sq = data.float() ** 2
    half = nsize // 2
    padded = F.pad(sq, (0, 0) * (data.dim() - 2) + (half, half))
    win = padded[:, 0:data.shape[1]]
    for i in range(1, nsize):
        win = win + padded[:, i:i + data.shape[1]]
    norm = torch.pow(knorm + alpha / nsize * win, beta)
    return (data.float() / norm).to(data.dtype)


@register("log_sigmoid")
def log_sigmoid(data, **kw):
    return F.logsigmoid(data)


@register("mish")
def mish(data, **kw):
    return data * torch.tanh(F.softplus(data))


@register("masked_softmax")
def masked_softmax(data, mask, axis=-1, temperature=1.0, normalize=True,
                   **kw):
    """Softmax over the positions where ``mask`` is nonzero; the others
    output 0."""
    x = data if temperature is None or temperature == 1.0 \
        else data / temperature
    keep = mask != 0
    out = torch.softmax(x.masked_fill(~keep, -math.inf), dim=axis)
    return torch.where(keep, out, torch.zeros_like(out)).to(data.dtype)


@register("softmax_activation")
def softmax_activation(data, mode="instance", **kw):
    return torch.softmax(data, dim=1 if mode == "channel" else -1)


def _patches(data, kernel, stride, dilate, pad):
    """(N, C * prod(kernel), *out_spatial) patches, channel-major as
    ``lax.conv_general_dilated_patches`` orders them."""
    nd = data.dim() - 2
    x = F.pad(data, [v for p in reversed(pad) for v in (p, p)])
    out_sp = [(x.shape[2 + i] - (kernel[i] - 1) * dilate[i] - 1)
              // stride[i] + 1 for i in range(nd)]
    cols = []
    for off in np.ndindex(*kernel):
        idx = (slice(None), slice(None)) + tuple(
            slice(o * d, o * d + (n - 1) * s + 1, s)
            for o, d, s, n in zip(off, dilate, stride, out_sp))
        cols.append(x[idx])
    out = torch.stack(cols, dim=2)          # N, C, K, *out
    return out.reshape((data.shape[0], -1) + tuple(out_sp))


def _conv_args(kernel, stride, dilate, pad):
    nd = len(kernel) if not isinstance(kernel, int) else 1
    return (_tup(kernel, nd), _tup(stride or 1, nd), _tup(dilate or 1, nd),
            _tup(pad or 0, nd))


@register("im2col")
def im2col(data, kernel=None, stride=None, dilate=None, pad=None, **kw):
    """Conv patches as columns: (N, C, *spatial) -> (N, C *
    prod(kernel), prod(out_spatial))."""
    p = _patches(data, *_conv_args(kernel, stride, dilate, pad))
    return p.reshape(p.shape[0], p.shape[1], -1)


@register("col2im")
def col2im(data, output_size=None, kernel=None, stride=None, dilate=None,
           pad=None, **kw):
    """The adjoint of :func:`im2col` (columns summed back into the
    image), as the reference defines it: the gradient of ``im2col`` at
    ``data``."""
    k, s, d, p = _conv_args(kernel, stride, dilate, pad)
    nd = len(k)
    out_sp = tuple(int(v) for v in output_size)[-nd:]
    C = data.shape[1] // int(np.prod(k))
    ref = torch.zeros((data.shape[0], C) + out_sp, dtype=data.dtype,
                      device=data.device, requires_grad=True)
    with torch.enable_grad():
        cols = _patches(ref, k, s, d, p)
        (img,) = torch.autograd.grad(cols.reshape(data.shape), ref, data,
                                     create_graph=data.requires_grad)
    return img


@register("Crop")
def crop_v1(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
            num_args=None, **kw):
    """Crop ``inputs[0]`` to ``h_w`` (or to ``inputs[1]``'s spatial
    shape) at ``offset``, or centred."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds the KL sparsity penalty's
    gradient from the batch-mean activation of each unit."""

    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.save_for_backward(x)
        ctx.rho, ctx.penalty = rho, penalty
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rho, penalty = ctx.rho, ctx.penalty
        rho_hat = x.mean(dim=0, keepdim=True).clamp(1e-6, 1 - 1e-6)
        kl = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + kl.expand(x.shape), None, None


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9, **kw):
    """Identity with the KL sparsity gradient (reference divergence
    kept: the current batch mean stands for the moving average, and
    ``momentum`` is unused)."""
    return _KLSparseReg.apply(data, float(sparseness_target),
                              float(penalty))
