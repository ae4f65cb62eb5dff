"""INT8 quantization operators.

Port of ``mxnet_tpu/ops/quantization.py`` (MXNet's
``src/operator/quantization/``): ``quantize``, ``quantize_v2``,
``dequantize``, ``requantize`` and the quantized fully connected,
convolution, pooling, flatten and relu, each registered under its
``_contrib_*`` name and its short alias.

* Quantization is symmetric for int8 (zero point 0, scale
  ``127 / max|x|``); uint8 is zero-point-0 at ``min == 0`` (post-ReLU
  data).  Every float step runs in float32 in the reference's order of
  operations, so the integer tensors and the float ranges equal the
  reference's bit for bit.
* Every quantized op takes ``(qdata..., min..., max...)`` and returns
  ``(qout, out_min, out_max)``; an int32 accumulator reports the range
  ``±INT32_MAX / (scale_data * scale_weight)``, so ``dequantize`` of it
  is the float product.
* The products are s8×s8→s32 matrix products (``torch._int_mm``:
  cuBLASLt's int8 GEMM on the card, where the reference has XLA's
  ``dot_general``/``conv_general_dilated``).  The convolution is an
  int8 im2col followed by that product, group by group.  cuBLASLt wants
  more than 16 rows and inner and column sizes that are multiples of 8:
  the operands are padded with zero rows and columns, which adds 0 to
  every sum.  uint8 data (whose values reach 255) is shifted by -128
  into int8 and ``128 * sum(w)`` added back per output channel: exact
  in int32.  Pooling reads the windows of the integer tensor (max in
  its dtype, the average's sum in int32), as the reference's
  ``reduce_window`` does.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register
from ..base import MXNetError

_INT32_MAX = float(2 ** 31 - 1)


def _real_range(min_range, max_range):
    return torch.maximum(torch.abs(min_range), torch.abs(max_range))


def _rdiv(num, t):
    """``num / t`` as one IEEE division (torch computes a Python number
    over a tensor as ``num * (1 / t)``, which rounds twice)."""
    return torch.div(torch.full_like(t, num), t)


def _div(t, num):
    """``t / num`` as one IEEE division on every device (CUDA divides a
    tensor by a Python number as ``t * (1 / num)``, which rounds
    twice)."""
    return torch.div(t, torch.full_like(t, num))


def _scalar(v, like):
    """A float32 0-dim tensor of ``v`` on ``like``'s device, made by a
    fill (capturable in a CUDA graph; no host copy)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


@register("_contrib_quantize", num_outputs=3, no_grad=True,
          aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="uint8", **kw):
    """Quantize float to int8/uint8 given an explicit range."""
    if out_type == "int8":
        r = _real_range(min_range, max_range)
        scale = _rdiv(127.0, torch.clamp(r, min=1e-30))
        q = torch.clamp(torch.round(data * scale), -127, 127)
        return q.to(torch.int8), -r, r
    if out_type == "uint8":
        scale = _rdiv(255.0, torch.clamp(max_range - min_range, min=1e-30))
        q = torch.clamp(torch.round((data - min_range) * scale), 0, 255)
        return q.to(torch.uint8), min_range, max_range
    raise MXNetError("quantize: out_type must be int8/uint8")


@register("_contrib_quantize_v2", num_outputs=3, no_grad=True,
          aliases=("quantize_v2",))
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None, **kw):
    """Quantize with a calibrated or data-derived range; ``"auto"`` picks
    uint8 for a non-negative calibrated range, else int8."""
    if min_calib_range is None or max_calib_range is None:
        mn, mx = torch.amin(data), torch.amax(data)
    else:
        mn = _scalar(min_calib_range, data)
        mx = _scalar(max_calib_range, data)
    if out_type == "auto":
        if min_calib_range is not None and float(min_calib_range) >= 0:
            out_type = "uint8"
        else:
            out_type = "int8"
    if out_type == "uint8":
        # the uint8 product path is zero-point 0: the range is [0, max]
        if min_calib_range is not None and float(min_calib_range) < 0:
            raise MXNetError(
                "quantize_v2: out_type='uint8' needs a non-negative "
                "calibrated range (got min=%r); use int8 or 'auto'"
                % (min_calib_range,))
        mn = torch.zeros_like(mn)
    return quantize(data, mn, mx, out_type=out_type)


@register("_contrib_dequantize", no_grad=True, aliases=("dequantize",))
def dequantize(qdata, min_range, max_range, out_type="float32", **kw):
    """Int to float32."""
    if qdata.dtype == torch.uint8:
        scale = _div(max_range - min_range, 255.0)
        return qdata.to(torch.float32) * scale + min_range
    qrange = 127.0 if qdata.dtype == torch.int8 else _INT32_MAX
    r = _real_range(min_range, max_range)
    return qdata.to(torch.float32) * _div(r, qrange)


@register("_contrib_requantize", num_outputs=3, no_grad=True,
          aliases=("requantize",))
def requantize(qdata, min_range, max_range, min_calib_range=None,
               max_calib_range=None, **kw):
    """Int32 accumulator to int8, with a calibrated or runtime range."""
    r_in = _real_range(min_range, max_range)
    fdata = qdata.to(torch.float32) * _div(r_in, _INT32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        r_out = _scalar(max(abs(float(min_calib_range)),
                            abs(float(max_calib_range))), qdata)
    else:
        r_out = torch.clamp(torch.amax(torch.abs(fdata)), min=1e-30)
    q = torch.clamp(torch.round(fdata * _rdiv(127.0, r_out)), -127, 127)
    return q.to(torch.int8), -r_out, r_out


def _mul_out_range(min_a, max_a, min_b, max_b, qa=127.0):
    """Range of a q8 x s8 -> s32 product: ``±INT32_MAX / (sa * sb)``, and
    ``sa * sb`` (``qa``: 127 for int8 data, 255 for uint8)."""
    ra = _real_range(min_a, max_a)
    rb = _real_range(min_b, max_b)
    sa = _rdiv(qa, torch.clamp(ra, min=1e-30))
    sb = _rdiv(127.0, torch.clamp(rb, min=1e-30))
    r_out = _rdiv(_INT32_MAX, sa * sb)
    return -r_out, r_out, sa * sb


def _check_q8(name, data, weight):
    if data.dtype not in (torch.int8, torch.uint8):
        raise MXNetError("%s requires int8/uint8 data (got %s)"
                         % (name, data.dtype))
    if weight.dtype != torch.int8:
        raise MXNetError("%s requires int8 weight (got %s)"
                         % (name, weight.dtype))


def _data_qmax(data):
    return 255.0 if data.dtype == torch.uint8 else 127.0


def _round_up(n, m):
    return -(-n // m) * m


def int8_mm(a, b):
    """``a @ b`` for int8 ``a`` (M, K) and ``b`` (K, N), accumulated in
    int32 (``torch._int_mm``), the operands padded with zeros to more
    than 16 rows and to multiples of 8 in K and N."""
    M, K = a.shape
    N = b.shape[1]
    if a.device.type == "meta":
        return torch.empty((M, N), dtype=torch.int32, device="meta")
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        ap = torch.zeros((Mp, Kp), dtype=torch.int8, device=a.device)
        ap[:M, :K] = a
        a = ap
    if (Kp, Np) != (K, N):
        bp = torch.zeros((Kp, Np), dtype=torch.int8, device=b.device)
        bp[:K, :N] = b
        b = bp
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :N]


def _q8_product(x, w_t):
    """``x @ w_t`` for int8 or uint8 ``x`` (M, K) and int8 ``w_t`` (K, N):
    uint8 is shifted into int8 and ``128 * column sums`` added back."""
    if x.dtype == torch.uint8:
        xs = (x.to(torch.int16) - 128).to(torch.int8)
        return int8_mm(xs, w_t) + 128 * w_t.to(torch.int32).sum(
            0, dtype=torch.int32)
    return int8_mm(x, w_t)


def _bias32(bias, min_bias, max_bias, scale_out):
    """The int8 bias rescaled into the int32 accumulator's scale."""
    rb = _real_range(min_bias, max_bias)
    bias_f = bias.to(torch.float32) * _div(rb, 127.0)
    return torch.round(bias_f * scale_out).to(torch.int32)


@register("_contrib_quantized_fully_connected", num_outputs=3, no_grad=True,
          aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, bias=None, min_data=None,
                              max_data=None, min_weight=None,
                              max_weight=None, min_bias=None,
                              max_bias=None, num_hidden=None, no_bias=False,
                              flatten=True, **kw):
    """Int8 FullyConnected with int32 accumulation."""
    if no_bias and min_bias is None and bias is not None:
        # arity without bias: (data, weight, min_d, max_d, min_w, max_w)
        data, weight, min_data, max_data, min_weight, max_weight = (
            data, weight, bias, min_data, max_data, min_weight)
        bias = None
    _check_q8("quantized_fully_connected", data, weight)
    qa = _data_qmax(data)
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    out = _q8_product(x.reshape(-1, x.shape[-1]), weight.t())
    out = out.reshape(tuple(lead) + (weight.shape[0],))
    mn, mx, scale_out = _mul_out_range(min_data, max_data,
                                       min_weight, max_weight, qa=qa)
    if bias is not None and not no_bias:
        out = out + _bias32(bias, min_bias, max_bias, scale_out)
    return out, mn, mx


def _im2col(x, kernel, stride, pad, dilate):
    """(N, C, *S) -> (N * prod(out spatial), C * prod(kernel)), the
    padded input's windows in (C, taps) order, and the output spatial
    shape."""
    nd = len(kernel)
    if any(pad):
        shape = list(x.shape[:2]) + [s + 2 * p for s, p in
                                     zip(x.shape[2:], pad)]
        xp = torch.zeros(shape, dtype=x.dtype, device=x.device)
        xp[(slice(None), slice(None)) + tuple(
            slice(p, p + s) for p, s in zip(pad, x.shape[2:]))] = x
        x = xp
    for i in range(nd):
        span = (kernel[i] - 1) * dilate[i] + 1
        x = x.unfold(2 + i, span, stride[i])
    # x: (N, C, *O, *span); keep every dilate-th tap
    taps = (Ellipsis,) + tuple(slice(None, None, d) for d in dilate)
    x = x[taps]
    out_sp = list(x.shape[2:2 + nd])
    perm = [0] + list(range(2, 2 + nd)) + [1] + \
        list(range(2 + nd, 2 + 2 * nd))
    cols = x.permute(perm).reshape(
        x.shape[0] * int(_np.prod(out_sp)), -1)
    return cols, out_sp


@register("_contrib_quantized_conv", num_outputs=3, no_grad=True,
          aliases=("quantized_conv",))
def quantized_conv(data, weight, bias=None, min_data=None, max_data=None,
                   min_weight=None, max_weight=None,
                   min_bias=None, max_bias=None, kernel=None,
                   stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_filter=None,
                   num_group=1, no_bias=False, layout="NCHW", **kw):
    """Int8 convolution with int32 accumulation (NCHW in and out): an
    int8 im2col, then one s8 x s8 -> s32 product per group."""
    if no_bias and min_bias is None and bias is not None:
        data, weight, min_data, max_data, min_weight, max_weight = (
            data, weight, bias, min_data, max_data, min_weight)
        bias = None
    _check_q8("quantized_conv", data, weight)
    qa = _data_qmax(data)
    nsp = data.dim() - 2
    ksz = tuple(weight.shape[2:])
    stride = tuple(stride)[:nsp] or (1,) * nsp
    pad = tuple(pad)[:nsp] or (0,) * nsp
    dilate = tuple(dilate)[:nsp] or (1,) * nsp
    N, C = data.shape[:2]
    O = weight.shape[0]
    g = int(num_group)
    cg, og = C // g, O // g
    if data.device.type == "meta":
        out_sp = [(s + 2 * p - ((k - 1) * d + 1)) // st + 1 for s, p, k, d, st
                  in zip(data.shape[2:], pad, ksz, dilate, stride)]
        out = torch.empty([N, O] + out_sp, dtype=torch.int32, device="meta")
    else:
        parts = []
        for gi in range(g):
            cols, out_sp = _im2col(data[:, gi * cg:(gi + 1) * cg], ksz,
                                   stride, pad, dilate)
            w = weight[gi * og:(gi + 1) * og].reshape(og, -1)
            parts.append(_q8_product(cols, w.t()))
        out = parts[0] if g == 1 else torch.cat(parts, 1)
        out = out.reshape([N] + out_sp + [O]).permute(
            [0, nsp + 1] + list(range(1, nsp + 1))).contiguous()
    mn, mx, scale_out = _mul_out_range(min_data, max_data,
                                       min_weight, max_weight, qa=qa)
    if bias is not None and not no_bias:
        b32 = _bias32(bias, min_bias, max_bias, scale_out)
        out = out + b32.reshape((1, -1) + (1,) * nsp)
    return out, mn, mx


def _windows(x, kernel, stride, pad, value):
    """(N, C, *O, *kernel): every pooling window of ``x`` padded with
    ``value``."""
    if any(pad):
        shape = list(x.shape[:2]) + [n + 2 * p for n, p in
                                     zip(x.shape[2:], pad)]
        xp = torch.full(shape, value, dtype=x.dtype, device=x.device)
        xp[(slice(None), slice(None)) + tuple(
            slice(p, p + n) for p, n in zip(pad, x.shape[2:]))] = x
        x = xp
    for i, (k, st) in enumerate(zip(kernel, stride)):
        x = x.unfold(2 + i, k, st)
    return x


@register("_contrib_quantized_pooling", num_outputs=3, no_grad=True,
          aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=None, pool_type="max",
                      stride=None, pad=None, global_pool=False, **kw):
    """Max pooling of the int8 values (the window padded with the dtype's
    least value), or their window sum divided by the kernel's size and
    rounded (average, padding 0); the range is unchanged."""
    nsp = data.dim() - 2
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nsp
        pad = (0,) * nsp
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else kernel
    pad = tuple(pad) if pad else (0,) * nsp
    win = tuple(range(-nsp, 0))
    if pool_type == "max":
        low = int(torch.iinfo(data.dtype).min)
        out = torch.amax(_windows(data, kernel, stride, pad, low), dim=win)
    elif pool_type == "avg":
        s = torch.sum(_windows(data.to(torch.int32), kernel, stride, pad,
                               0), dim=win, dtype=torch.int32)
        out = torch.round(_div(s.to(torch.float32), float(_np.prod(kernel))))
        out = out.to(torch.int8)
    else:
        raise MXNetError("quantized_pooling: pool_type must be max/avg")
    return out, min_data, max_data


@register("_contrib_quantized_flatten", num_outputs=3, no_grad=True,
          aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data, **kw):
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_act", num_outputs=3, no_grad=True,
          aliases=("quantized_act",))
def quantized_act(data, min_data, max_data, act_type="relu", **kw):
    """Int8 relu: clamp at zero, range unchanged."""
    if act_type != "relu":
        raise MXNetError("quantized_act supports relu only")
    return torch.clamp(data, min=0), min_data, max_data
