"""Fused 3x3 convolution: the CUDA kernel wrapper and its plain version.

Port of ``mxnet_tpu/kernels/fused_conv.py``.  ``csrc/fused_conv.cu``
(:func:`conv3x3_fused`) replaces the Pallas kernel ``conv3x3_fused``
(pallas_call at :143, body ``_kernel`` :36): an implicit-GEMM 3x3
convolution, stride 1, SAME padding, NHWC input and HWIO weights, with

* an optional BN-apply prologue on the input read, ``x*scale + shift``
  in f32 (``scale``/``shift`` per input channel), then ``max(., 0)``
  with ``relu``; ``relu`` alone applies ``max(x, 0)``;
* the 1-pixel SAME halo zero *after* the prologue (the network pads the
  normalised activation);
* the normalised input rounded back to x's dtype before the products,
  products and sums in f32, ``y`` the f32 accumulator cast to
  ``out_dtype`` (default x's);
* with ``stats``, the per-output-channel sum and sum of squares of that
  f32 accumulator over B, H and W, returned as ``(y, sum, sumsq)`` with
  ``(K,)`` f32 sums.

``th`` and ``bk`` are the TPU kernel's tile sizes (rows per grid step,
output channels per block).  They are validated as the reference does
(defaults ``th = H if H <= 28 else 28`` and ``bk = min(K, 128)``; ``H``
a multiple of ``th`` and ``K`` of ``bk``, else ``MXNetError``) and do
not pick the CUDA kernel's tiling.

The plain version :func:`conv3x3_fused_reference` repeats the Pallas
body's arithmetic in torch ops: the prologue as two rounded ops, the
bf16 rounding, then nine f32 matrix products (one per tap) summed in
f32, with TF32 off.  It runs for CPU tensors; a CUDA tensor launches
the kernel or raises.  Each kernel launch adds one to
``conv3x3_fused.launches``.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build
from ._counters import register

__all__ = ["conv3x3_fused", "conv3x3_fused_reference"]

_TYPES = (torch.float32, torch.bfloat16)


def _check(x, w, scale, shift, th, bk, out_dtype):
    """Validated (th, bk, out_dtype), as the reference checks them."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                               x.shape[3]):
        raise MXNetError("conv3x3_fused: x must be (B, H, W, C) and w "
                         "(3, 3, C, K), got %s and %s"
                         % (tuple(x.shape), tuple(w.shape)))
    if (scale is None) != (shift is None):
        raise MXNetError("conv3x3_fused: scale and shift go together")
    C = x.shape[3]
    if scale is not None and (scale.numel() != C or shift.numel() != C):
        raise MXNetError("conv3x3_fused: scale and shift must have C = %d "
                         "values" % C)
    H, K = x.shape[1], w.shape[3]
    th = th or (H if H <= 28 else 28)
    bk = bk or min(K, 128)
    if H % th or K % bk:
        raise MXNetError("conv3x3_fused: H %% th and K %% bk must be 0, got "
                         "H=%d th=%d K=%d bk=%d" % (H, th, K, bk))
    return th, bk, out_dtype or x.dtype


@contextlib.contextmanager
def _full_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _prologue(x, scale, shift, relu):
    """The kernel's input: BN-apply and ReLU in f32, rounded back to x's
    dtype (x itself when neither is asked for)."""
    if scale is None and not relu:
        return x
    xf = x.float()
    if scale is not None:
        xf = xf * scale.float() + shift.float()
    if relu:
        xf = torch.clamp_min(xf, 0.0)
    return xf.to(x.dtype)


def conv3x3_fused_reference(x, w, scale=None, shift=None, relu=False,
                            stats=False, th=None, bk=None, out_dtype=None):
    """Plain version of the kernel, same arguments and results."""
    _, _, out_dtype = _check(x, w, scale, shift, th, bk, out_dtype)
    B, H, W, C = x.shape
    K = w.shape[3]
    xp = F.pad(_prologue(x, scale, shift, relu).float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros(B * H * W, K, dtype=torch.float32, device=x.device)
    with _full_f32():
        for dy in range(3):
            for dx in range(3):
                xt = xp[:, dy:dy + H, dx:dx + W, :].reshape(B * H * W, C)
                acc = acc + xt @ wf[dy, dx]
    acc = acc.reshape(B, H, W, K)
    y = acc.to(out_dtype)
    if stats:
        return y, acc.sum((0, 1, 2)), (acc * acc).sum((0, 1, 2))
    return y


def _fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load("fused_conv"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def conv3x3_fused(x, w, scale=None, shift=None, relu=False, stats=False,
                  th=None, bk=None, out_dtype=None):
    """3x3 stride-1 SAME convolution, NHWC x ``(B, H, W, C)`` and HWIO w
    ``(3, 3, C, K)``: ``y = conv(relu(x*scale + shift), w)`` with the
    prologue as asked; with ``stats`` returns ``(y, sum, sumsq)``, the
    channel sums of the f32 accumulator.  CUDA tensors (x and w both f32
    or both bf16, contiguous, one device; ``out_dtype`` f32 or bf16)
    launch ``csrc/fused_conv.cu``: bf16 x on the tensor cores at any
    width, f32 x on the CUDA cores, which refuse a width whose staged
    window does not fit in shared memory (W above 717) with
    ``cudaErrorInvalidValue``; CPU tensors run
    :func:`conv3x3_fused_reference`."""
    _, _, out_dtype = _check(x, w, scale, shift, th, bk, out_dtype)
    if x.device.type == "cpu":
        return conv3x3_fused_reference(x, w, scale, shift, relu, stats, th,
                                       bk, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("conv3x3_fused: unsupported device %s" % x.device)
    dev = x.device
    if x.dtype not in _TYPES or w.dtype != x.dtype or out_dtype not in _TYPES:
        raise ValueError("conv3x3_fused: x and w must both be float32 or "
                         "both bfloat16 and out_dtype one of them, got %s, %s"
                         " and %s" % (x.dtype, w.dtype, out_dtype))
    if w.device != dev or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3_fused: x and w must be contiguous and on "
                         "one device")
    B, H, W, C = x.shape
    K = w.shape[3]
    prologue = scale is not None
    if prologue:
        scale = scale.to(dev, torch.float32).contiguous()
        shift = shift.to(dev, torch.float32).contiguous()
    y = torch.empty(B, H, W, K, dtype=out_dtype, device=dev)
    bf16 = int(x.dtype == torch.bfloat16)
    part = sums = None
    if stats:
        rows = _fn("mxt_conv3x3_partials", [ctypes.c_int] * 5,
                   ctypes.c_longlong)(B, H, W, K, bf16)
        part = torch.empty(2, rows, K, dtype=torch.float32, device=dev)
        sums = torch.empty(2, K, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    vp, ci = ctypes.c_void_p, ctypes.c_int
    err = _fn("mxt_conv3x3", [vp] * 7 + [ci] * 10 + [vp])(
        x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift), y.data_ptr(),
        ptr(part), ptr(sums), B, H, W, C, K, bf16,
        int(out_dtype == torch.bfloat16), int(prologue), int(bool(relu)),
        int(bool(stats)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "conv3x3_fused at B=%d H=%d W=%d C=%d K=%d"
                 % (B, H, W, C, K))
    conv3x3_fused.launches += 1
    if stats:
        return y, sums[0], sums[1]
    return y


register(conv3x3_fused, "launches")
