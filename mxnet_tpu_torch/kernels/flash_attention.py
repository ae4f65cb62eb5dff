"""Flash-attention forward: CUDA kernel wrapper, plain version, dispatch.

Port of ``mxnet_tpu/kernels/flash_attention.py``'s forward.  The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas ``_flash_fwd_tpu``; its
plain version :func:`flash_fwd_reference` is the port of
``_reference_attention`` (f32 softmax cast to q's dtype) plus the same
per-row logsumexp.

:func:`flash_fwd` launches the kernel for CUDA tensors — at every
sequence length: the reference's TPU crossover ``MXNET_FLASH_MIN_SEQ``
is not carried over, the card's own crossover is a later, measured
decision — and runs the plain version for CPU tensors only.  Dropout
(the reference's positional-hash dropout) and the two backward kernels
belong to the training slice; ``dropout > 0`` raises until then.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_reference"]


def flash_fwd_reference(q, k, v, mask=None, causal=False):
    """Plain version: (B, T, H, dh) attention -> (O in q's dtype,
    lse (B, H, T) f32).  Logits in q's dtype, masked entries -1e30,
    softmax in float32 cast back to q's dtype, as the reference does."""
    dh = q.shape[-1]
    T = q.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        keep = mask.to(torch.bool)[:, None, None, :]
        logits = logits.masked_fill(~keep, -1e30)
    if causal:
        tri = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~tri[None, None], -1e30)
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out, torch.logsumexp(lf, dim=-1)


_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p]


def _lib():
    lib = _build.load("flash_fwd")
    fn = lib.mxt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q, k, v, mask=None, causal=False):
    """(B, T, H, dh) attention forward -> (O, lse (B, H, T) f32).

    CUDA tensors launch ``csrc/flash_fwd.cu`` (f32 or bf16, dh 64 or
    128, any T, contiguous); CPU tensors run
    :func:`flash_fwd_reference`.  ``flash_fwd.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask=mask, causal=causal)
    if q.device.type != "cuda":
        raise ValueError("flash_fwd: unsupported device %s" % q.device)
    if q.dim() != 4:
        raise ValueError("flash_fwd: q must be (B, T, H, dh), got %s"
                         % (tuple(q.shape),))
    B, T, H, dh = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("flash_fwd: %s %s/%s/%s does not match q "
                             "%s/%s/%s" % (name, tuple(x.shape), x.dtype,
                                           x.device, tuple(q.shape),
                                           q.dtype, q.device))
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_fwd: dtype %s not supported (float32, "
                         "bfloat16)" % q.dtype)
    if dh not in (64, 128):
        raise ValueError("flash_fwd: head dim %d not supported (64, 128)"
                         % dh)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k and v must be contiguous")
    if mask is None:
        m8 = torch.ones(B, T, dtype=torch.int8, device=q.device)
    else:
        if tuple(mask.shape) != (B, T) or mask.device != q.device:
            raise ValueError("flash_fwd: mask must be (B, T) on %s, got "
                             "%s on %s" % (q.device, tuple(mask.shape),
                                           mask.device))
        m8 = (mask != 0).to(torch.int8).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
             out.data_ptr(), lse.data_ptr(), B, T, H, dh, int(bool(causal)),
             int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention(q, k, v, mask=None, causal=False, dropout=0.0,
                    dropout_seed=None):
    """(B, T, H, dh) attention; ``causal=True`` adds the lower-triangular
    mask, ``mask`` (B, T) drops padded keys.  Returns O in q's dtype.
    ``dropout > 0`` is not ported yet (training slice)."""
    dropout = float(dropout)
    if not 0.0 <= dropout < 1.0:
        raise ValueError("flash_attention: dropout must be in [0, 1), "
                         "got %r" % dropout)
    if dropout > 0.0:
        raise NotImplementedError("training slice")
    return flash_fwd(q, k, v, mask=mask, causal=causal)[0]
