"""Flash attention, forward and backward: CUDA kernel wrappers, plain
versions, the positional-hash dropout and the autograd Function.

Port of ``mxnet_tpu/kernels/flash_attention.py``.  Three kernels replace
the reference's three Pallas kernels:

* ``csrc/flash_fwd.cu`` (:func:`flash_fwd`) replaces ``_flash_fwd_tpu``;
  its plain version :func:`flash_fwd_reference` is the port of
  ``_reference_attention`` (f32 softmax cast to q's dtype, the dense
  keep mask) plus the same per-row logsumexp;
* ``csrc/flash_bwd.cu`` ``mxt_flash_bwd_dq`` (:func:`flash_bwd_dq`)
  replaces the dQ kernel ``_bwd_dq_kernel``;
* ``csrc/flash_bwd.cu`` ``mxt_flash_bwd_dkv`` (:func:`flash_bwd_dkv`)
  replaces the dK/dV kernel ``_bwd_dkv_kernel``.

In bf16 all three run on the tensor cores (``mma.sync``,
``csrc/flash_mma.cuh``); in f32 on the CUDA cores.

The plain backward versions recompute P densely from lse, as the
kernels do blockwise.  Every wrapper runs its plain version for CPU
tensors only; a CUDA tensor launches the kernel or raises, and each
wrapper counts its launches in ``.launches``.  The kernels run at every
sequence length: the reference's TPU crossover ``MXNET_FLASH_MIN_SEQ``
is not carried over.

Dropout is the reference's positional hash (:func:`_dropout_keep`):
the keep bit of a (b*H + h, query, key) triple is a function of the
positions and an int32 seed, so the forward and both backward kernels
regenerate the same mask and nothing is stored.  The torch version
emulates uint32 arithmetic in int64, masking the low 32 bits after
every product (int64 products wrap mod 2^64, so their low 32 bits are
exact), and is bit-identical to the reference's.  The seed is an int32
tensor that the kernels read from device memory, so a seed drawn on
the card costs no host sync.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from ._counters import register

__all__ = ["flash_attention", "flash_fwd", "flash_fwd_reference",
           "flash_bwd_dq", "flash_bwd_dq_reference", "flash_bwd_dkv",
           "flash_bwd_dkv_reference", "dense_keep_mask"]

_U32 = 0xFFFFFFFF


def _dropout_keep(bh, q_pos, k_pos, seed, rate):
    """(len(q_pos), len(k_pos)) bool keep mask of head row ``bh``: the
    reference ``_dropout_keep`` bit for bit.  ``bh`` and ``seed`` are
    ints or int tensors broadcastable against (Q, K); positions are
    absolute int tensors."""
    def u32(x):
        return torch.as_tensor(x, device=q_pos.device).to(torch.int64) & _U32

    x = ((u32(q_pos)[:, None] * 2654435761) & _U32) \
        ^ ((u32(k_pos)[None, :] * 97780813) & _U32) \
        ^ ((u32(bh) * 2246822519) & _U32) ^ u32(seed)
    x = ((x ^ (x >> 16)) * 2246822519) & _U32
    x = ((x ^ (x >> 13)) * 3266489917) & _U32
    x = x ^ (x >> 16)
    return x >= min(int(rate * 4294967296.0), 4294967295)


def dense_keep_mask(B, H, T, seed, rate, device=None):
    """Dense (B, H, T, T) keep mask, the reference ``dense_keep_mask``:
    the same stream the kernels regenerate from positions.  ``seed``:
    an int or an int32 tensor of one element (read on its device, with
    no host sync)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device
        seed = seed.reshape(())
    pos = torch.arange(T, device=device)
    bh = torch.arange(B * H, device=device)[:, None, None]
    keep = _dropout_keep(bh, pos, pos, seed, float(rate))
    return keep.reshape(B, H, T, T)


def _inv_keep(rate):
    """float32(1 / (1 - rate)): the reference's Python-float scale as
    the f32 kernels see it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _valid(q, mask, causal):
    """(B or 1, 1, T, T) bool: the key mask and the causal triangle."""
    T = q.shape[1]
    valid = torch.ones(1, 1, T, T, dtype=torch.bool, device=q.device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)[:, None, None, :]
    if causal:
        valid = valid & torch.ones(T, T, dtype=torch.bool,
                                   device=q.device).tril()
    return valid


def flash_fwd_reference(q, k, v, mask=None, causal=False, dropout=0.0,
                        seed=None):
    """Plain version: (B, T, H, dh) attention -> (O in q's dtype,
    lse (B, H, T) f32).  Logits in q's dtype, masked entries -1e30,
    softmax in float32 cast back to q's dtype, then the dropout of
    ``_reference_attention`` (keep mask, cast, times 1/(1-rate) in q's
    dtype).  lse is the undropped logsumexp."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    logits = logits.masked_fill(~_valid(q, mask, causal), -1e30)
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1).to(q.dtype)
    if dropout > 0.0:
        B, T, H, _ = q.shape
        keep = dense_keep_mask(B, H, T, seed, dropout, q.device)
        probs = probs.masked_fill(~keep, 0) * (1.0 / (1.0 - dropout))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out, torch.logsumexp(lf, dim=-1)


def _bwd_dense(q, k, v, do, lse, delta, mask, causal, dropout, seed):
    """The backward kernels' arithmetic, dense: (P, P~, dP~, dS), each
    (B, H, T, T) f32.  P = exp(s*scale - lse) where valid, else 0;
    P~ = keep*P/(1-rate); dP~ = keep*dP/(1-rate) with dP = dO V^T;
    dS = P*(dP~ - delta)*scale."""
    dh = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    p = torch.where(_valid(q, mask, causal), torch.exp(s - lse[..., None]),
                    0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    p_drop = p
    if dropout > 0.0:
        B, T, H, _ = q.shape
        keep = dense_keep_mask(B, H, T, seed, dropout, q.device)
        inv = _inv_keep(dropout)
        p_drop = torch.where(keep, p, 0.0) * inv
        dp = torch.where(keep, dp, 0.0) * inv
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, p_drop, dp, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, mask=None,
                           causal=False, dropout=0.0, seed=None):
    """Plain version of the dQ kernel: dQ = dS K with dS rounded to K's
    dtype and an f32 product, as ``_bwd_dq_kernel``."""
    ds = _bwd_dense(q, k, v, do, lse, delta, mask, causal, dropout,
                    seed)[3]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, mask=None,
                            causal=False, dropout=0.0, seed=None):
    """Plain version of the dK/dV kernel: dV = P~^T dO (P~ rounded to
    dO's dtype), dK = dS^T Q (dS rounded to Q's dtype), f32 products,
    as ``_bwd_dkv_kernel``."""
    _, p_drop, _, ds = _bwd_dense(q, k, v, do, lse, delta, mask, causal,
                                  dropout, seed)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(do.dtype).float(),
                      do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------- kernels --
def _fn(lib, name, nptr):
    """ctypes entry ``name`` of ``lib``: ``nptr`` pointers, five ints
    (B, T, H, dh, causal) and bf16, sm_scale, the seed pointer, the
    dropout flag, its threshold and scale, and the stream."""
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_uint, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(what, q, others, mask, seed, dropout):
    """Raise on what the kernels do not take; return the int8 (B, T)
    key mask and the trailing ctypes arguments (causal excluded)."""
    if q.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, q.device))
    if q.dim() != 4:
        raise ValueError("%s: q must be (B, T, H, dh), got %s"
                         % (what, tuple(q.shape)))
    B, T, H, dh = q.shape
    for name, x in others:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError("%s: %s %s/%s/%s does not match q %s/%s/%s"
                             % (what, name, tuple(x.shape), x.dtype,
                                x.device, tuple(q.shape), q.dtype, q.device))
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("%s: dtype %s not supported (float32, bfloat16)"
                         % (what, q.dtype))
    if dh not in (64, 128, 256):
        raise ValueError("%s: head dim %d not supported (64, 128, 256)"
                         % (what, dh))
    if not all(x.is_contiguous() for x in [q] + [x for _, x in others]):
        raise ValueError("%s: q, k, v (and dO) must be contiguous" % what)
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 for x in [q] + [x for _, x in others]):
        raise ValueError("%s: bf16 q, k, v (and dO) must start 16-byte "
                         "aligned (the kernels copy 16-byte pieces)" % what)
    if mask is None:
        m8 = torch.ones(B, T, dtype=torch.int8, device=q.device)
    else:
        if tuple(mask.shape) != (B, T) or mask.device != q.device:
            raise ValueError("%s: mask must be (B, T) on %s, got %s on %s"
                             % (what, q.device, tuple(mask.shape),
                                mask.device))
        m8 = (mask != 0).to(torch.int8).contiguous()
    if dropout > 0.0:
        if (seed is None or seed.device != q.device
                or seed.dtype != torch.int32 or seed.numel() != 1):
            raise ValueError("%s: dropout needs an int32 seed tensor of "
                             "one element on %s" % (what, q.device))
        tail = (seed.data_ptr(), 1,
                min(int(dropout * 4294967296.0), 4294967295),
                _inv_keep(dropout))
    else:
        tail = (None, 0, 0, 1.0)
    return m8, (B, T, H, dh), tail


def _stats(q, lse, delta):
    B, T, H, _ = q.shape
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != (B, H, T) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError("flash backward: %s must be contiguous (B, H, "
                             "T) float32 on %s" % (name, q.device))


def flash_fwd(q, k, v, mask=None, causal=False, dropout=0.0, seed=None):
    """(B, T, H, dh) attention forward -> (O, lse (B, H, T) f32).

    CUDA tensors launch ``csrc/flash_fwd.cu`` (f32 or bf16, dh 64,
    128 or 256, any T, contiguous, bf16 16-byte aligned; with
    ``dropout > 0`` an int32 ``seed`` tensor on the same device); CPU
    tensors run :func:`flash_fwd_reference`.  ``flash_fwd.launches``
    counts kernel launches."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask=mask, causal=causal,
                                   dropout=dropout, seed=seed)
    m8, (B, T, H, dh), tail = _check("flash_fwd", q, (("k", k), ("v", v)),
                                     mask, seed, dropout)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn("flash_fwd", "mxt_flash_fwd", 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m8.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, T, H, dh, int(bool(causal)),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), *tail, stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, mask=None, causal=False,
                 dropout=0.0, seed=None):
    """dQ of the attention whose forward gave ``lse``; ``delta`` is
    rowsum(dO * O) (B, H, T) f32.  CUDA tensors launch
    ``csrc/flash_bwd.cu`` ``mxt_flash_bwd_dq``; CPU tensors run
    :func:`flash_bwd_dq_reference`.  ``flash_bwd_dq.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, mask=mask,
                                      causal=causal, dropout=dropout,
                                      seed=seed)
    m8, (B, T, H, dh), tail = _check(
        "flash_bwd_dq", q, (("k", k), ("v", v), ("dO", do)), mask, seed,
        dropout)
    _stats(q, lse, delta)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn("flash_bwd", "mxt_flash_bwd_dq", 8)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), m8.data_ptr(), dq.data_ptr(),
        B, T, H, dh, int(bool(causal)), int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(dh), *tail, stream)
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, mask=None, causal=False,
                  dropout=0.0, seed=None):
    """(dK, dV) of the attention whose forward gave ``lse``; arguments
    as :func:`flash_bwd_dq`.  CUDA tensors launch ``csrc/flash_bwd.cu``
    ``mxt_flash_bwd_dkv``; CPU tensors run
    :func:`flash_bwd_dkv_reference`.  ``flash_bwd_dkv.launches`` counts
    kernel launches."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, mask=mask,
                                       causal=causal, dropout=dropout,
                                       seed=seed)
    m8, (B, T, H, dh), tail = _check(
        "flash_bwd_dkv", q, (("k", k), ("v", v), ("dO", do)), mask, seed,
        dropout)
    _stats(q, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn("flash_bwd", "mxt_flash_bwd_dkv", 9)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), m8.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, T, H, dh, int(bool(causal)),
        int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), *tail, stream)
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


register(flash_fwd, "launches")
register(flash_bwd_dq, "launches")
register(flash_bwd_dkv, "launches")


def _aligned(x):
    """``x`` as the kernels take it: contiguous, and a bf16 tensor that
    does not start 16-byte aligned copied to one that does (a copy
    inside autograd, so gradients flow back to ``x``).  The reference
    computes any view; the low-level wrappers refuse a misaligned one."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


class _Flash(torch.autograd.Function):
    """The reference ``_make_flash`` custom VJP: the forward saves q, k,
    v, mask, seed, O and lse; the backward reduces delta = rowsum(dO*O)
    in torch and calls the dQ and dK/dV wrappers."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, dropout):
        out, lse = flash_fwd(q, k, v, mask=mask, causal=causal,
                             dropout=dropout, seed=seed)
        ctx.save_for_backward(q, k, v, mask, seed, out, lse)
        ctx.causal, ctx.dropout = causal, dropout
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, mask, seed, out, lse = ctx.saved_tensors
        g = _aligned(g)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()                                    # (B, H, T)
        kw = dict(mask=mask, causal=ctx.causal, dropout=ctx.dropout,
                  seed=seed)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, mask=None, causal=False, dropout=0.0,
                    dropout_seed=None):
    """(B, T, H, dh) attention; ``causal=True`` adds the lower-triangular
    mask, ``mask`` (B, T) drops padded keys.  Returns O in q's dtype.

    ``dropout > 0`` drops attention probabilities inside the kernels
    by the positional hash keyed by ``dropout_seed`` (an int, or an
    int32 tensor of one element; required when dropout > 0).  Gradients
    flow to q, k and v through the dQ and dK/dV kernels (their plain
    versions for CPU tensors)."""
    dropout = float(dropout)
    if not 0.0 <= dropout < 1.0:
        raise ValueError("flash_attention: dropout must be in [0, 1), "
                         "got %r" % dropout)
    seed = None
    if dropout > 0.0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout > 0 requires "
                             "dropout_seed")
        seed = torch.as_tensor(dropout_seed, device=q.device) \
            .to(torch.int32).reshape(1)
    return _Flash.apply(_aligned(q), _aligned(k), _aligned(v), mask, seed,
                        bool(causal), dropout)
