"""Paged single-token attention: CUDA kernel wrapper and plain version.

Port of ``mxnet_tpu/kernels/paged_attention.py``.  The kernel
(``csrc/paged_attention.cu``) replaces the Pallas block-table walk; its
plain version :func:`paged_attention_reference` is the reference's
gather + ``_attend_rows``.  The serving engine always calls
:func:`paged_attention`: CUDA tensors launch the kernel, CPU tensors
run the plain version, and nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_reference"]

# the kernel stages (dh + ps*2*dh + 3*ps) f32 per block in shared memory
_SMEM_LIMIT = 227 * 1024


def paged_attention_reference(q, pool_kv, pool_s, block_tables, row_pos,
                              *, page_size):
    """Plain version: gather each row's pages into a (T*H, L, 2*dh)
    view and run ``models/gpt.py _attend_rows`` with per-row
    positions.  Returns (T, H, dh) f32."""
    from ..models.gpt import _attend_rows

    T, H, dh = q.shape
    PP = block_tables.shape[1]
    L = PP * page_size
    bt = block_tables.long()
    ckv = pool_kv[bt].permute(0, 3, 1, 2, 4).reshape(T * H, L, 2 * dh)
    cs = None
    if pool_s is not None:
        # (T, PP, 2, ps, H) -> per-token (k, v) scale pairs
        cs = pool_s[bt].permute(0, 4, 1, 3, 2).reshape(T * H, L, 2)
    pos_r = row_pos.long().repeat_interleave(H)
    out = _attend_rows(q.reshape(T * H, dh), ckv, cs, pos_r, dh)
    return out.reshape(T, H, dh)


_SIG = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                     ctypes.c_void_p]


def _lib():
    lib = _build.load("paged_attention")
    fn = lib.mxt_paged_attention
    if fn.argtypes is None:
        fn.argtypes = _SIG
        fn.restype = ctypes.c_int
    return fn


def _check_args(q, pool_kv, pool_s, bt, pos, page_size):
    T, H, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("paged_attention: q dtype %s not supported "
                         "(float32, bfloat16)" % q.dtype)
    int8 = pool_s is not None
    want = torch.int8 if int8 else q.dtype
    if pool_kv.dtype != want:
        raise ValueError("paged_attention: pool dtype %s, expected %s"
                         % (pool_kv.dtype, want))
    if int8 and (pool_s.dtype != torch.float32 or tuple(pool_s.shape) != (
            pool_kv.shape[0], 2, page_size, H)):
        raise ValueError("paged_attention: scales %s/%s are not f32 "
                         "(pages, 2, %d, %d)" % (tuple(pool_s.shape),
                                                 pool_s.dtype, page_size, H))
    if bt.dtype != torch.int32 or bt.dim() != 2 or bt.shape[0] != T:
        raise ValueError("paged_attention: block table must be int32 "
                         "(%d, PP), got %s/%s" % (T, tuple(bt.shape),
                                                  bt.dtype))
    if pos.dtype != torch.int32 or tuple(pos.shape) != (T,):
        raise ValueError("paged_attention: positions must be int32 (%d,),"
                         " got %s/%s" % (T, tuple(pos.shape), pos.dtype))
    tensors = [q, pool_kv, bt, pos] + ([pool_s] if int8 else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all inputs must be on %s"
                         % q.device)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    if dh > 256 or (dh + 2 * page_size * dh + 3 * page_size) * 4 \
            > _SMEM_LIMIT:
        raise ValueError("paged_attention: dh=%d, page_size=%d exceed the"
                         " kernel's shared memory" % (dh, page_size))


def paged_attention(q, pool_kv, pool_s, block_tables, row_pos, *,
                    page_size):
    """Single-token attention over paged K/V via a block-table walk.

    q: (T, H, dh) queries in the compute dtype; pool_kv: (pages,
    page_size, H, 2*dh) in the compute dtype, or int8 with pool_s:
    (pages, 2, page_size, H) f32 scale planes (k plane 0, v plane 1);
    block_tables: (T, PP) int32 page ids per row (unused entries point
    at scratch page 0); row_pos: (T,) int32 — row t attends to
    positions <= row_pos[t].  Returns (T, H, dh) f32.

    CUDA tensors launch ``csrc/paged_attention.cu``; CPU tensors run
    :func:`paged_attention_reference`.  ``paged_attention.launches``
    counts kernel launches."""
    T, H, dh = q.shape
    if pool_kv.dim() != 4 or tuple(pool_kv.shape[1:]) != (
            page_size, H, 2 * dh):
        raise ValueError("paged_attention: pool %s is not (pages, %d, %d,"
                         " %d)" % (tuple(pool_kv.shape), page_size, H,
                                   2 * dh))
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_kv, pool_s,
                                          block_tables, row_pos,
                                          page_size=page_size)
    if q.device.type != "cuda":
        raise ValueError("paged_attention: unsupported device %s"
                         % q.device)
    _check_args(q, pool_kv, pool_s, block_tables, row_pos, page_size)
    out = torch.empty(T, H, dh, dtype=torch.float32, device=q.device)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    int8 = pool_s is not None
    err = fn(q.data_ptr(), pool_kv.data_ptr(),
             pool_s.data_ptr() if int8 else None,
             block_tables.data_ptr(), row_pos.data_ptr(), out.data_ptr(),
             T, H, dh, page_size, block_tables.shape[1],
             int(q.dtype == torch.bfloat16), int(int8),
             float(np.sqrt(np.float32(dh))), stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
