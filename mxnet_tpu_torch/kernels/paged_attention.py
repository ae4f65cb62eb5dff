"""Paged single-token attention: CUDA kernel wrapper and plain version.

Port of ``mxnet_tpu/kernels/paged_attention.py``.  The kernels
(``csrc/paged_attention.cu``) replace the Pallas block-table walk with a
flash-decoding split: ``paged_split`` walks runs of :func:`split_pages`
pages per (row, head) in parallel and writes partial (max, sum,
accumulator) rows to a workspace, and ``paged_combine`` merges the live
ones in a fixed order.  Their plain version
:func:`paged_attention_reference` is the reference's gather +
``_attend_rows``.  The serving engine always calls
:func:`paged_attention`: CUDA tensors launch the kernels, CPU tensors
run the plain version, and nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ._counters import register

__all__ = ["paged_attention", "paged_attention_reference", "split_pages",
           "vector_loads"]

_SMEM_LIMIT = 227 * 1024
_SPLIT_POSITIONS = 64     # positions a split walks, about
_NT = 128                 # threads of a split block (csrc NT)


def split_pages(page_size):
    """Pages per split of the kernel's walk: about 64 positions, at
    least one page.  A function of the page size alone, so the split
    count ceil(PP / split_pages) comes from the block table's shape and
    the host reads no device data."""
    return max(1, _SPLIT_POSITIONS // page_size)


def vector_loads(pool_kv, dh):
    """True when the kernels read the pool's k and v rows in 16-byte
    pieces: the pool starts 16-byte aligned and a k (or v) half row,
    dh * element size bytes, is a multiple of 16.  Else they take their
    scalar load loop, with the same arithmetic."""
    return (pool_kv.data_ptr() % 16 == 0
            and dh * pool_kv.element_size() % 16 == 0)


def _smem_bytes(dh, page_size, elem, vec):
    """Dynamic shared memory of a split block (csrc split_smem_words):
    q, the scores and v scales of a split, 8 reduce slots, the PV
    partials of its position groups and the page ids, 4 bytes each."""
    pieces = dh // (16 // elem) if vec else dh
    groups = 1 if pieces >= _NT else _NT // pieces
    pps = split_pages(page_size)
    return 4 * (dh + 2 * pps * page_size + 8 + groups * dh + pps)


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


_SIG = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float,
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
    if dh > 256 or _smem_bytes(dh, page_size, pool_kv.element_size(),
                               vector_loads(pool_kv, dh)) > _SMEM_LIMIT:
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

    CUDA tensors launch ``csrc/paged_attention.cu`` (the split and the
    combine kernel, 16-byte loads where :func:`vector_loads` allows);
    CPU tensors run :func:`paged_attention_reference`.
    ``paged_attention.launches`` counts calls that launched the
    kernels."""
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
    PP = block_tables.shape[1]
    pps = split_pages(page_size)
    part = torch.empty(T, H, -(-PP // pps), dh + 2, dtype=torch.float32,
                       device=q.device)
    out = torch.empty(T, H, dh, dtype=torch.float32, device=q.device)
    fn = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    int8 = pool_s is not None
    err = fn(q.data_ptr(), pool_kv.data_ptr(),
             pool_s.data_ptr() if int8 else None,
             block_tables.data_ptr(), row_pos.data_ptr(), part.data_ptr(),
             out.data_ptr(), T, H, dh, page_size, PP, pps,
             int(q.dtype == torch.bfloat16), int(int8),
             int(vector_loads(pool_kv, dh)),
             float(np.sqrt(np.float32(dh))), stream)
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


register(paged_attention, "launches")
