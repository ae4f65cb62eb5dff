"""Greedy non-maximum suppression: the CUDA kernel wrapper and its plain
version.

``csrc/nms.cu`` (:func:`nms_keep`) replaces no TPU kernel: the
reference's ``_nms_keep`` (``mxnet_tpu/ops/vision.py:108``) is a
``lax.scan`` over the rows of an N x N suppression matrix that XLA
compiles.  As torch ops that scan is a Python loop of N steps with
several launches each, so the port computes the keep mask in one
kernel call (two launches: the suppression bitmask, then one warp per
image sweeping the rows in score order).  ``box_nms``,
``MultiBoxDetection``, ``Proposal`` and ``MultiProposal`` call it.

The keep rule, for boxes sorted by score within each image::

    keep[i] = valid[i] and no j < i has keep[j], IoU(j, i) > thresh
              and (ids is None or ids[j] == ids[i])

with the reference's IoU arithmetic (``_pairwise_iou``) in f32.  The
plain version :func:`nms_keep_reference` walks the rows in order, each
row's IoU against the earlier boxes computed on the fly (the same
function as the reference's scan, without its N x N matrix); CPU tensors
use it, and a CUDA tensor launches the kernel or raises.
``nms_keep.launches`` counts kernel calls on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counters import register

__all__ = ["nms_keep", "nms_keep_reference", "pairwise_iou"]


def pairwise_iou(lhs, rhs):
    """IoU between (..., A, 4) and (..., B, 4) corner boxes -> (..., A,
    B), the reference ``_pairwise_iou`` op for op."""
    lt = torch.maximum(lhs[..., :, None, :2], rhs[..., None, :, :2])
    rb = torch.minimum(lhs[..., :, None, 2:], rhs[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = torch.clamp_min(lhs[..., 2] - lhs[..., 0], 0.0) * \
        torch.clamp_min(lhs[..., 3] - lhs[..., 1], 0.0)
    area_r = torch.clamp_min(rhs[..., 2] - rhs[..., 0], 0.0) * \
        torch.clamp_min(rhs[..., 3] - rhs[..., 1], 0.0)
    union = area_l[..., :, None] + area_r[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _check(boxes, valid, ids):
    if boxes.dim() != 3 or boxes.shape[-1] != 4 \
            or boxes.dtype != torch.float32:
        raise ValueError("nms_keep: boxes must be (B, N, 4) float32, got "
                         "%s %s" % (boxes.dtype, tuple(boxes.shape)))
    B, N, _ = boxes.shape
    if valid.shape != (B, N) or valid.dtype != torch.bool:
        raise ValueError("nms_keep: valid must be (B, N) bool, got %s %s"
                         % (valid.dtype, tuple(valid.shape)))
    if ids is not None and (ids.shape != (B, N)
                            or ids.dtype != torch.float32):
        raise ValueError("nms_keep: ids must be (B, N) float32, got %s %s"
                         % (ids.dtype, tuple(ids.shape)))
    for name, t in (("valid", valid), ("ids", ids)):
        if t is not None and t.device != boxes.device:
            raise ValueError("nms_keep: %s on %s, boxes on %s"
                             % (name, t.device, boxes.device))


def nms_keep_reference(boxes, valid, ids, thresh):
    """Plain version of the kernel: boxes (B, N, 4) f32 corner boxes
    sorted by score, valid (B, N) bool, ids (B, N) f32 or None (suppress
    across classes) -> keep (B, N) bool.  Row i's IoU against the rows
    before it is the reference's ``_pairwise_iou(boxes, boxes)[:i, i]``."""
    _check(boxes, valid, ids)
    B, N, _ = boxes.shape
    keep = torch.zeros(B, N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        iou = pairwise_iou(boxes[:, :i], boxes[:, i:i + 1])[..., 0]
        sup = keep[:, :i] & (iou > thresh)
        if ids is not None:
            sup = sup & (ids[:, :i] == ids[:, i:i + 1])
        keep[:, i] = valid[:, i] & ~sup.any(dim=1)
    return keep


# nms_sweep keeps one bit per box of its image in shared memory, and a
# block on sm_90 may opt in to 227 KiB of it: 29056 words of 64 boxes
_MAX_WORDS = 227 * 1024 // 8


def _fn():
    fn = _build.load("nms").mxt_nms_keep
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       p, p, p]
        fn.restype = ctypes.c_int
    return fn


def nms_keep(boxes, valid, ids, thresh):
    """Keep mask (B, N) bool of greedy NMS over score-sorted boxes (see
    :func:`nms_keep_reference`).  CUDA tensors launch ``csrc/nms.cu``
    (contiguous f32 boxes; at most 65535 images of 1859584 boxes, and
    the scratch bitmask takes B * N * ceil(N / 64) * 8 bytes); CPU
    tensors run the plain version."""
    if boxes.device.type == "cpu":
        return nms_keep_reference(boxes, valid, ids, thresh)
    _check(boxes, valid, ids)
    B, N, _ = boxes.shape
    if (N + 63) // 64 > _MAX_WORDS or B > 65535:
        raise ValueError("nms_keep: at most 65535 images of %d boxes, got "
                         "(%d, %d)" % (_MAX_WORDS * 64, B, N))
    if boxes.device.type == "meta":             # shape inference only
        return torch.empty(B, N, dtype=torch.bool, device="meta")
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:                   # the kernel reads float4
        boxes = boxes.clone()
    valid = valid.contiguous()
    ids = None if ids is None else ids.contiguous()
    keep = torch.empty(B, N, dtype=torch.bool, device=boxes.device)
    if B * N == 0:
        return keep
    words = (N + 63) // 64
    mask = torch.empty(B, N, words, dtype=torch.int64, device=boxes.device)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    err = _fn()(boxes.data_ptr(), valid.data_ptr(),
                None if ids is None else ids.data_ptr(), B, N, float(thresh),
                mask.data_ptr(), keep.data_ptr(), stream)
    _build.check(err, "nms_keep")
    nms_keep.launches += 1
    return keep


register(nms_keep, "launches")
