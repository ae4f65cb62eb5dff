"""Vision and detection operators: ``box_iou``/``box_nms``, the SSD ops
(``MultiBoxPrior``, ``MultiBoxTarget``, ``MultiBoxDetection``), the ROI
ops, the spatial-transformer family, ``BilinearResize2D``,
``AdaptiveAvgPooling2D``, ``Correlation`` and ``SVMOutput``.

Port of ``mxnet_tpu/ops/vision.py``, name for name, with its static
output shapes: NMS keeps the input's rank and marks suppressed rows,
and nothing reads a value back to the host or copies from it, so the
ops run inside a captured CUDA graph (a bound Executor, a hybridized
block).  Where the reference ``vmap``s over images or ROIs, the port
writes the batch axis out.  Greedy NMS goes through
``kernels/nms.py`` (a hand-written kernel on the card, its plain
version on the CPU); the rest are torch ops, as the reference leaves
them to XLA.

Ties follow the reference: ``jnp.argsort`` is stable (a stable
``torch.sort``) and ``jnp.argmax`` takes the first maximum, as
``torch.argmax`` does.  Where two ground-truth boxes of
``MultiBoxTarget`` claim the same anchor, the later one wins, as XLA
applies the reference's scatter (``scatter_reduce`` with ``amax`` over
the box index, the same on every device).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..kernels.nms import nms_keep
from ..kernels.nms import pairwise_iou as _pairwise_iou
from .registry import register


def _device_floats(values, device):
    """A float32 vector of Python numbers, made on ``device`` by fills (a
    host-to-device copy would break a CUDA graph's capture)."""
    out = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, v in enumerate(values):
        out[i].fill_(float(v))
    return out


def _to_corner(box, fmt):
    """(..., 4) boxes -> corner (xmin, ymin, xmax, ymax)."""
    if fmt == "corner":
        return box
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _bilinear_gather(data, b, y, x, border="clamp"):
    """Bilinear interpolation of the images ``data[b]`` (``data`` (N, C,
    H, W), ``b`` (R,) indices) at sample coordinates ``y``/``x`` of
    shapes broadcasting to (R, ...), in pixel units -> (R, C, ...).

    ``border='clamp'``: coordinates clamp to the edge (ROIAlign);
    ``border='zero'``: samples outside the image read 0
    (BilinearSampler).  The reference's one blend, in its order, behind
    ROIAlign, BilinearSampler, BilinearResize2D and the deformable ops."""
    _, _, H, W = data.shape
    if border == "clamp":
        y = y.clamp(0.0, H - 1.0)
        x = x.clamp(0.0, W - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0).unsqueeze(1)
    wx = (x - x0).unsqueeze(1)
    nd = max(y.dim(), x.dim())
    bb = b.reshape((-1,) + (1,) * (nd - 1))

    def g(yi, xi):
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        v = data[bb, :, yc, xc].movedim(-1, 1)
        if border == "zero":
            inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            v = torch.where(inside.unsqueeze(1), v, 0.0)
        return v

    v00 = g(y0, x0)
    v01 = g(y0, x0 + 1)
    v10 = g(y0 + 1, x0)
    v11 = g(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx)


@register("_contrib_box_iou", aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner", **kw):
    """Pairwise IoU over the outer product of the two boxes' leading
    dims (reference: ``bounding_box.cc`` BoxOverlap)."""
    lf = _to_corner(lhs, format).reshape(-1, 4)
    rf = _to_corner(rhs, format).reshape(-1, 4)
    out = _pairwise_iou(lf, rf)
    return out.reshape(tuple(lhs.shape[:-1]) + tuple(rhs.shape[:-1]))


@register("_contrib_box_nms", aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            **kw):
    """Non-maximum suppression (reference: ``bounding_box.cc`` BoxNMS).

    The output keeps the input's shape; suppressed and invalid rows get
    score -1.  Rows are re-ordered score-descending within each batch."""
    shape = data.shape
    rec_s, boxes, valid_s, ids_s = _nms_inputs(
        data, valid_thresh, topk, coord_start, score_index, id_index,
        background_id, in_format)
    keep = nms_keep(boxes.float(), valid_s,
                    None if force_suppress else ids_s.float(), overlap_thresh)
    out = rec_s.clone()
    if out_format != in_format:
        if out_format == "corner":
            conv = boxes
        else:
            x0, y0, x1, y1 = boxes.unbind(-1)
            conv = torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0,
                                y1 - y0], dim=-1)
        out[..., coord_start:coord_start + 4] = conv.to(out.dtype)
    out[..., score_index] = torch.where(keep, out[..., score_index], -1.0)
    return out.reshape(shape)


def _nms_inputs(data, valid_thresh, topk, coord_start, score_index,
                id_index, background_id, in_format):
    """``box_nms``'s records (B, N, K) sorted by score within each image,
    their corner boxes, valid flags (top-k among valid rows) and class
    ids: what it hands to ``nms_keep``."""
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))   # (B, N, K)
    B, N, K = flat.shape
    scores = flat[..., score_index]
    valid = scores > valid_thresh
    if background_id >= 0 and id_index >= 0:
        valid = valid & (flat[..., id_index] != background_id)
    order = torch.sort(-scores, dim=1, stable=True).indices  # jnp.argsort
    rec_s = torch.gather(flat, 1, order[..., None].expand(B, N, K))
    valid_s = torch.gather(valid, 1, order)
    if topk > 0:
        # top-k among VALID rows only: invalid and background rows take
        # no slot
        valid_rank = torch.cumsum(valid_s.int(), dim=1) - 1
        valid_s = valid_s & (valid_rank < topk)
    boxes = _to_corner(rec_s[..., coord_start:coord_start + 4], in_format)
    ids_s = rec_s[..., id_index] if id_index >= 0 else \
        torch.zeros((B, N), dtype=rec_s.dtype, device=rec_s.device)
    return rec_s, boxes, valid_s, ids_s


def _tuple_of_floats(v):
    return tuple(float(s) for s in (v if not isinstance(v, (int, float))
                                    else (v,)))


@register("MultiBoxPrior", aliases=("_contrib_MultiBoxPrior",))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kw):
    """SSD anchor generation (reference: ``multibox_prior.cc``).  For an
    (N, C, H, W) feature map emits (1, H*W*(S+R-1), 4) corner
    anchors."""
    sizes = _tuple_of_floats(sizes)
    ratios = _tuple_of_floats(ratios)
    dev = data.device
    H, W = data.shape[-2], data.shape[-1]
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")       # (H, W)
    # anchors: (size_i, ratio_0) for all sizes, then (size_0, ratio_j>0);
    # widths and heights in float64, rounded once to float32
    ws = [s * _np.sqrt(ratios[0]) for s in sizes] + \
        [sizes[0] * _np.sqrt(r) for r in ratios[1:]]
    hs = [s / _np.sqrt(ratios[0]) for s in sizes] + \
        [sizes[0] / _np.sqrt(r) for r in ratios[1:]]
    ws = _device_floats(ws, dev)
    hs = _device_floats(hs, dev)
    cxg = cxg[..., None]
    cyg = cyg[..., None]
    anchors = torch.stack([cxg - ws / 2, cyg - hs / 2, cxg + ws / 2,
                           cyg + hs / 2], dim=-1).reshape(1, -1, 4)
    if clip:
        anchors = anchors.clamp(0.0, 1.0)
    return anchors


def _encode_loc(anchor, gt, variances):
    """Corner anchor + matched corner gt -> SSD regression target."""
    aw = anchor[..., 2] - anchor[..., 0]
    ah = anchor[..., 3] - anchor[..., 1]
    acx = (anchor[..., 0] + anchor[..., 2]) / 2
    acy = (anchor[..., 1] + anchor[..., 3]) / 2
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-12)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-12)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    return torch.stack([
        (gcx - acx) / torch.clamp_min(aw, 1e-12) / variances[0],
        (gcy - acy) / torch.clamp_min(ah, 1e-12) / variances[1],
        torch.log(gw / torch.clamp_min(aw, 1e-12)) / variances[2],
        torch.log(gh / torch.clamp_min(ah, 1e-12)) / variances[3],
    ], dim=-1)


def _softmax0(x, dim):
    """``jax.nn.softmax``'s arithmetic: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


@register("MultiBoxTarget", aliases=("_contrib_MultiBoxTarget",),
          num_outputs=3, no_grad=True)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **kw):
    """SSD training-target assignment (reference:
    ``multibox_target.cc``).

    anchor (1, A, 4) corner; label (B, M, 5) rows [cls, x0, y0, x1, y1]
    padded with cls = -1; cls_pred (B, C+1, A) (for hard-negative mining
    when ``negative_mining_ratio`` > 0).  Outputs: loc_target (B, A*4),
    loc_mask (B, A*4), cls_target (B, A), where class 0 is background
    and gt class c maps to c+1."""
    A = anchor.shape[1]
    anc = anchor.reshape(A, 4)
    B, M = label.shape[0], label.shape[1]
    dev = label.device
    gt_valid = label[..., 0] >= 0                          # (B, M)
    gt_box = label[..., 1:5]
    iou = _pairwise_iou(anc, gt_box)                       # (B, A, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)                            # first maximum
    matched = best_iou >= overlap_threshold
    # bipartite stage: each valid gt claims its best anchor; padded rows
    # go to the dropped column A, and of two gts with one best anchor
    # the later wins (the reference's scatter as XLA applies it)
    best_anchor = iou.argmax(dim=1)                        # (B, M)
    scatter_idx = torch.where(gt_valid, best_anchor, A)
    m_index = torch.arange(M, device=dev).expand(B, M)
    forced_gt = torch.full((B, A + 1), -1, dtype=torch.long, device=dev) \
        .scatter_reduce(1, scatter_idx, m_index, "amax")[:, :A]
    forced = forced_gt >= 0
    use_gt = torch.where(forced, forced_gt, best_gt)
    pos = matched | forced
    gt_for_anchor = torch.gather(gt_box, 1, use_gt[..., None].expand(B, A, 4))
    cls_for_anchor = torch.gather(label[..., 0], 1, use_gt).int() + 1
    cls_target = torch.where(pos, cls_for_anchor, 0)
    if negative_mining_ratio > 0:
        # hard-negative mining: keep the highest-background-loss
        # negatives up to ratio * npos, the rest -> ignore_label
        bg_prob = _softmax0(cls_pred, 1)[:, 0]             # (B, A)
        neg_score = torch.where(pos | (best_iou >= negative_mining_thresh),
                                float("inf"), bg_prob)
        order = torch.sort(neg_score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(B, A))
        n_neg = torch.clamp_min(
            (negative_mining_ratio * pos.sum(dim=1).int()).int(),
            int(minimum_negative_samples))
        keep_neg = rank < n_neg[:, None]
        cls_target = torch.where(pos, cls_target,
                                 torch.where(keep_neg, 0, int(ignore_label)))
    loc_t = _encode_loc(anc, gt_for_anchor, variances)
    loc_t = torch.where(pos[..., None], loc_t, 0.0)
    loc_m = torch.where(pos[..., None], 1.0, 0.0).expand(B, A, 4)
    return (loc_t.reshape(B, -1), loc_m.reshape(B, -1),
            cls_target.float())


@register("MultiBoxDetection", aliases=("_contrib_MultiBoxDetection",),
          no_grad=True)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1, **kw):
    """SSD detection decode + per-class NMS (reference:
    ``multibox_detection.cc``).  cls_prob (B, C+1, A), loc_pred (B,
    A*4), anchor (1, A, 4) -> (B, A, 6) rows [class_id, score, x0, y0,
    x1, y1]; suppressed rows get class_id -1."""
    rec = _detection_records(cls_prob, loc_pred, anchor, clip, threshold,
                             background_id, variances)
    out = box_nms(rec, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  background_id=-1, force_suppress=force_suppress)
    # the reference marks suppressed rows with class_id -1
    out[..., 0] = torch.where(out[..., 1] < 0, -1.0, out[..., 0])
    return out


def _detection_records(cls_prob, loc_pred, anchor, clip, threshold,
                       background_id, variances):
    """``MultiBoxDetection``'s decoded rows before NMS: (B, A, 6)
    [class_id, score, x0, y0, x1, y1], class_id and score -1 where the
    best foreground score is at most ``threshold``."""
    B, C1, A = cls_prob.shape
    anc = anchor.reshape(A, 4)
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    loc = loc_pred.reshape(B, A, 4)
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                      dim=-1)
    if clip:
        box = box.clamp(0.0, 1.0)
    # best non-background class per anchor; the foreground row index IS
    # the 0-based gt class (MultiBoxTarget trains channel c+1 for class c)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)   # (B, C, A)
    score = fg.amax(dim=1)
    best = fg.argmax(dim=1)
    cls_id = torch.where(score > threshold, best.to(box.dtype), -1.0)
    score = torch.where(score > threshold, score, -1.0)
    return torch.cat([cls_id[..., None], score[..., None], box], dim=-1)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------

@register("ROIPooling")
def roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0, **kw):
    """Max pooling over quantized ROI bins (reference:
    ``roi_pooling.cc``).  data (N, C, H, W); rois (R, 5) rows
    [batch_index, x0, y0, x1, y1] in image coords."""
    PH, PW = pooled_size
    N, C, H, W = data.shape
    dev = data.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    b = rois[:, 0].int().long()
    x0, y0, x1, y1 = (torch.round(rois[:, k] * spatial_scale)[:, None]
                      for k in range(1, 5))
    rw = torch.clamp_min(x1 - x0 + 1, 1.0)
    rh = torch.clamp_min(y1 - y0 + 1, 1.0)
    bin_h = rh / PH
    bin_w = rw / PW
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    hstart = torch.floor(ph * bin_h) + y0                  # (R, PH)
    hend = torch.ceil((ph + 1) * bin_h) + y0
    wstart = torch.floor(pw * bin_w) + x0                  # (R, PW)
    wend = torch.ceil((pw + 1) * bin_w) + x0
    ymask = (ys >= hstart[..., None]) & (ys < hend[..., None])  # (R, PH, H)
    xmask = (xs >= wstart[..., None]) & (xs < wend[..., None])  # (R, PW, W)
    m = ymask[:, :, None, :, None] & xmask[:, None, :, None, :]
    img = data[b]                                          # (R, C, H, W)
    masked = torch.where(m[:, None], img[:, :, None, None], float("-inf"))
    out = masked.amax(dim=(4, 5))                          # (R, C, PH, PW)
    return torch.where(torch.isneginf(out), 0.0, out).to(data.dtype)


@register("_contrib_ROIAlign", aliases=("ROIAlign",))
def roi_align(data, rois, pooled_size=None, spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False,
              **kw):
    """ROIAlign with fixed per-bin bilinear sample grids (reference:
    ``contrib/roi_align.cc``; Mask R-CNN): every (roi, bin) samples
    ``sample_ratio**2`` points (default 2**2)."""
    if position_sensitive:
        raise MXNetError(
            "_contrib_ROIAlign: position_sensitive=True (PS-ROIAlign) "
            "is not implemented")
    PH, PW = pooled_size
    S = sample_ratio if sample_ratio > 0 else 2
    dev = data.device
    offset = 0.5 if aligned else 0.0
    b = rois[:, 0].int().long()
    x0, y0, x1, y1 = (rois[:, k] * spatial_scale - offset
                      for k in range(1, 5))
    rw = x1 - x0
    rh = y1 - y0
    if not aligned:
        rw = torch.clamp_min(rw, 1.0)
        rh = torch.clamp_min(rh, 1.0)
    bin_h = (rh / PH)[:, None, None]
    bin_w = (rw / PW)[:, None, None]
    ph = torch.arange(PH, dtype=torch.float32, device=dev)
    pw = torch.arange(PW, dtype=torch.float32, device=dev)
    sy = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    sx = sy
    yy = y0[:, None, None] + ph[:, None] * bin_h + sy[None, :] * bin_h
    xx = x0[:, None, None] + pw[:, None] * bin_w + sx[None, :] * bin_w
    R = rois.shape[0]
    Y = yy[:, :, None, :, None].expand(R, PH, PW, S, S)
    X = xx[:, None, :, None, :].expand(R, PH, PW, S, S)
    vals = _bilinear_gather(data, b, Y, X)             # (R, C, PH, PW, S, S)
    return vals.mean(dim=(4, 5)).to(data.dtype)


@register("_contrib_mrcnn_mask_target", num_outputs=2, no_grad=True)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets,
                      num_rois=None, num_classes=None, mask_size=(14, 14),
                      sample_ratio=2, aligned=False, **kw):
    """Mask R-CNN mask-target generator (reference:
    ``src/operator/contrib/mrcnn_mask_target.cu``).

    rois (B, N, 4) corner proposals; gt_masks (B, M, H, W); matches (B,
    N) the matched gt of each roi; cls_targets (B, N) 0 = background,
    c >= 1 = class c (channel c-1).  Outputs, both (B, N, C, MSh, MSw):
    the matched mask ROIAligned to ``mask_size`` at channel cls-1 of
    positive rois (zero elsewhere), and the sigmoid-CE weights (1
    there, else 0)."""
    if num_classes is None:
        raise MXNetError("_contrib_mrcnn_mask_target: num_classes "
                         "is required")
    C = int(num_classes)
    try:
        MH, MW = mask_size
    except TypeError:
        MH = MW = int(mask_size)
    B, N = rois.shape[0], rois.shape[1]
    M, H, W = gt_masks.shape[1:]
    dev = rois.device
    # the batch column is the matched mask's row in (B*M): ROIAlign then
    # crops each roi straight out of its matched instance mask
    row = (matches.int() + M * torch.arange(B, device=dev,
                                            dtype=torch.int32)[:, None])
    full = torch.cat([row.float()[..., None], rois.float()], dim=-1)
    crop = roi_align(gt_masks.reshape(B * M, 1, H, W).float(),
                     full.reshape(B * N, 5), pooled_size=(MH, MW),
                     spatial_scale=1.0, sample_ratio=sample_ratio,
                     aligned=aligned).reshape(B, N, 1, MH, MW)
    cls = cls_targets.int()
    onehot = ((torch.arange(C, dtype=torch.int32, device=dev)
               == cls[..., None] - 1) & (cls[..., None] > 0)).float()
    w = onehot[..., None, None]                           # (B, N, C, 1, 1)
    return crop * w, w.expand(B, N, C, MH, MW)


# ---------------------------------------------------------------------------
# Spatial transformer family
# ---------------------------------------------------------------------------

def _bilinear_sample_nchw(data, grid_x, grid_y):
    """data (B, C, H, W); normalized grids (B, Ho, Wo) in [-1, 1];
    outside -> 0 (reference: ``bilinear_sampler.cc`` zero padding)."""
    B, C, H, W = data.shape
    x = (grid_x + 1.0) * (W - 1) / 2.0
    y = (grid_y + 1.0) * (H - 1) / 2.0
    return _bilinear_gather(data, torch.arange(B, device=data.device), y, x,
                            border="zero")


@register("BilinearSampler")
def bilinear_sampler(data, grid, **kw):
    """Sample data at grid locations (reference:
    ``bilinear_sampler.cc``).  data (B, C, H, W); grid (B, 2, Ho, Wo)
    with grid[:, 0] = x, grid[:, 1] = y in [-1, 1]."""
    return _bilinear_sample_nchw(data, grid[:, 0], grid[:, 1]) \
        .to(data.dtype)


def _linspace(start, stop, num, device):
    """``jnp.linspace``'s float32 arithmetic: start*(1-s) + stop*s with
    s = i/(num-1), and ``stop`` itself as the last value."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0),
                   **kw):
    """Generate a sampling grid (reference: ``grid_generator.cc``).

    affine: data (B, 6) row-major 2x3 theta -> grid (B, 2, H, W);
    warp: data (B, 2, H, W) pixel flow -> normalized grid."""
    dev = data.device
    if transform_type == "affine":
        H, W = target_shape
        B = data.shape[0]
        ys = _linspace(-1.0, 1.0, H, dev)
        xs = _linspace(-1.0, 1.0, W, dev)
        yg, xg = torch.meshgrid(ys, xs, indexing="ij")
        src = torch.stack([xg, yg, torch.ones_like(xg)]).reshape(3, -1)
        theta = data.reshape(B, 2, 3)
        out = theta @ src.to(theta.dtype)                     # (B, 2, HW)
        return out.reshape(B, 2, H, W).to(data.dtype)
    if transform_type == "warp":
        B, _, H, W = data.shape
        ys = torch.arange(H, dtype=torch.float32, device=dev)
        xs = torch.arange(W, dtype=torch.float32, device=dev)
        yg, xg = torch.meshgrid(ys, xs, indexing="ij")
        x = (data[:, 0] + xg) * 2.0 / max(W - 1, 1) - 1.0
        y = (data[:, 1] + yg) * 2.0 / max(H - 1, 1) - 1.0
        return torch.stack([x, y], dim=1).to(data.dtype)
    raise MXNetError("GridGenerator: unknown transform_type %r"
                     % transform_type)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        **kw):
    """Affine spatial transformer network layer (reference:
    ``spatial_transformer.cc`` — GridGenerator + BilinearSampler)."""
    grid = grid_generator(loc, transform_type=transform_type,
                          target_shape=tuple(target_shape))
    return bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# Resize / adaptive pooling
# ---------------------------------------------------------------------------

@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))
def bilinear_resize_2d(data, like=None, height=1, width=1,
                       scale_height=None, scale_width=None,
                       mode="size", **kw):
    """Bilinear up/downsampling with align_corners=True semantics
    (reference: ``contrib/bilinear_resize.cc``)."""
    B, C, H, W = data.shape
    if mode == "like" and like is not None:
        Ho, Wo = like.shape[-2], like.shape[-1]
    elif mode == "scale" or (scale_height is not None
                             and scale_width is not None):
        Ho, Wo = int(H * scale_height), int(W * scale_width)
    elif mode == "size":
        Ho, Wo = int(height), int(width)
    else:
        raise MXNetError(
            "_contrib_BilinearResize2D: unsupported mode %r "
            "(supported: size, scale, like)" % mode)
    dev = data.device
    ys = _linspace(0.0, H - 1.0, Ho, dev)
    xs = _linspace(0.0, W - 1.0, Wo, dev)
    yg = ys[:, None].expand(Ho, Wo)[None]
    xg = xs[None, :].expand(Ho, Wo)[None]
    out = _bilinear_gather(data, torch.arange(B, device=dev), yg, xg)
    return out.to(data.dtype)


@register("_contrib_AdaptiveAvgPooling2D",
          aliases=("AdaptiveAvgPooling2D",))
def adaptive_avg_pooling_2d(data, output_size=(1, 1), **kw):
    """Adaptive average pooling to any output size (reference:
    ``contrib/adaptive_avg_pooling.cc``): exact bin means through an
    integral image."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    OH, OW = output_size
    B, C, H, W = data.shape
    dev = data.device
    acc = torch.promote_types(data.dtype, torch.float32)   # f16 sums in f32
    ii = torch.cumsum(torch.cumsum(data.to(acc), dim=2), dim=3)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    oh = torch.arange(OH, device=dev)
    ow = torch.arange(OW, device=dev)
    hs = (oh * H) // OH
    he = ((oh + 1) * H + OH - 1) // OH
    ws = (ow * W) // OW
    we = ((ow + 1) * W + OW - 1) // OW
    s = (ii[:, :, he][:, :, :, we] - ii[:, :, hs][:, :, :, we]
         - ii[:, :, he][:, :, :, ws] + ii[:, :, hs][:, :, :, ws])
    area = ((he - hs)[:, None] * (we - ws)[None, :]).to(acc)
    return (s / area).to(data.dtype)


# ---------------------------------------------------------------------------
# Correlation (optical flow) and SVMOutput
# ---------------------------------------------------------------------------

@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True, **kw):
    """Cost-volume correlation between two feature maps (reference:
    ``correlation.cc``; FlowNet).  Output (B, D**2, Ho, Wo) with
    D = 2*(max_displacement/stride2)+1: D**2 shifted patch products
    averaged over the channels and the KxK window."""
    B, C, H, W = data1.shape
    d = max_displacement // stride2
    K = kernel_size
    pad = pad_size
    p1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    p2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    Hp, Wp = H + 2 * pad, W + 2 * pad
    bord = max_displacement + (K - 1) // 2
    dev = data1.device
    ys = torch.arange(bord, Hp - bord, stride1, device=dev)
    xs = torch.arange(bord, Wp - bord, stride1, device=dev)
    kr = [k - (K - 1) // 2 for k in range(K)]

    def patch(p, oy, ox):
        return p[:, :, ys + oy][:, :, :, xs + ox]

    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            oy, ox = dy * stride2, dx * stride2
            acc = 0.0
            for ky in kr:
                for kx in kr:
                    a = patch(p1, ky, kx)
                    b = patch(p2, oy + ky, ox + kx)
                    if is_multiply:
                        acc = acc + torch.sum(a * b, dim=1)
                    else:
                        acc = acc + torch.sum(torch.abs(a - b), dim=1)
            outs.append(acc / (C * K * K))
    return torch.stack(outs, dim=1).to(data1.dtype)


class _SVM(torch.autograd.Function):
    """Identity forward; the (squared-)hinge-loss gradient backward."""

    @staticmethod
    def forward(ctx, x, label, margin, coef, use_linear):
        ctx.save_for_backward(x, label)
        ctx.margin, ctx.coef, ctx.use_linear = margin, coef, use_linear
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        k = x.shape[-1]
        oh = torch.nn.functional.one_hot(lab.long(), k).to(x.dtype)
        sgn = 2 * oh - 1                       # +1 for target, -1 rest
        viol = (ctx.margin - sgn * x) > 0
        if ctx.use_linear:
            grad = torch.where(viol, -sgn, 0.0)
        else:
            grad = torch.where(viol, -2.0 * (ctx.margin - sgn * x) * sgn,
                               0.0)
        grad = grad * ctx.coef
        return grad.to(x.dtype), None, None, None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False, **kw):
    """SVM output head (reference: ``svm_output.cc``): forward is the
    identity; backward is the (squared-)hinge-loss gradient, whatever
    the head gradient."""
    return _SVM.apply(data, label, float(margin),
                      float(regularization_coefficient), bool(use_linear))
