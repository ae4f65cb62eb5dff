"""Extended detection and vision operators: the deformable
convolutions, position-sensitive ROI pooling (plain and deformable),
RPN proposals, rotated ROIAlign, the box codecs and bipartite matching.

Port of ``mxnet_tpu/ops/vision_ext.py``, name for name.  Every sampler
is the reference's bilinear gather (``vision._bilinear_gather``) with
the batch or ROI axis written out where the reference ``vmap``s, then
torch matmuls; RPN proposals run greedy NMS through ``kernels/nms.py``.
``lax.top_k``'s ties go to the lower index, as a stable descending
``torch.sort`` gives them.  Nothing reads a value back to the host, so
the ops run inside a captured CUDA graph.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..kernels.nms import nms_keep
from .registry import register
from .vision import _bilinear_gather, _device_floats, _to_corner


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _top(scores, k):
    """(values, indices) of the ``k`` largest along the last axis, ties
    to the lower index (``lax.top_k``)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


# ---------------------------------------------------------------------------
# Deformable convolution family
# ---------------------------------------------------------------------------

def _deform_im2col(data, offset, mask, kernel, stride, pad, dilate,
                   num_deformable_group, out_hw):
    """Sampled im2col of a batch: data (N, C, H, W); offset (N,
    2*G*Kh*Kw, Ho, Wo); mask (N, G*Kh*Kw, Ho, Wo) or None -> columns
    (N, C, Kh*Kw, Ho, Wo) sampled at p0 + pn + offset."""
    N, C, H, W = data.shape
    Kh, Kw = kernel
    Ho, Wo = out_hw
    G = num_deformable_group
    cg = C // G
    dev = data.device
    base_y = (torch.arange(Ho, device=dev) * stride[0] - pad[0])[:, None]
    base_x = (torch.arange(Wo, device=dev) * stride[1] - pad[1])[None, :]
    off = offset.reshape(N, G, Kh * Kw, 2, Ho, Wo)
    msk = None if mask is None else mask.reshape(N, G, Kh * Kw, Ho, Wo)
    b = torch.arange(N, device=dev)
    cols = []
    for tap in range(Kh * Kw):
        kh, kw = tap // Kw, tap % Kw
        per_g = []
        for g in range(G):
            y = base_y + kh * dilate[0] + off[:, g, tap, 0]
            x = base_x + kw * dilate[1] + off[:, g, tap, 1]
            v = _bilinear_gather(data[:, g * cg:(g + 1) * cg], b, y, x,
                                 border="zero")          # (N, cg, Ho, Wo)
            if msk is not None:
                v = v * msk[:, g, tap][:, None]
            per_g.append(v)
        cols.append(torch.cat(per_g, dim=1))            # (N, C, Ho, Wo)
    return torch.stack(cols, dim=2)                     # (N, C, KK, Ho, Wo)


def _deformable_conv(data, offset, weight, bias, mask, kernel, stride,
                     pad, dilate, num_filter, num_group,
                     num_deformable_group, no_bias):
    kernel = _pair(kernel)
    stride = _pair(stride) if stride else (1, 1)
    pad = _pair(pad) if pad else (0, 0)
    dilate = _pair(dilate) if dilate else (1, 1)
    N, C, H, W = data.shape
    Kh, Kw = kernel
    Ho = (H + 2 * pad[0] - dilate[0] * (Kh - 1) - 1) // stride[0] + 1
    Wo = (W + 2 * pad[1] - dilate[1] * (Kw - 1) - 1) // stride[1] + 1
    cols = _deform_im2col(data, offset, mask, kernel, stride, pad, dilate,
                          num_deformable_group, (Ho, Wo))
    # grouped contraction: C and num_filter split into num_group
    cg = C // num_group
    fg = num_filter // num_group
    outs = []
    for g in range(num_group):
        w = weight[g * fg:(g + 1) * fg].reshape(fg, cg * Kh * Kw)
        c = cols[:, g * cg:(g + 1) * cg].reshape(N, cg * Kh * Kw, Ho * Wo)
        outs.append((w @ c).reshape(N, fg, Ho, Wo))
    out = torch.cat(outs, dim=1)
    if not no_bias and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _no_scalar_bias(bias):
    return None if bias is not None and bias.dim() == 0 else bias


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(1, 1),
                           stride=(), pad=(), dilate=(), num_filter=1,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, layout="NCHW", **kw):
    """DCNv1: convolution sampling at offset-shifted tap positions
    (reference: ``_contrib_DeformableConvolution``)."""
    return _deformable_conv(data, offset, weight, _no_scalar_bias(bias),
                            None, kernel, stride, pad, dilate,
                            int(num_filter), int(num_group),
                            int(num_deformable_group), no_bias)


@register("_contrib_ModulatedDeformableConvolution",
          aliases=("ModulatedDeformableConvolution",))
def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     kernel=(1, 1), stride=(), pad=(),
                                     dilate=(), num_filter=1, num_group=1,
                                     num_deformable_group=1, no_bias=False,
                                     layout="NCHW", **kw):
    """DCNv2: adds a learned per-tap modulation mask."""
    return _deformable_conv(data, offset, weight, _no_scalar_bias(bias),
                            mask, kernel, stride, pad, dilate,
                            int(num_filter), int(num_group),
                            int(num_deformable_group), no_bias)


# ---------------------------------------------------------------------------
# Position-sensitive ROI pooling
# ---------------------------------------------------------------------------

def _psroi(data, rois, spatial_scale, output_dim, pooled, group,
           trans=None, part_size=0, sample_per_part=1, trans_std=0.0):
    """data (N, C, H, W) with C = output_dim*group**2, rois (R, 5),
    trans (R, 2, part, part) or None -> (R, output_dim, P, P)."""
    _, C, H, W = data.shape
    P = pooled
    R = rois.shape[0]
    dev = data.device
    b = rois[:, 0].int().long()
    x1 = (rois[:, 1] * spatial_scale - 0.5)[:, None, None]
    y1 = (rois[:, 2] * spatial_scale - 0.5)[:, None, None]
    x2 = ((rois[:, 3] + 1.0) * spatial_scale - 0.5)[:, None, None]
    y2 = ((rois[:, 4] + 1.0) * spatial_scale - 0.5)[:, None, None]
    rw = torch.clamp_min(x2 - x1, 0.1)
    rh = torch.clamp_min(y2 - y1, 0.1)
    bin_w = rw / P
    bin_h = rh / P
    n_s = max(1, int(sample_per_part))
    ii = torch.arange(P, device=dev)
    sub = (torch.arange(n_s, dtype=torch.float32, device=dev) + 0.5) / n_s
    ys = y1 + (ii[:, None] + sub[None, :]) * bin_h           # (R, P, n_s)
    xs = x1 + (ii[:, None] + sub[None, :]) * bin_w
    if trans is not None:
        # per-part offsets scaled by the roi's size; pooled bin i reads
        # part bin floor(i * part / P)
        part = part_size if part_size > 0 else P
        pi = torch.clamp((ii * part) // P, 0, part - 1)
        dyg = trans[:, 1][:, pi][:, :, pi] * trans_std * rh   # (R, P, P)
        dxg = trans[:, 0][:, pi][:, :, pi] * trans_std * rw
    else:
        dyg = torch.zeros((R, P, P), device=dev)
        dxg = torch.zeros((R, P, P), device=dev)
    Y = ys[:, :, None, :, None] + dyg[..., None, None]    # (R, P, P, n_s, 1)
    X = xs[:, None, :, None, :] + dxg[..., None, None]    # (R, P, P, 1, n_s)
    Yc = torch.clamp(Y, 0.0, H - 1.0)
    Xc = torch.clamp(X, 0.0, W - 1.0)
    vals = _bilinear_gather(data, b, Yc, Xc)     # (R, C, P, P, n_s, n_s)
    vals = vals.mean(dim=(-1, -2))                         # (R, C, P, P)
    # position-sensitive channels: bin (i, j) reads group gi*group + gj
    gi = torch.clamp((ii * group) // P, 0, group - 1)
    cs = vals.reshape(R, output_dim, group * group, P, P)
    sel = gi[:, None] * group + gi[None, :]                # (P, P)
    return cs[:, :, sel, ii[:, None], ii[None, :]]


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                  pooled_size=1, group_size=0, **kw):
    """Position-sensitive ROI pooling (R-FCN head)."""
    group = int(group_size) if group_size else int(pooled_size)
    return _psroi(data, rois, spatial_scale, int(output_dim),
                  int(pooled_size), group)


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",))
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=1, group_size=1, pooled_size=1,
                             part_size=0, sample_per_part=1,
                             trans_std=0.0, no_trans=False, **kw):
    """Deformable position-sensitive ROI pooling (reference:
    ``deformable_psroi_pooling.cc``): per-part offsets shift the bins;
    class-agnostic, the first two of trans's (R, 2*cls, part, part)
    channels."""
    use_trans = (not no_trans) and trans is not None
    return _psroi(data, rois, spatial_scale, int(output_dim),
                  int(pooled_size), int(group_size),
                  trans[:, :2] if use_trans else None, int(part_size),
                  int(sample_per_part), float(trans_std))


# ---------------------------------------------------------------------------
# RPN proposals
# ---------------------------------------------------------------------------

def _base_anchors(stride, scales, ratios):
    """The (A, 4) anchors at the origin, the reference's float32 numpy
    arithmetic."""
    base = float(stride)
    scales = _np.array(scales, dtype=_np.float32)
    ratios = _np.array(ratios, dtype=_np.float32)
    ctr = _np.float32((base - 1) / 2.0)
    size = _np.float32(base * base)
    ws, hs = [], []
    for r in ratios:
        size_r = size / r
        w0 = _np.round(_np.sqrt(size_r))
        h0 = _np.round(w0 * r)
        for s in scales:
            ws.append(w0 * s)
            hs.append(h0 * s)
    ws = _np.array(ws, _np.float32)
    hs = _np.array(hs, _np.float32)
    half = _np.float32(0.5)
    one = _np.float32(1)
    return _np.stack([ctr - half * (ws - one), ctr - half * (hs - one),
                      ctr + half * (ws - one), ctr + half * (hs - one)],
                     axis=1).astype(_np.float32)


def _gen_anchors(feat_h, feat_w, stride, scales, ratios, device):
    """(H*W*A, 4) anchors over the feature map, made on ``device``."""
    base = _device_floats(_base_anchors(stride, scales, ratios).ravel(),
                          device).reshape(-1, 4)
    sx = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    sy = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 1, 4)
    return (base[None] + shift).reshape(-1, 4)


def _decode_bbox(anchors, deltas):
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (w - 1)
    cy = anchors[..., 1] + 0.5 * (h - 1)
    dx, dy, dw, dh = deltas.unbind(-1)
    ncx = dx * w + cx
    ncy = dy * h + cy
    nw = torch.exp(dw) * w
    nh = torch.exp(dh) * h
    return torch.stack([ncx - 0.5 * (nw - 1), ncy - 0.5 * (nh - 1),
                        ncx + 0.5 * (nw - 1), ncy + 0.5 * (nh - 1)], dim=-1)


def _proposals(scores, deltas, im_info, anchors, pre_n, post_n, nms_thresh,
               min_size):
    """scores (N, K), deltas (N, K, 4), im_info (N, 3) -> (boxes (N,
    post, 4), scores (N, post))."""
    H = im_info[:, 0:1]
    W = im_info[:, 1:2]
    boxes = _decode_bbox(anchors, deltas).clamp_min(0.0)
    boxes = torch.stack([torch.minimum(boxes[..., 0], W - 1),
                         torch.minimum(boxes[..., 1], H - 1),
                         torch.minimum(boxes[..., 2], W - 1),
                         torch.minimum(boxes[..., 3], H - 1)], dim=-1)
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    ms = min_size * im_info[:, 2:3]
    valid = (ws >= ms) & (hs >= ms)
    scores = torch.where(valid, scores, -1.0)
    pre_n = min(pre_n, scores.shape[-1])
    top_s, top_i = _top(scores, pre_n)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    keep = nms_keep(top_b.float(), top_s > -1.0, None, nms_thresh)
    # kept boxes by score, padded with the top-1 box (the reference pads
    # with repeats)
    rank = torch.where(keep, top_s, float("-inf"))
    post = min(post_n, pre_n)
    sel_s, sel_i = _top(rank, post)
    out_b = torch.gather(top_b, 1, sel_i[..., None].expand(-1, -1, 4))
    out_s = torch.gather(top_s, 1, sel_i)
    good = torch.isfinite(sel_s)
    out_b = torch.where(good[..., None], out_b, out_b[:, 0:1])
    out_s = torch.where(good, out_s, out_s[:, 0:1])
    return out_b, out_s


def _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride, output_score):
    N, A2, H, W = cls_prob.shape
    A = A2 // 2
    anchors = _gen_anchors(H, W, feature_stride, scales, ratios,
                           cls_prob.device)
    # foreground scores are the second half of the A2 channels
    sc = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)   # (N, HWA)
    dl = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    boxes, scores = _proposals(sc, dl, im_info, anchors,
                               int(rpn_pre_nms_top_n),
                               int(rpn_post_nms_top_n), float(threshold),
                               float(rpn_min_size))
    batch_ids = torch.arange(N, dtype=boxes.dtype, device=boxes.device)[
        :, None, None].expand(N, boxes.shape[1], 1)
    rois = torch.cat([batch_ids, boxes], dim=2).reshape(-1, 5)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


@register("_contrib_Proposal", aliases=("Proposal",), num_outputs=-1,
          no_grad=True)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
             feature_stride=16, output_score=False, iou_loss=False, **kw):
    """RPN proposal generation (reference: ``proposal.cc``)."""
    return _proposal_impl(cls_prob, bbox_pred, im_info,
                          rpn_pre_nms_top_n, rpn_post_nms_top_n,
                          threshold, rpn_min_size, scales, ratios,
                          feature_stride, output_score)


@register("_contrib_MultiProposal", aliases=("MultiProposal",),
          num_outputs=-1, no_grad=True)
def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False,
                   **kw):
    """Batched RPN proposals (reference: ``multi_proposal.cc``)."""
    return _proposal_impl(cls_prob, bbox_pred, im_info,
                          rpn_pre_nms_top_n, rpn_post_nms_top_n,
                          threshold, rpn_min_size, scales, ratios,
                          feature_stride, output_score)


# ---------------------------------------------------------------------------
# Rotated ROIAlign
# ---------------------------------------------------------------------------

@register("_contrib_RROIAlign", aliases=("RROIAlign",), no_grad=True)
def rroi_align(data, rois, pooled_size=None, spatial_scale=1.0,
               sampling_ratio=2, **kw):
    """Rotated ROIAlign: rois (R, 6) = [batch, cx, cy, w, h, angle_deg];
    samples a rotated grid bilinearly and average-pools."""
    ph, pw = _pair(pooled_size)
    ns = max(1, int(sampling_ratio))
    dev = data.device
    R = rois.shape[0]
    b = rois[:, 0].int().long()
    cx, cy, w, h = (rois[:, k, None, None] * spatial_scale
                    for k in range(1, 5))
    theta = rois[:, 5, None, None] * _np.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    # the local grid in the roi's frame, centred
    gy = (torch.arange(ph * ns, device=dev) + 0.5) / (ph * ns) - 0.5
    gx = (torch.arange(pw * ns, device=dev) + 0.5) / (pw * ns) - 0.5
    ly = gy[:, None] * h
    lx = gx[None, :] * w
    X = cx + lx * cos - ly * sin
    Y = cy + lx * sin + ly * cos
    v = _bilinear_gather(data, b, Y, X)              # (R, C, ph*ns, pw*ns)
    return v.reshape(R, v.shape[1], ph, ns, pw, ns).mean(dim=(3, 5))


# ---------------------------------------------------------------------------
# Box codecs + matching
# ---------------------------------------------------------------------------

@register("_contrib_box_encode", no_grad=True, num_outputs=-1)
def box_encode(samples, matches, anchors, refs, means=None, stds=None,
               **kw):
    """SSD target encoding (reference: bounding_box.cc BoxEncode):
    samples (B, N) 1 = positive, matches (B, N) ref index, anchors (B,
    N, 4) corner, refs (B, M, 4) -> (targets (B, N, 4), masks (B, N,
    4))."""
    means = (0.0, 0.0, 0.0, 0.0) if means is None else means
    stds = (0.1, 0.1, 0.2, 0.2) if stds is None else stds
    M = refs.shape[1]
    m = matches.int().long()
    m = torch.where(m < 0, m + M, m)        # negative indices wrap
    ref = torch.gather(refs, 1, m[..., None].expand(*m.shape, 4))
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    rw = ref[..., 2] - ref[..., 0]
    rh = ref[..., 3] - ref[..., 1]
    rx = (ref[..., 0] + ref[..., 2]) / 2
    ry = (ref[..., 1] + ref[..., 3]) / 2
    t = [(rx - ax) / aw, (ry - ay) / ah,
         torch.log(torch.clamp_min(rw / aw, 1e-12)),
         torch.log(torch.clamp_min(rh / ah, 1e-12))]
    t = torch.stack([(c - float(mu)) / float(sd)
                     for c, mu, sd in zip(t, means, stds)], dim=-1)
    mask = (samples > 0.5)[..., None].expand(t.shape).to(t.dtype)
    return t * mask, mask


@register("_contrib_box_decode", no_grad=True)
def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner", **kw):
    """Decode (B, N, 4) deltas against (1, N, 4) anchors (reference:
    bounding_box.cc BoxDecode)."""
    a = _to_corner(anchors, format)
    aw = a[..., 2] - a[..., 0]
    ah = a[..., 3] - a[..., 1]
    ax = (a[..., 0] + a[..., 2]) / 2
    ay = (a[..., 1] + a[..., 3]) / 2
    dx = data[..., 0] * std0
    dy = data[..., 1] * std1
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    cx = dx * aw + ax
    cy = dy * ah + ay
    if clip > 0:
        dw = torch.clamp_max(dw, clip)
        dh = torch.clamp_max(dh, clip)
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("_contrib_bipartite_matching", aliases=("bipartite_matching",),
          num_outputs=2, no_grad=True)
def bipartite_matching(data, is_ascend=False, threshold=0.5, topk=-1,
                       **kw):
    """Greedy bipartite matching on a (..., N, M) score matrix
    (reference: bounding_box.cc BipartiteMatching): take the globally
    best (row, col) again and again, marking both used.  Returns (row ->
    col matches, col -> row matches), -1 where unmatched."""
    sign = 1.0 if not is_ascend else -1.0
    batch_shape = tuple(data.shape[:-2])
    N, M = data.shape[-2:]
    s = data.reshape(-1, N, M) * sign
    B = s.shape[0]
    thr = threshold * sign
    dev = data.device
    rows = torch.arange(B, device=dev)
    rmatch = torch.full((B, N), -1.0, dtype=data.dtype, device=dev)
    cmatch = torch.full((B, M), -1.0, dtype=data.dtype, device=dev)
    k = min(N, M) if topk < 0 else min(topk, min(N, M))
    for _ in range(k):
        flat = s.reshape(B, -1).argmax(dim=1)
        i, j = flat // M, flat % M
        ok = s[rows, i, j] >= thr
        rmatch[rows, i] = torch.where(ok, j.to(data.dtype), rmatch[rows, i])
        cmatch[rows, j] = torch.where(ok, i.to(data.dtype), cmatch[rows, j])
        gone = ok[:, None, None] & (
            (torch.arange(N, device=dev)[None, :, None] == i[:, None, None])
            | (torch.arange(M, device=dev)[None, None, :] == j[:, None, None]))
        s = torch.where(gone, float("-inf"), s)
    return (rmatch.reshape(batch_shape + (N,)),
            cmatch.reshape(batch_shape + (M,)))
