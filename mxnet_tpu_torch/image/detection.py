"""Detection-task image augmenters and iterator.

Port of ``mxnet_tpu/image/detection.py`` (upstream
``python/mxnet/image/detection.py``).  Labels are (N, 5+) float arrays of
``[class_id, xmin, ymin, xmax, ymax, ...]`` with coordinates normalized
to [0, 1]; every augmenter transforms image AND label together.  Crops
follow the reference's SSD-style sampling: random area/aspect patches
accepted only when min-IoU (or center-in-patch) constraints hold.  The
random draws come from Python's ``random`` in the reference's order.
Images decode on the host; ``ImageDetIter`` builds each batch on the
current context.
"""
from __future__ import annotations

import json
import random as pyrandom

import numpy as _np

from ..base import MXNetError
from . import image as _img

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Detection augmenter base (reference: ``DetAugmenter``): called as
    ``aug(src, label) -> (src, label)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a classification :class:`~mxnet_tpu_torch.image.Augmenter` that
    does not move pixels (color jitter, cast, normalize) so it can run in
    a detection pipeline (reference: ``DetBorrowAug``)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, _img.Augmenter):
            raise MXNetError("DetBorrowAug needs an image.Augmenter")
        super().__init__(augmenter=type(augmenter).__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select one augmenter from a list (or skip entirely with
    ``1 - skip_prob`` … reference: ``DetRandomSelectAug``)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and x-coordinates with probability p
    (reference: ``DetHorizontalFlipAug``)."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = src.flip(axis=1)
            label = label.copy()
            valid = label[:, 0] >= 0
            xmin = 1.0 - label[valid, 3]
            xmax = 1.0 - label[valid, 1]
            label[valid, 1], label[valid, 3] = xmin, xmax
        return src, label


class DetRandomCropAug(DetAugmenter):
    """SSD-style random crop with IoU constraint
    (reference: ``DetRandomCropAug``): sample a patch of relative area in
    ``area_range`` and aspect in ``aspect_ratio_range``; accept when every
    kept object's IoU with the patch ≥ ``min_object_covered``.  Objects
    whose centers fall outside the patch are dropped (id set to -1)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75,
                 1.33), area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _sample_patch(self, label):
        for _ in range(self.max_attempts):
            area = pyrandom.uniform(*self.area_range)
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            w = min(1.0, (area * ratio) ** 0.5)
            h = min(1.0, (area / ratio) ** 0.5)
            x0 = pyrandom.uniform(0, 1 - w)
            y0 = pyrandom.uniform(0, 1 - h)
            patch = _np.array([x0, y0, x0 + w, y0 + h], _np.float32)
            valid = label[:, 0] >= 0
            if not valid.any():
                return patch
            # sample_distorted_bounding_box semantics: accept when the
            # patch contains >= min_object_covered of SOME object's area
            # (intersection / box area, not symmetric IoU)
            boxes = label[valid, 1:5]
            ix = (_np.minimum(boxes[:, 2], patch[2])
                  - _np.maximum(boxes[:, 0], patch[0])).clip(min=0)
            iy = (_np.minimum(boxes[:, 3], patch[3])
                  - _np.maximum(boxes[:, 1], patch[1])).clip(min=0)
            box_area = ((boxes[:, 2] - boxes[:, 0])
                        * (boxes[:, 3] - boxes[:, 1])).clip(min=1e-12)
            coverage = ix * iy / box_area
            if (coverage >= self.min_object_covered).any():
                return patch
        return None

    def __call__(self, src, label):
        patch = self._sample_patch(label)
        if patch is None:
            return src, label
        H, W = src.shape[:2]
        x0, y0, x1, y1 = patch
        px0, py0 = int(x0 * W), int(y0 * H)
        pw, ph = max(1, int((x1 - x0) * W)), max(1, int((y1 - y0) * H))
        src = _img.fixed_crop(src, px0, py0, pw, ph)
        out = label.copy()
        valid = out[:, 0] >= 0
        b = out[valid, 1:5]
        cx = (b[:, 0] + b[:, 2]) / 2
        cy = (b[:, 1] + b[:, 3]) / 2
        inside = ((cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1))
        # re-express surviving boxes in patch coordinates
        b[:, [0, 2]] = ((b[:, [0, 2]] - x0) / (x1 - x0)).clip(0, 1)
        b[:, [1, 3]] = ((b[:, [1, 3]] - y0) / (y1 - y0)).clip(0, 1)
        out[valid, 1:5] = b
        ids = out[valid, 0]
        ids[~inside] = -1
        out[valid, 0] = ids
        return src, out


class DetRandomPadAug(DetAugmenter):
    """Expand the canvas by a random factor, filling with ``fill``
    (reference: ``DetRandomPadAug``) — the zoom-out augmentation."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.pad_val = pad_val

    def __call__(self, src, label):
        H, W = src.shape[:2]
        scale = pyrandom.uniform(*self.area_range)
        if scale <= 1.0:
            return src, label
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        nw = min(int(W * (scale * ratio) ** 0.5), int(W * scale))
        nh = min(int(H * (scale / ratio) ** 0.5), int(H * scale))
        nw, nh = max(nw, W), max(nh, H)
        ox = pyrandom.randint(0, nw - W)
        oy = pyrandom.randint(0, nh - H)
        arr = src.asnumpy() if hasattr(src, "asnumpy") else _np.asarray(src)
        canvas = _np.empty((nh, nw, arr.shape[2]), dtype=arr.dtype)
        canvas[...] = _np.asarray(self.pad_val, dtype=arr.dtype)
        canvas[oy:oy + H, ox:ox + W] = arr
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * W + ox) / nw
        out[valid, 3] = (out[valid, 3] * W + ox) / nw
        out[valid, 2] = (out[valid, 2] * H + oy) / nh
        out[valid, 4] = (out[valid, 4] * H + oy) / nh
        from ..ndarray import array as nd_array
        from ..context import cpu
        return nd_array(canvas, ctx=getattr(src, "context", cpu())), out


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection augmenter list
    (reference: ``CreateDetAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    color = []
    if brightness or contrast or saturation:
        color.append(_img.ColorJitterAug(brightness, contrast, saturation))
    if hue:
        color.append(_img.HueJitterAug(hue))
    if pca_noise > 0:
        color.append(_img.LightingAug(
            pca_noise,
            _np.asarray([55.46, 4.794, 1.148]),
            _np.asarray([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])))
    for c in color:
        auglist.append(DetBorrowAug(c))
    auglist.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(_img.CastAug()))
    if mean is not None or std is not None:
        if mean is True:
            mean = _np.asarray([123.68, 116.28, 103.53])
        if std is True:
            std = _np.asarray([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(_img.ImageIter):
    """Detection iterator (reference: ``ImageDetIter``): like
    ``ImageIter`` but labels are per-image (N, 5+) box lists padded to
    the batch's max object count with -1 rows, emitted as a
    (batch, max_objects, label_width) array."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, object_width=5, max_objects=None,
                 data_name="data", label_name="label",
                 last_batch_handle="pad", **kwargs):
        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        self.object_width = object_width
        self._max_objects = max_objects  # resolved after super().__init__
        self._explicit_max = max_objects is not None
        self._overflow_warned = False
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         last_batch_handle=last_batch_handle, **kwargs)
        self.det_aug_list = aug_list
        if self._max_objects is None:
            self._max_objects = self._estimate_max_objects()

    def _estimate_max_objects(self, sample=256):
        """Scan up to ``sample`` labels for the dataset's max object
        count, so batches pad to ONE static shape (reference estimates
        the label shape up front; a static shape keeps a consumer's
        captured graphs warm).  Under-estimates are never lossy — ``next()``
        grows the pad size when a batch exceeds it."""
        from .. import recordio
        best = 1
        if self.imglist is not None:
            for k in list(self.imglist)[:sample]:
                best = max(best,
                           self._parse_label(self.imglist[k][0]).shape[0])
        elif self.imgrec is not None and self.seq is not None:
            for k in self.seq[:sample]:
                hdr, _ = recordio.unpack(self.imgrec.read_idx(k))
                best = max(best, self._parse_label(hdr.label).shape[0])
        elif self.imgrec is not None:
            for _ in range(sample):
                s = self.imgrec.read()
                if s is None:
                    break
                hdr, _ = recordio.unpack(s)
                best = max(best, self._parse_label(hdr.label).shape[0])
            self.imgrec.reset()
        return best

    @property
    def provide_label(self):
        from .. import io as mxio
        return [mxio.DataDesc(self.label_name,
                              (self.batch_size, self._max_objects,
                               self.object_width))]

    def _parse_label(self, label):
        """Flat label vector → (N, w) box array (reference:
        ``ImageDetIter._parse_label``: header ``[A, w, extras...,
        objects...]`` where A = header length, w = per-object width;
        plain ``N*object_width`` vectors are accepted too)."""
        raw = _np.asarray(label, dtype=_np.float32).ravel()
        if raw.size >= 2:
            a, w = int(raw[0]), int(raw[1])
            if (raw[0] == a and raw[1] == w and a >= 2 and w >= 5
                    and raw.size > a and (raw.size - a) % w == 0):
                return raw[a:].reshape(-1, w)
        w = self.object_width
        n = raw.size // w
        if n == 0:
            raise MXNetError("label too short for object_width=%d" % w)
        return raw[:n * w].reshape(n, w)

    def next(self):
        from .. import io as mxio
        from ..context import cpu
        from ..ndarray import array as nd_array
        samples = []
        try:
            while len(samples) < self.batch_size:
                label, s = self.next_sample()
                img = _img.imdecode(s, ctx=cpu())
                boxes = self._parse_label(label)
                for aug in self.det_aug_list:
                    img, boxes = aug(img, boxes)
                samples.append((img, boxes))
        except StopIteration:
            if not samples:
                raise
        pad = self.batch_size - len(samples)
        if pad and self.last_batch_handle == "discard":
            raise StopIteration
        while len(samples) < self.batch_size:
            samples.append(samples[-1])
        # batches pad to one static (B, max_objects, w) shape.  An
        # ESTIMATED pad size grows on under-estimate (shape changes,
        # one-time warning) rather than dropping ground truth; an
        # EXPLICIT max_objects= is a shape contract the consumer bound
        # to, so overflow there clamps with a warning instead.
        batch_max = max(s[1].shape[0] for s in samples)
        if batch_max > self._max_objects:
            import logging
            log = logging.getLogger("mxnet_tpu_torch")
            if self._explicit_max:
                if not self._overflow_warned:
                    log.warning(
                        "ImageDetIter: batch holds %d objects > "
                        "max_objects=%d; extra objects are dropped "
                        "(raise max_objects=)", batch_max,
                        self._max_objects)
                    self._overflow_warned = True
            else:
                if not self._overflow_warned:
                    log.warning(
                        "ImageDetIter: batch holds %d objects > "
                        "estimated max_objects=%d; growing the label "
                        "pad (pass max_objects= to fix the shape up "
                        "front)", batch_max, self._max_objects)
                    self._overflow_warned = True
                self._max_objects = batch_max
        max_obj = self._max_objects
        w = samples[0][1].shape[1]
        lab = _np.full((self.batch_size, max_obj, w), -1.0, _np.float32)
        dat = _np.stack([_np.transpose(
            s[0].asnumpy() if hasattr(s[0], "asnumpy")
            else _np.asarray(s[0]), (2, 0, 1)) for s in samples])
        for i, (_, b) in enumerate(samples):
            n = min(b.shape[0], max_obj)
            lab[i, :n] = b[:n]
        return mxio.DataBatch(data=[nd_array(dat)],
                              label=[nd_array(lab)], pad=pad)
