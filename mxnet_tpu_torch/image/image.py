"""Image decode, resize, augmenters and ``ImageIter``.

Port of ``mxnet_tpu/image/image.py`` (upstream
``python/mxnet/image/image.py``).

* Decode: a CPU context decodes with OpenCV, as the reference does
  (imported when called); where OpenCV is missing, a colour decode
  (``flag=1``) goes through the port's native libjpeg/libpng copy
  (``native.imdecode``), which gives OpenCV's pixels on the fixtures of
  ``tests/data/torch_image``.  A card context (the default) decodes a
  JPEG with nvJPEG straight into card memory (``image/_nvjpeg.py``);
  a PNG there raises, naming the format.
* Resize: the port's own, in torch on the input's device, for OpenCV's
  five modes (nearest, linear, cubic, area, Lanczos-4) plus ``interp``
  9 (linear) and 10 (a random mode).  Each axis gets OpenCV's source
  taps and coefficients (``cv::resize``'s coordinate mapping: half-pixel
  centres, ``INTER_NEAREST`` the floor of ``x * src / dst``); a uint8
  image takes OpenCV's 11-bit fixed-point coefficients and its integer
  rounding, a float image float coefficients.  ``tests/test_torch_image.py``
  states each mode's largest difference from OpenCV and the share of
  pixels that differ.
* The augmenters act on an image where it lies and draw from Python's
  ``random`` and numpy in the reference's order, so one seed gives both
  packages the same crops, flips and jitters.
* ``ImageIter`` decodes and augments on the host and builds each batch
  on the current context, as ``NDArrayIter`` does.
"""
from __future__ import annotations

import math
import os
import random as pyrandom

import numpy as _np
import torch

from ..base import MXNetError
from ..context import cpu, current_context
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray
from .. import io as mxio
from .. import recordio

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop", "color_normalize",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "RandomCropAug", "CenterCropAug", "ResizeAug", "ForceResizeAug",
           "SequentialAug", "RandomOrderAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "RandomSizedCropAug",
           "CreateAugmenter", "Augmenter", "ImageIter"]

# OpenCV's interpolation codes (cv2.INTER_*), which the reference's
# _interp returns
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = \
    0, 1, 2, 3, 4
_COEF_BITS = 11                      # OpenCV's INTER_RESIZE_COEF_BITS
_COEF_SCALE = 1 << _COEF_BITS


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _is_png(buf):
    return bytes(buf[:8]) == b"\x89PNG\r\n\x1a\n"


def _host_decode(buf, flag):
    """HWC uint8 (or HW for flag 0) numpy array in OpenCV's BGR order."""
    cv2 = _cv2()
    arr = _np.frombuffer(bytes(buf), dtype=_np.uint8)
    if cv2 is not None:
        img = cv2.imdecode(arr, flag)
        if img is None:
            raise MXNetError("Decoding failed; invalid image data")
        return img
    from .. import native
    if flag != 1 or not native.available():
        raise MXNetError("imdecode on the CPU needs OpenCV (the cv2 "
                         "module), which is not installed%s"
                         % ("" if flag == 1 else
                            " (the native decoder reads colour only)"))
    return native.imdecode(arr)[:, :, ::-1]       # RGB -> BGR


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode an image byte buffer to an NDArray (HWC uint8, RGB by
    default) on ``ctx`` (default: the current context).  A CPU context
    decodes with OpenCV; a card context decodes a JPEG with nvJPEG on
    the card (colour only) and refuses any other format."""
    ctx = current_context() if ctx is None else ctx
    if isinstance(buf, NDArray):
        buf = buf.asnumpy()
    if ctx.device_type == "gpu":
        if flag != 1:
            raise MXNetError("imdecode on the card decodes colour images "
                             "(flag=1) only, got flag=%r" % (flag,))
        if _is_png(buf):
            raise MXNetError("imdecode on the card: PNG is not decoded on "
                             "the card (nvJPEG reads JPEG only); pass "
                             "ctx=mx.cpu()")
        from . import _nvjpeg
        img = _nvjpeg.decoder(ctx.torch_device).decode([bytes(buf)])[0]
        if not to_rgb:
            img = img.flip(2)
        res = NDArray(img.contiguous(), ctx)
    else:
        img = _host_decode(buf, flag)
        if to_rgb and img.ndim == 3:
            img = img[:, :, ::-1]
        res = nd.array(_np.ascontiguousarray(img), ctx=ctx, dtype="uint8")
    if out is not None:
        out[:] = res
        return out
    return res


def imread(filename, flag=1, to_rgb=True, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb, ctx=ctx)


# ------------------------------------------------------------------ resize --
def _cubic_coeffs(fx):
    """OpenCV's interpolateCubic (A = -0.75), in float32."""
    f = _np.float32
    A = f(-0.75)
    x = f(fx)
    x1 = x + f(1)
    c0 = ((A * x1 - f(5) * A) * x1 + f(8) * A) * x1 - f(4) * A
    c1 = ((A + f(2)) * x - (A + f(3))) * x * x + f(1)
    y = f(1) - x
    c2 = ((A + f(2)) * y - (A + f(3))) * y * y + f(1)
    c3 = f(1) - c0 - c1 - c2
    return [c0, c1, c2, c3]


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0),
               (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_coeffs(fx):
    """OpenCV's interpolateLanczos4, in float32."""
    x = float(fx)
    if x < _np.finfo(_np.float32).eps:
        out = [_np.float32(0)] * 8
        out[3] = _np.float32(1)
        return out
    y0 = -(x + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = []
    total = _np.float32(0)
    for i in range(8):
        y = -(x + 3 - i) * math.pi * 0.25
        c = _np.float32((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0)
                        / (y * y))
        coeffs.append(c)
        total = total + c
    inv = _np.float32(1) / total
    return [c * inv for c in coeffs]


def _axis_taps(ssize, dsize, mode):
    """(source index (dsize, K) int64, float32 coefficients (dsize, K))
    of one axis, as ``cv::resize`` computes them (indices clamped to the
    image: OpenCV replicates the border)."""
    scale = float(ssize) / dsize            # OpenCV's scale_x (double)
    inv_scale = float(dsize) / ssize
    if mode == INTER_CUBIC:
        ksize = 4
    elif mode == INTER_LANCZOS4:
        ksize = 8
    else:
        ksize = 2
    k2 = ksize // 2
    idx = _np.zeros((dsize, ksize), _np.int64)
    cof = _np.zeros((dsize, ksize), _np.float32)
    for dx in range(dsize):
        if mode != INTER_AREA:
            fx = _np.float32((dx + 0.5) * scale - 0.5)
            sx = int(math.floor(fx))
            fx = _np.float32(fx - _np.float32(sx))
        else:
            sx = int(math.floor(dx * scale))
            fx = _np.float32((dx + 1) - (sx + 1) * inv_scale)
            fx = _np.float32(0) if fx <= 0 else \
                _np.float32(fx - _np.float32(math.floor(fx)))
        if mode not in (INTER_CUBIC, INTER_LANCZOS4):
            if sx < 0:
                fx, sx = _np.float32(0), 0
            if sx + k2 >= ssize and sx >= ssize - 1:
                fx, sx = _np.float32(0), ssize - 1
        if mode == INTER_CUBIC:
            c = _cubic_coeffs(fx)
        elif mode == INTER_LANCZOS4:
            c = _lanczos4_coeffs(fx)
        else:
            c = [_np.float32(1) - fx, fx]
        cof[dx] = c
        idx[dx] = _np.clip(_np.arange(ksize) + sx - k2 + 1, 0, ssize - 1)
    return idx, cof


def _area_weights(ssize, dsize):
    """OpenCV's computeResizeAreaTab as a dense (dsize, ssize) float64
    matrix: each output cell averages the source cells it covers."""
    scale = float(ssize) / dsize
    w = _np.zeros((dsize, ssize), _np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(math.ceil(fsx1)), int(math.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] += float(_np.float32((sx1 - fsx1) / cell))
        for sx in range(sx1, sx2):
            w[dx, sx] += float(_np.float32(1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] += float(_np.float32(min(min(fsx2 - sx2, 1.0), cell)
                                            / cell))
    return w


def _resize_tensor(img, w, h, mode):
    """``img`` (H, W, C) tensor resized to (h, w, C) as ``cv2.resize``
    does, on ``img``'s device, in ``img``'s dtype."""
    H, W = img.shape[:2]
    dev, dtype = img.device, img.dtype
    if mode == INTER_NEAREST:
        iy = _np.minimum(_np.floor(_np.arange(h) * (1.0 / (h / H))), H - 1)
        ix = _np.minimum(_np.floor(_np.arange(w) * (1.0 / (w / W))), W - 1)
        iy = torch.as_tensor(iy.astype(_np.int64), device=dev)
        ix = torch.as_tensor(ix.astype(_np.int64), device=dev)
        return img.index_select(0, iy).index_select(1, ix)
    scale_x, scale_y = W / w, H / h
    fast = abs(scale_x - round(scale_x)) < 2.2e-16 and \
        abs(scale_y - round(scale_y)) < 2.2e-16
    if mode == INTER_LINEAR and fast and round(scale_x) == 2 and \
            round(scale_y) == 2:
        mode = INTER_AREA                 # OpenCV's own substitution
    if mode == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        x = img.to(torch.float64)
        if fast:
            sx, sy = int(round(scale_x)), int(round(scale_y))
            x = x[:h * sy, :w * sx].reshape(h, sy, w, sx, -1).sum((1, 3))
            if dtype == torch.uint8:            # OpenCV's (sum + n/2) / n
                return torch.div(x + (sx * sy) // 2, sx * sy,
                                 rounding_mode="floor").to(torch.uint8)
            out = x / (sx * sy)
        else:
            wy = torch.as_tensor(_area_weights(H, h), device=dev)
            wx = torch.as_tensor(_area_weights(W, w), device=dev)
            out = torch.einsum("yh,hwc,xw->yxc", wy, x, wx)
        if dtype == torch.uint8:
            return torch.round(out).clamp(0, 255).to(torch.uint8)
        return out.to(dtype)
    (ix, ax), (iy, ay) = _axis_taps(W, w, mode), _axis_taps(H, h, mode)
    ix, iy = (torch.as_tensor(t, device=dev) for t in (ix, iy))
    if dtype == torch.uint8:
        ax = torch.as_tensor(_np.rint(ax.astype(_np.float64) * _COEF_SCALE)
                             .astype(_np.int64), device=dev)
        ay = torch.as_tensor(_np.rint(ay.astype(_np.float64) * _COEF_SCALE)
                             .astype(_np.int64), device=dev)
        s = img.to(torch.int64)
        # horizontal pass: (H, w, C) integer sums
        hz = (s[:, ix, :] * ax[None, :, :, None]).sum(2)
        rows = hz[iy]                              # (h, K, w, C)
        if mode in (INTER_LINEAR, INTER_AREA):
            # OpenCV's vector path: (hi16((S0 >> 4) * b0) + hi16((S1 >> 4)
            # * b1) + 2) >> 2
            t = ((rows >> 4) * ay[:, :, None, None]) >> 16
            out = (t.sum(1) + 2) >> 2
        else:
            out = ((rows * ay[:, :, None, None]).sum(1)
                   + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
        return out.clamp(0, 255).to(torch.uint8)
    ax = torch.as_tensor(ax, device=dev)
    ay = torch.as_tensor(ay, device=dev)
    x = img.to(torch.float32)
    hz = (x[:, ix, :] * ax[None, :, :, None]).sum(2)
    out = (hz[iy] * ay[:, :, None, None]).sum(1)
    return out.to(dtype)


def imresize(src, w, h, interp=1):
    """``src`` (an HWC NDArray or numpy array) resized to ``h`` x ``w``
    on its device; ``interp`` as OpenCV's codes (see :func:`_interp`)."""
    ctx = src.context if isinstance(src, NDArray) else cpu()
    t = src._data if isinstance(src, NDArray) else torch.as_tensor(
        _np.ascontiguousarray(src))
    squeeze = t.dim() == 2
    if squeeze:
        t = t[:, :, None]
    out = _resize_tensor(t, int(w), int(h), _interp(interp))
    if squeeze:
        out = out[:, :, 0]
    return NDArray(out.contiguous(), ctx)


def _interp(interp):
    """The OpenCV interpolation code of MXNet's ``interp``: 0-4 as
    OpenCV's, 9 linear, 10 one of the five at random (drawn from Python's
    ``random`` as the reference draws it), others linear."""
    table = {0: INTER_NEAREST, 1: INTER_LINEAR, 2: INTER_CUBIC,
             3: INTER_AREA, 4: INTER_LANCZOS4}
    if interp == 9:
        return INTER_LINEAR
    if interp == 10:
        return pyrandom.choice(list(table.values()))
    return table.get(interp, INTER_LINEAR)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        new_ratio = _np.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(_np.sqrt(target_area * new_ratio)))
        new_h = int(round(_np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


def _const(value, like):
    """``value`` as a float32 NDArray on ``like``'s context."""
    ctx = like.context if isinstance(like, NDArray) else cpu()
    return nd.array(_np.asarray(value, dtype=_np.float32), ctx=ctx)


class Augmenter:
    """Image augmenter base (reference: ``mx.image.Augmenter``)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([type(self).__name__, self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src.flip(axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = src * _const(self.coef, src)
        gray = (3.0 * (1.0 - alpha) / gray.size) * nd.sum(gray)
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = src * _const(self.coef, src)
        gray = nd.sum(gray, axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]])
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]])

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        t = _np.dot(_np.dot(self.ityiq, bt), self.tyiq).T
        return nd.dot(src, _const(t, src))


class ColorJitterAug(Augmenter):
    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self.augs = []
        if brightness > 0:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        augs = list(self.augs)
        pyrandom.shuffle(augs)
        for aug in augs:
            src = aug(src)
        return src


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src + _const(rgb, src)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = None if mean is None else \
            _np.asarray(mean, _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)

    def __call__(self, src):
        return color_normalize(
            src, None if self.mean is None else _const(self.mean, src),
            None if self.std is None else _const(self.std, src))


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list (reference: ``mx.image.CreateAugmenter``,
    the same knobs as ``ImageRecordIter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and _np.any(_np.asarray(mean) > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(mxio.DataIter):
    """Image iterator over .rec files or .lst + folder (reference:
    ``mx.image.ImageIter``); per-worker sharding by
    ``part_index``/``num_parts``.  Images decode and augment on the host;
    each batch is built on the current context."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 path_imgidx=None, shuffle=False, part_index=0,
                 num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", **kwargs):
        super().__init__(batch_size)
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle

        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            idx_path = path_imgidx or (path_imgrec[:-4] + ".idx")
            if os.path.exists(idx_path):
                self.imgrec = recordio.MXIndexedRecordIO(
                    idx_path, path_imgrec, "r")
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.seq = None
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = _np.asarray(parts[1:-1], dtype=_np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
        elif imglist is not None:
            self.imglist = {}
            for i, rec in enumerate(imglist):
                self.imglist[i] = (_np.asarray(rec[0],
                                               dtype=_np.float32).reshape(-1),
                                   rec[1])
            self.seq = list(self.imglist.keys())

        if self.seq is not None and num_parts > 1:
            per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * per:(part_index + 1) * per]

        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self._cache = None
        self.data_name = data_name
        self.label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [mxio.DataDesc(self.data_name,
                              (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [mxio.DataDesc(self.label_name, shape)]

    def reset(self):
        if self.shuffle and self.seq is not None:
            _np.random.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), "rb") as f:
                return label, f.read()
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = _np.zeros((batch_size, h, w, c), dtype=_np.float32)
        batch_label = _np.zeros((batch_size, self.label_width),
                                dtype=_np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                img = imdecode(s, ctx=cpu())
                for aug in self.auglist:
                    img = aug(img)
                batch_data[i] = img.asnumpy()
                batch_label[i] = label
                i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = batch_size - i
        if pad and self.last_batch_handle == "discard":
            raise StopIteration
        data = nd.array(batch_data.transpose(0, 3, 1, 2))
        label = nd.array(batch_label.reshape(-1)
                         if self.label_width == 1 else batch_label)
        return mxio.DataBatch(data=[data], label=[label], pad=pad)


@mxio.register_iter("ImageRecordIter")
def _image_record_iter(**kwargs):
    """The registry's ``ImageRecordIter`` (reference C++:
    ``src/io/iter_image_recordio_2.cc``): the C++ iterator's keywords
    mapped onto :class:`ImageIter` behind a background prefetch."""
    batch_size = kwargs.pop("batch_size")
    data_shape = kwargs.pop("data_shape")
    mapped = dict(
        path_imgrec=kwargs.pop("path_imgrec", None),
        path_imgidx=kwargs.pop("path_imgidx", None),
        shuffle=kwargs.pop("shuffle", False),
        part_index=kwargs.pop("part_index", 0),
        num_parts=kwargs.pop("num_parts", 1),
        rand_crop=kwargs.pop("rand_crop", False),
        rand_mirror=kwargs.pop("rand_mirror", False),
        label_width=kwargs.pop("label_width", 1),
    )
    mean = None
    if all(k in kwargs for k in ("mean_r", "mean_g", "mean_b")):
        mean = _np.array([kwargs.pop("mean_r"), kwargs.pop("mean_g"),
                          kwargs.pop("mean_b")])
    std = None
    if all(k in kwargs for k in ("std_r", "std_g", "std_b")):
        std = _np.array([kwargs.pop("std_r"), kwargs.pop("std_g"),
                         kwargs.pop("std_b")])
    it = ImageIter(batch_size, data_shape, mean=mean, std=std, **mapped)
    if kwargs.pop("prefetch", True):
        return mxio.PrefetchingIter(it)
    return it
