"""The augment stages of ``ImageRecordIter``'s card route: the CUDA
kernel wrapper and its plain version.

``csrc/image_aug.cu`` (:func:`image_aug`) replaces no TPU kernel: the
reference augments on the host, in the C++ decode threads
(``native/src/image_loader.cc:405-460``).  The port's card route decodes
a batch of JPEG records with nvJPEG into one uint8 buffer on the card
(``image/_nvjpeg.py``; the DCT scaling is the decode's, done by
``jpeg_color``) and this kernel turns it into the ``(B, C, H, W)`` (or
NHWC) f32 batch in one launch, with the native code's arithmetic: the
short-side bilinear resize and the resize-up to the crop (each rounded
to uint8, as the native code rounds), the crop, the mirror, and
``(pix * scale - mean) * inv_std``.

:func:`aug_table` plans a batch on the host: each image's sizes after
each stage, its crop origin and mirror flag.  Crop origins and flips
come from a seeded ``numpy.random.RandomState`` in the order of the
reference's Python loader (``io.py _PyImageRecordImpl``: per image, y
then x, then the flip); they cannot follow the native loader's
per-thread ``mt19937_64`` streams, whose assignment of images to threads
changes from run to run.

:func:`image_aug_reference` is the plain version, the same stages per
image in torch ops on whole intermediate images; CPU tensors use it,
and a CUDA tensor launches the kernel or raises.  ``image_aug.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as _np
import torch

from . import _build
from ._counters import register

__all__ = ["image_aug", "image_aug_reference", "aug_table", "FIELDS"]

FIELDS = ("off", "h", "w", "rh", "rw", "uh", "uw", "y0", "x0", "mirror")


def aug_table(sizes, data_shape, rng, rand_crop=False, rand_mirror=False,
              resize=0):
    """The (B, 10) int64 table of a batch: ``sizes`` are the decoded (and
    DCT-scaled) images' (h, w), laid one after another in the batch
    buffer (3 bytes a pixel); ``rng`` a ``numpy.random.RandomState``."""
    _, H, W = data_shape
    rows, off = [], 0
    for h, w in sizes:
        rh, rw = h, w
        if resize > 0:
            if h < w:
                rh, rw = resize, w * resize // h
            else:
                rh, rw = h * resize // w, resize
        uh, uw = (max(rh, H), max(rw, W)) if rh < H or rw < W else (rh, rw)
        if rand_crop:
            y0 = rng.randint(0, uh - H + 1)
            x0 = rng.randint(0, uw - W + 1)
        else:
            y0, x0 = (uh - H) // 2, (uw - W) // 2
        mirror = int(rand_mirror and rng.randint(2))
        rows.append((off, h, w, rh, rw, uh, uw, y0, x0, mirror))
        off += h * w * 3
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, len(FIELDS))


def _check(buf, table, data_shape, layout):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError("image_aug: buf must be a flat uint8 tensor, got "
                         "%s %s" % (buf.dtype, tuple(buf.shape)))
    if table.dtype != torch.int64 or table.dim() != 2 or \
            table.shape[1] != len(FIELDS):
        raise ValueError("image_aug: table must be (B, %d) int64, got %s %s"
                         % (len(FIELDS), table.dtype, tuple(table.shape)))
    if table.device != buf.device:
        raise ValueError("image_aug: table on %s, buf on %s"
                         % (table.device, buf.device))
    if len(data_shape) != 3 or not 1 <= data_shape[0] <= 3:
        raise ValueError("image_aug: data_shape must be (C <= 3, H, W), got "
                         "%r" % (data_shape,))
    if layout not in ("NCHW", "NHWC"):
        raise ValueError("image_aug: layout must be NCHW or NHWC, got %r"
                         % (layout,))


def _consts(mean, std, scale):
    f = _np.float32
    mean = _np.asarray(mean, f).reshape(3)
    inv_std = f(1) / _np.asarray(std, f).reshape(3)
    return mean, inv_std, f(scale)


def _bilinear(img, oh, ow):
    """The native ``ResizeBilinear`` of an (h, w, 3) uint8 tensor, in
    f32 operations in the native code's order."""
    h, w = img.shape[:2]
    dev = img.device

    def axis(n, on):
        s = torch.tensor(_np.float32(n) / _np.float32(on), device=dev)
        f = (torch.arange(on, dtype=torch.float32, device=dev)
             + torch.tensor(0.5, device=dev)) * s - torch.tensor(0.5,
                                                                 device=dev)
        a = torch.floor(f)
        wt = f - a
        a = a.long()
        return a.clamp(min=0), (a + 1).clamp(max=n - 1), wt

    y0, y1, wy = axis(h, oh)
    x0, x1, wx = axis(w, ow)
    one = torch.tensor(1.0, device=dev)
    p = img.float()
    wx, ux = wx[None, :, None], (one - wx)[None, :, None]
    wy, uy = wy[:, None, None], (one - wy)[:, None, None]
    r0, r1 = p[y0], p[y1]
    top = r0[:, x0] * ux + r0[:, x1] * wx
    bot = r1[:, x0] * ux + r1[:, x1] * wx
    v = top * uy + bot * wy + torch.tensor(0.5, device=dev)
    return v.clamp(0.0, 255.0).to(torch.uint8)


def image_aug_reference(buf, table, data_shape, mean=(0.0, 0.0, 0.0),
                        std=(1.0, 1.0, 1.0), scale=1.0, layout="NCHW"):
    """Plain version of the kernel: the stages per image in torch ops.
    ``buf`` the batch's decoded images (flat uint8, each (h, w, 3)),
    ``table`` from :func:`aug_table` -> the f32 batch."""
    _check(buf, table, data_shape, layout)
    C, H, W = data_shape
    mean, inv_std, scale = _consts(mean, std, scale)
    dev = buf.device
    mean_t = torch.as_tensor(mean[:C], device=dev)
    inv_t = torch.as_tensor(inv_std[:C], device=dev)
    scale_t = torch.tensor(scale, device=dev)
    outs = []
    for r in table.tolist():
        t = dict(zip(FIELDS, r))
        img = buf[t["off"]:t["off"] + t["h"] * t["w"] * 3].reshape(
            t["h"], t["w"], 3)
        if (t["rh"], t["rw"]) != (t["h"], t["w"]):
            img = _bilinear(img, t["rh"], t["rw"])
        if (t["uh"], t["uw"]) != (t["rh"], t["rw"]):
            img = _bilinear(img, t["uh"], t["uw"])
        img = img[t["y0"]:t["y0"] + H, t["x0"]:t["x0"] + W, :C]
        if t["mirror"]:
            img = img.flip(1)
        v = (img.float() * scale_t - mean_t) * inv_t
        outs.append(v.permute(2, 0, 1) if layout == "NCHW" else v)
    if not outs:
        shape = (0, C, H, W) if layout == "NCHW" else (0, H, W, C)
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return torch.stack(outs).contiguous()


def _fn():
    fn = _build.load("image_aug").mxt_image_aug
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_float,
                       ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), i, p, p]
        fn.restype = ctypes.c_int
    return fn


def image_aug(buf, table, data_shape, mean=(0.0, 0.0, 0.0),
              std=(1.0, 1.0, 1.0), scale=1.0, layout="NCHW"):
    """The f32 batch of ``buf``'s images as ``table`` plans them (see
    :func:`image_aug_reference`).  CUDA tensors launch
    ``csrc/image_aug.cu`` (one launch a batch); CPU tensors run the plain
    version."""
    if buf.device.type == "cpu":
        return image_aug_reference(buf, table, data_shape, mean, std, scale,
                                   layout)
    _check(buf, table, data_shape, layout)
    C, H, W = data_shape
    B = table.shape[0]
    mean, inv_std, scale = _consts(mean, std, scale)
    shape = (B, C, H, W) if layout == "NCHW" else (B, H, W, C)
    out = torch.empty(shape, dtype=torch.float32, device=buf.device)
    if B == 0:
        return out
    table = table.contiguous()
    f3 = ctypes.c_float * 3
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    err = _fn()(buf.data_ptr(), table.data_ptr(), B, H, W, C,
                float(scale), f3(*mean.tolist()), f3(*inv_std.tolist()),
                int(layout == "NHWC"), out.data_ptr(), stream)
    _build.check(err, "image_aug")
    image_aug.launches += 1
    return out


register(image_aug, "launches")
