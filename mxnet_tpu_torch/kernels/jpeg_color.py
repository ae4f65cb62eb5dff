"""libjpeg's chroma upsampling and colour conversion on the card: the
CUDA kernel wrapper and its plain version.

``csrc/jpeg_color.cu`` (:func:`jpeg_color`) replaces no TPU kernel.  The
reference decodes JPEGs with libjpeg, whose defaults are fancy
upsampling (``jdsample.c``: a triangle filter for 4:2:2 and 4:2:0) and
fixed-point YCbCr -> RGB tables (``jdcolor.c``).  The port's card route
has nvJPEG decode a batch to its Y, Cb and Cr planes
(``image/_nvjpeg.py``) and this kernel finishes the decode as libjpeg
does, one launch a batch, writing each image as interleaved RGB (HWC)
into the batch buffer ``image_aug`` reads.  nvJPEG's own RGB output is
3-4 levels off libjpeg's on average for 4:2:0 images; with this kernel
only the IDCT's rounding is left.  Greyscale images take the same road
(their Y plane replicated); a layout with no planar kind here (4:4:0,
4:1:1, ...) is decoded by nvJPEG to interleaved RGB in the scratch buffer
(kind ``RGB``) and the kernel copies it.

A scale factor ``d`` > 1 stands in for libjpeg's DCT-domain 1/d decode
(which ``ImageRecordIter`` asks for on its random-crop path, with the
native loader's :func:`pick_denom`): libjpeg runs a reduced IDCT per
component so that each lands at ``ceil(h / d) x ceil(w / d)`` with no
upsampling; nvJPEG has no scaled IDCT, so each plane is box-averaged to
that size (Y by d, chroma by d over its full-resolution axes and by d / 2
over its halved ones, an RGB image by d; the mean rounded half up) and
then converted.  The card route scales nowhere else.

:func:`color_table` lays out a batch: for each image the offsets of its
planes in the scratch buffer, its size, its chroma planes' size, its
chroma layout and the offset of its RGB output.  :func:`jpeg_color_reference`
is the plain version in torch integer ops per image; CPU tensors use it,
and a CUDA tensor launches the kernel or raises.
``jpeg_color.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._counters import register

__all__ = ["jpeg_color", "jpeg_color_reference", "color_table", "out_size",
           "box_mean", "pick_denom", "min_short", "FIELDS", "GREY",
           "YUV444", "YUV422", "YUV420", "RGB"]

FIELDS = ("y", "cb", "cr", "h", "w", "ch", "cw", "kind", "out", "denom")
GREY, YUV444, YUV422, YUV420, RGB = 0, 1, 2, 3, 4
# the chroma plane's (height, width) of an (h, w) image, by layout
_CHROMA = {GREY: lambda h, w: (0, 0), YUV444: lambda h, w: (h, w),
           YUV422: lambda h, w: (h, -(-w // 2)),
           YUV420: lambda h, w: (-(-h // 2), -(-w // 2)),
           RGB: lambda h, w: (0, 0)}
# the chroma planes' box factors (rows, columns) at scale 1/d, by layout
_CHROMA_BOX = {YUV444: lambda d: (d, d), YUV422: lambda d: (d, d // 2),
               YUV420: lambda d: (d // 2, d // 2)}


def pick_denom(h, w, min_short):
    """The native ``PickScaleDenom``: the largest 1/2^k (k <= 3) scale
    keeping the short side >= ``min_short``; 1 when ``min_short`` <= 0."""
    if min_short <= 0:
        return 1
    short, denom = min(h, w), 1
    while denom < 8 and short // (denom * 2) >= min_short:
        denom *= 2
    return denom


def min_short(data_shape, rand_crop, resize, dct_scale):
    """The short side the native loader's DCT scaling keeps (0: none):
    on the random-crop path only, the resize target or the crop's larger
    side."""
    if not (dct_scale and rand_crop):
        return 0
    return resize if resize > 0 else max(data_shape[1], data_shape[2])


def plane_sizes(kind, h, w):
    """Bytes of the (Y, Cb, Cr) planes of an (h, w) image of ``kind``
    (an ``RGB`` image's interleaved pixels as its Y plane)."""
    if kind == RGB:
        return h * w * 3, 0, 0
    ch, cw = _CHROMA[kind](h, w)
    return h * w, ch * cw, ch * cw


def out_size(h, w, denom):
    """The (height, width) an (h, w) image is written at with factor
    ``denom``: libjpeg's scaled output size."""
    return -(-h // denom), -(-w // denom)


def color_table(images, out_offsets=None):
    """The (n, 10) int64 table of ``images`` [(kind, h, w, denom)] whose
    planes lie one after another (Y, Cb, Cr, then the next image) in the
    scratch buffer, and whose RGB outputs lie at ``out_offsets`` (by
    default one after another); returns (table, scratch bytes).
    ``denom`` is 1, 2, 4 or 8."""
    rows, off, out = [], 0, 0
    for k, (kind, h, w, denom) in enumerate(images):
        if denom not in (1, 2, 4, 8) or kind not in _CHROMA:
            raise ValueError("jpeg_color: scale 1/%d of layout %d"
                             % (denom, kind))
        ch, cw = _CHROMA[kind](h, w)
        sy, sc, _ = plane_sizes(kind, h, w)
        o = out if out_offsets is None else out_offsets[k]
        rows.append((off, off + sy, off + sy + sc, h, w, ch, cw, kind, o,
                     denom))
        off += sy + 2 * sc
        oh, ow = out_size(h, w, denom)
        out += oh * ow * 3
    table = torch.tensor(rows, dtype=torch.int64).reshape(-1, len(FIELDS))
    return table, off


def _up_h2v1(c):
    """jdsample.c h2v1_fancy_upsample of an (h, cw) int32 plane."""
    left = torch.cat([c[:, :1], c[:, :-1]], 1)
    right = torch.cat([c[:, 1:], c[:, -1:]], 1)
    even = (c * 3 + left + 1) >> 2
    odd = (c * 3 + right + 2) >> 2
    even[:, 0] = c[:, 0]
    odd[:, -1] = c[:, -1]
    return torch.stack([even, odd], 2).reshape(c.shape[0], -1)


def _up_h2v2(c):
    """jdsample.c h2v2_fancy_upsample of a (ch, cw) int32 plane."""
    above = torch.cat([c[:1], c[:-1]], 0)
    below = torch.cat([c[1:], c[-1:]], 0)
    rows = []
    for nb in (above, below):               # upper, then lower output row
        s = c * 3 + nb
        last = torch.cat([s[:, :1], s[:, :-1]], 1)
        nxt = torch.cat([s[:, 1:], s[:, -1:]], 1)
        even = (s * 3 + last + 8) >> 4
        odd = (s * 3 + nxt + 7) >> 4
        even[:, 0] = (s[:, 0] * 4 + 8) >> 4
        odd[:, -1] = (s[:, -1] * 4 + 7) >> 4
        rows.append(torch.stack([even, odd], 2).reshape(c.shape[0], -1))
    return torch.stack(rows, 1).reshape(-1, rows[0].shape[1])


def box_mean(x, fy, fx=None):
    """The fy x fx (default f x f) block means of an (h, w, ...) integer
    tensor, clipped at its edges and rounded half up, to (ceil(h / fy),
    ceil(w / fx), ...) int32; the box average that stands in for
    libjpeg's DCT scaling."""
    fx = fy if fx is None else fx
    if fy == fx == 1:
        return x.to(torch.int32)
    h, w = x.shape[:2]
    oh, ow = -(-h // fy), -(-w // fx)
    pad = torch.zeros((oh * fy, ow * fx) + tuple(x.shape[2:]),
                      dtype=torch.int32, device=x.device)
    pad[:h, :w] = x
    n = torch.zeros(oh * fy, ow * fx, dtype=torch.int32, device=x.device)
    n[:h, :w] = 1
    s = pad.reshape((oh, fy, ow, fx) + tuple(x.shape[2:])).sum((1, 3))
    n = n.reshape(oh, fy, ow, fx).sum((1, 3)).reshape(
        (oh, ow) + (1,) * (x.dim() - 2))
    return (s + n // 2) // n


def _check(planes, table, out):
    for name, t in (("planes", planes), ("out", out)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError("jpeg_color: %s must be a flat uint8 tensor, "
                             "got %s %s" % (name, t.dtype, tuple(t.shape)))
    if table.dtype != torch.int64 or table.dim() != 2 or \
            table.shape[1] != len(FIELDS):
        raise ValueError("jpeg_color: table must be (n, %d) int64, got %s "
                         "%s" % (len(FIELDS), table.dtype,
                                 tuple(table.shape)))
    for name, t in (("table", table), ("out", out)):
        if t.device != planes.device:
            raise ValueError("jpeg_color: %s on %s, planes on %s"
                             % (name, t.device, planes.device))


def jpeg_color_reference(planes, table, out):
    """Plain version of the kernel: each image's planes upsampled and
    converted as libjpeg does, in torch integer ops, written into
    ``out`` (flat uint8) at its offset; returns ``out``."""
    _check(planes, table, out)
    for r in table.tolist():
        t = dict(zip(FIELDS, r))
        h, w, d = t["h"], t["w"], t["denom"]
        oh, ow = out_size(h, w, d)
        if t["kind"] == RGB:
            rgb = box_mean(planes[t["y"]:t["y"] + h * w * 3].reshape(
                h, w, 3), d)
            out[t["out"]:t["out"] + oh * ow * 3] = \
                rgb.to(torch.uint8).reshape(-1)
            continue
        Y = box_mean(planes[t["y"]:t["y"] + h * w].reshape(h, w), d)
        if t["kind"] == GREY:
            rgb = torch.stack([Y, Y, Y], 2)
        else:
            ch, cw = t["ch"], t["cw"]
            planes_c = []
            for key in ("cb", "cr"):
                c = planes[t[key]:t[key] + ch * cw].reshape(ch, cw) \
                    .to(torch.int32)
                if d > 1:
                    c = box_mean(c, *_CHROMA_BOX[t["kind"]](d))
                elif t["kind"] == YUV422:
                    c = _up_h2v1(c)
                elif t["kind"] == YUV420:
                    c = _up_h2v2(c)
                planes_c.append(c[:oh, :ow] - 128)
            cb, cr = planes_c
            rgb = torch.stack([
                Y + ((91881 * cr + 32768) >> 16),
                Y + ((-22554 * cb + 32768 - 46802 * cr) >> 16),
                Y + ((116130 * cb + 32768) >> 16)], 2)
        out[t["out"]:t["out"] + oh * ow * 3] = \
            rgb.clamp(0, 255).to(torch.uint8).reshape(-1)
    return out


def _fn():
    fn = _build.load("jpeg_color").mxt_jpeg_color
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def jpeg_color(planes, table, out, max_pixels=None):
    """Write each image of ``table`` as interleaved RGB into ``out`` (see
    :func:`jpeg_color_reference`); returns ``out``.  CUDA tensors launch
    ``csrc/jpeg_color.cu`` (one launch a batch; ``max_pixels``, the
    largest output's pixels, saves reading the table back from the card);
    CPU tensors run the plain version."""
    if planes.device.type == "cpu":
        return jpeg_color_reference(planes, table, out)
    _check(planes, table, out)
    n = table.shape[0]
    if n == 0:
        return out
    if max_pixels is None:
        d = table[:, 9]
        max_pixels = int((((table[:, 3] + d - 1) // d)
                          * ((table[:, 4] + d - 1) // d)).max())
    pixels = int(max_pixels)
    table = table.contiguous()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    err = _fn()(planes.data_ptr(), table.data_ptr(), n, pixels,
                out.data_ptr(), stream)
    _build.check(err, "jpeg_color")
    jpeg_color.launches += 1
    return out


register(jpeg_color, "launches")
