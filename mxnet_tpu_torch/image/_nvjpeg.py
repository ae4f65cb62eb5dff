"""JPEG decode on the card with nvJPEG, and a private encoder.

``kernels/csrc/nvjpeg_codec.cu`` is a small C interface over the CUDA
toolkit's nvJPEG (linked ``-lnvjpeg``, built like the kernels by
``kernels/_build.py``).  :class:`Codec` decodes a batch of JPEGs
straight into one uint8 buffer on the card, each image interleaved RGB
(HWC).  A greyscale image, or a colour one in 4:4:4, 4:2:2 or 4:2:0,
decodes to its planes and the ``jpeg_color`` kernel upsamples its chroma
and converts it to RGB with libjpeg's arithmetic (nvJPEG's own RGB output
replicates chroma); other layouts decode to nvJPEG's RGB one by one and
``jpeg_color`` copies them.  ``jpeg_color`` also takes the DCT scaling
of every image.  The batched decodes go to the card's hardware JPEG
decoders (``NVJPEG_BACKEND_HARDWARE``) where the machine exposes them,
and the images they refuse are decoded one by one; where it does not,
a batch goes to one batched call of the GPU hybrid backend (Huffman
decoding on the card), and a batch that backend refuses raises.
``backend`` names the batched backend taken and ``stats`` counts the
images decoded batched and alone.  The codec's state (handles, the
batched decode state and its buffers) lives as long as the codec and is
reused batch after batch; :func:`decoder` keeps one codec a device.

Decoding is the codec library's work, as libjpeg's is in the
reference's native loader; nvJPEG's IDCT is not libjpeg's, so its pixels
differ from OpenCV's (``tests/test_torch_image.py`` states the
tolerance on the fixtures).
A card decode that cannot load nvJPEG raises, naming it.

:meth:`Codec.encode` (baseline JPEG, 4:2:0 or 4:4:4) makes seeded test
records on a machine without OpenCV; ``recordio.pack_img`` keeps using
OpenCV.
"""
from __future__ import annotations

import ctypes
import logging
import threading

import torch

from ..base import MXNetError
from ..kernels import jpeg_color as JC

__all__ = ["Codec", "decoder"]

# nvjpegOutputFormat_t; nvjpegChromaSubsampling_t -> jpeg_color's layout;
# nvjpegBackend_t -> name
_OUTPUT_YUV, _OUTPUT_RGBI = 1, 5
_LAYOUTS = {0: JC.YUV444, 1: JC.YUV422, 2: JC.YUV420}
_BACKENDS = {2: "gpu_hybrid", 3: "hardware"}

_codecs = {}
_lock = threading.Lock()
_log = logging.getLogger("mxnet_tpu_torch")


def _lib():
    from ..kernels import _build
    try:
        lib = _build.load("nvjpeg_codec")
    except Exception as e:
        raise MXNetError("JPEG decode on the card needs nvJPEG (libnvjpeg of "
                         "the CUDA toolkit), which could not be built or "
                         "loaded: %s" % e) from e
    if lib.mxt_nvjpeg_decode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.mxt_nvjpeg_create.argtypes = [i, ctypes.POINTER(p), ip, ip]
        lib.mxt_nvjpeg_destroy.argtypes = [p]
        lib.mxt_nvjpeg_destroy.restype = None
        lib.mxt_nvjpeg_info.argtypes = [p, ctypes.c_char_p, ctypes.c_size_t,
                                        ip, ip, ip, ip]
        lib.mxt_nvjpeg_decode.argtypes = [
            p, i, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), i, ctypes.POINTER(p), ip, i, p,
            ip]
        lib.mxt_nvjpeg_encode.argtypes = [
            p, p, i, i, i, i, p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        for fn in (lib.mxt_nvjpeg_create, lib.mxt_nvjpeg_info,
                   lib.mxt_nvjpeg_decode, lib.mxt_nvjpeg_encode):
            fn.restype = i
    return lib


def _check(err, what):
    if err == 0:
        return
    if err >= 1000:
        raise MXNetError("nvJPEG %s failed: nvjpegStatus_t %d"
                         % (what, err - 1000))
    raise MXNetError("nvJPEG %s failed: CUDA error %d" % (what, err))


class Codec:
    """nvJPEG on one CUDA device: batched decode into card memory (on
    the hardware decoders where the machine exposes them, else on the
    GPU hybrid backend), and encode.  Calls from several threads take
    turns."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise MXNetError("nvJPEG decodes on a CUDA device, got %s"
                             % self.device)
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        self.device = torch.device("cuda", index)
        self._lib = _lib()
        self._h = ctypes.c_void_p()
        got, hw = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(self.device):
            _check(self._lib.mxt_nvjpeg_create(
                index, ctypes.byref(self._h), ctypes.byref(got),
                ctypes.byref(hw)), "create")
        self.backend = _BACKENDS.get(got.value, str(got.value))
        self.hardware_status = hw.value     # nvjpegStatus_t, -1 not tried
        self.stats = {"batched": 0, "single": 0, "planar": 0, "rgb": 0}
        self._mutex = threading.Lock()
        _log.info("nvJPEG on %s: batched decodes on the %s backend "
                  "(creating the hardware backend returned %d)",
                  self.device, self.backend, self.hardware_status)

    def __del__(self):
        h, lib = getattr(self, "_h", None), getattr(self, "_lib", None)
        if h and lib is not None:
            lib.mxt_nvjpeg_destroy(h)
            self._h = None

    def info(self, blob):
        """(height, width, components, subsampling, [component heights],
        [component widths]) of a JPEG, from its header (host only);
        raises on anything nvJPEG cannot read."""
        c, s = ctypes.c_int(), ctypes.c_int()
        hs, ws = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        with self._mutex:
            err = self._lib.mxt_nvjpeg_info(self._h, blob, len(blob),
                                            ctypes.byref(c), ctypes.byref(s),
                                            hs, ws)
        if err:
            raise MXNetError("nvJPEG cannot read this image (not a JPEG "
                             "nvJPEG decodes; nvjpegStatus_t %d)"
                             % (err - 1000 if err >= 1000 else err))
        return (hs[0], ws[0], c.value, s.value, list(hs[:c.value]),
                list(ws[:c.value]))

    @staticmethod
    def _layout(inf):
        """jpeg_color's layout of an image of info ``inf``: its planar
        kind, or ``RGB`` where nvJPEG decodes it only to interleaved RGB
        (the chroma layouts the kernel does not take)."""
        h, w, comps, ss, hs, ws = inf
        if comps == 1:
            return JC.GREY
        kind = _LAYOUTS.get(ss) if comps == 3 else None
        if kind is None:
            return JC.RGB
        ch, cw = JC._CHROMA[kind](h, w)
        if hs[1:] != [ch, ch] or ws[1:] != [cw, cw]:
            return JC.RGB
        return kind

    def _decode(self, blobs, fmt, ptrs, pitches, allow_batched):
        n = len(blobs)
        data = (ctypes.c_char_p * n)(*blobs)
        lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
        outs = (ctypes.c_void_p * (3 * n))(*ptrs)
        pitch = (ctypes.c_int * (3 * n))(*pitches)
        used = (ctypes.c_int * n)()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with self._mutex:
            err = self._lib.mxt_nvjpeg_decode(self._h, n, data, lens, fmt,
                                              outs, pitch,
                                              int(allow_batched), stream,
                                              used)
        _check(err, "decode")
        nb = sum(used)
        self.stats["batched"] += nb
        self.stats["single"] += n - nb

    def decode_planes(self, blobs, infos, out_offsets=None, denoms=None):
        """Decode JPEGs to their planes on the current stream (greyscale
        and planar colour layouts in one batched call to Y, Cb, Cr; the
        others one by one to interleaved RGB): (the flat uint8 scratch
        tensor on the card, the host ``jpeg_color.color_table`` of the
        batch, whose RGB outputs lie at ``out_offsets`` and are scaled by
        ``denoms``)."""
        kinds = [self._layout(inf) for inf in infos]
        denoms = denoms or [1] * len(blobs)
        table, nbytes = JC.color_table(
            [(kind, inf[0], inf[1], d)
             for kind, inf, d in zip(kinds, infos, denoms)], out_offsets)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        base = scratch.data_ptr()
        # a greyscale image has no chroma planes; its Cb and Cr channels
        # point at a throwaway plane of its size, which the kernel never
        # reads
        grey = max([inf[0] * inf[1] for inf, kind in zip(infos, kinds)
                    if kind == JC.GREY] or [0])
        spare = torch.empty(grey, dtype=torch.uint8, device=self.device)
        planar, rgb = ([], [], []), ([], [], [])
        for blob, kind, row in zip(blobs, kinds, table.tolist()):
            if kind == JC.RGB:
                rgb[0].append(blob)
                rgb[1].extend([base + row[0], 0, 0])
                rgb[2].extend([row[4] * 3, 0, 0])
            elif kind == JC.GREY:
                planar[0].append(blob)
                planar[1].extend([base + row[0], spare.data_ptr(),
                                  spare.data_ptr()])
                planar[2].extend([row[4]] * 3)
            else:
                planar[0].append(blob)
                planar[1].extend([base + row[0], base + row[1],
                                  base + row[2]])
                planar[2].extend([row[4], row[6], row[6]])
        if planar[0]:
            self._decode(planar[0], _OUTPUT_YUV, planar[1], planar[2], True)
            self.stats["planar"] += len(planar[0])
        if rgb[0]:
            self._decode(rgb[0], _OUTPUT_RGBI, rgb[1], rgb[2], False)
            self.stats["rgb"] += len(rgb[0])
        return scratch, table

    def decode_batch(self, blobs, infos=None, denoms=None):
        """Decode ``blobs`` (JPEG bytes) on the current stream into one
        flat uint8 tensor on the card, image after image, each (h, w, 3)
        RGB, as libjpeg does (nvJPEG's planes, then ``jpeg_color``);
        returns (buffer, [(h, w)] as written).  ``denoms`` asks for
        libjpeg's 1/d-scale decode of each image: each is written at its
        scaled size, ``jpeg_color.out_size``."""
        if infos is None:
            infos = [self.info(b) for b in blobs]
        denoms = denoms or [1] * len(blobs)
        sizes = [JC.out_size(inf[0], inf[1], d)
                 for inf, d in zip(infos, denoms)]
        offs, total = [], 0
        for h, w in sizes:
            offs.append(total)
            total += h * w * 3
        out = torch.empty(total, dtype=torch.uint8, device=self.device)
        if blobs:
            scratch, table = self.decode_planes(blobs, infos, offs, denoms)
            JC.jpeg_color(scratch, table.to(self.device), out,
                          max_pixels=max(h * w for h, w in sizes))
        return out, sizes

    def decode(self, blobs):
        """[(h, w, 3) uint8 tensors on the card] of ``blobs``."""
        buf, sizes = self.decode_batch(blobs)
        out, off = [], 0
        for h, w in sizes:
            out.append(buf[off:off + h * w * 3].view(h, w, 3))
            off += h * w * 3
        return out

    def encode(self, img, quality=95, subsampling=420):
        """JPEG bytes of an (h, w, 3) uint8 RGB tensor on the card
        (baseline, ``subsampling`` 420 or 444)."""
        if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3 \
                or img.device != self.device:
            raise MXNetError("encode takes an (h, w, 3) uint8 tensor on %s, "
                             "got %s %s on %s" % (self.device, img.dtype,
                                                  tuple(img.shape),
                                                  img.device))
        img = img.contiguous()
        h, w = img.shape[:2]
        stream = torch.cuda.current_stream(self.device).cuda_stream
        cap = h * w * 3 + 65536
        while True:
            out = ctypes.create_string_buffer(cap)
            n = ctypes.c_size_t()
            with self._mutex:
                err = self._lib.mxt_nvjpeg_encode(
                    self._h, img.data_ptr(), h, w, int(quality),
                    int(subsampling), stream, out, cap, ctypes.byref(n))
            if err == -1:
                cap = n.value
                continue
            _check(err, "encode")
            return out.raw[:n.value]


def decoder(device):
    """The process's :class:`Codec` for ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        if dev not in _codecs:
            _codecs[dev] = Codec(dev)
        return _codecs[dev]
