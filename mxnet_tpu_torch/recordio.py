"""RecordIO: the binary record container and its indexed variant.

Port of ``mxnet_tpu/recordio.py``, wire-compatible with the dmlc format
(a file written by either package reads in the other): each record is
``[kMagic u32][cflag:3|len:29 u32][payload][pad to 4 B]``, a payload
that holds the magic is split into continuation records, and an
``.idx`` sidecar maps integer keys to byte offsets.  ``IRHeader`` packs
``[flag u32][label f32][id u64][id2 u64]`` with multi-label payloads
inlined after the header when ``flag > 0``.  ``pack_img`` and
``unpack_img`` encode and decode with OpenCV, imported when they are
called.
"""
from __future__ import annotations

import collections
import os
import struct
import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


def _lrec(cflag, length):
    return (cflag << 29) | length


def _cflag(lrec):
    return lrec >> 29


def _length(lrec):
    return lrec & _LEN_MASK


class MXRecordIO:
    """Sequential record reader/writer (reference: ``MXRecordIO``)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.record = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.record = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.record = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if not self.is_open:
            return
        self.record.close()
        self.is_open = False
        self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["record"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d["is_open"]
        self.is_open = False
        self.record = None
        if is_open:
            self.open()

    def _check_pid(self):
        # reopen after fork (a DataLoader worker reads its own handle)
        if self.pid != os.getpid():
            pos = self.record.tell() if self.is_open else 0
            self.close()
            self.open()
            if self.flag == "r":
                self.record.seek(pos)

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid()
        magic_bytes = struct.pack("<I", _KMAGIC)
        # split payload on embedded magic (dmlc continuation encoding)
        chunks = []
        data = bytes(buf)
        start = 0
        while True:
            idx = data.find(magic_bytes, start)
            if idx == -1:
                chunks.append(data[start:])
                break
            chunks.append(data[start:idx])
            start = idx + 4
        n = len(chunks)
        for i, chunk in enumerate(chunks):
            if n == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == n - 1:
                cflag = 3
            else:
                cflag = 2
            self.record.write(magic_bytes)
            self.record.write(struct.pack("<I", _lrec(cflag, len(chunk))))
            self.record.write(chunk)
            pad = (4 - len(chunk) % 4) % 4
            if pad:
                self.record.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid()
        out = b""
        first = True
        while True:
            header = self.record.read(8)
            if len(header) < 8:
                return None if first else out
            magic, lrec = struct.unpack("<II", header)
            if magic != _KMAGIC:
                raise MXNetError("Invalid RecordIO magic at offset %d"
                                 % (self.record.tell() - 8))
            cflag, length = _cflag(lrec), _length(lrec)
            data = self.record.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.record.read(pad)
            if not first:
                out += struct.pack("<I", _KMAGIC)
            out += data
            first = False
            if cflag in (0, 3):
                return out

    def tell(self):
        return self.record.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Keyed random-access records via an ``.idx`` sidecar (reference:
    ``MXIndexedRecordIO``)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        if self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def seek(self, idx):
        assert not self.writable
        self._check_pid()
        self.record.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        assert self.writable
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(idx), pos))
        self.idx[idx] = pos
        self.keys.append(idx)


IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into a record payload (reference:
    ``recordio.pack``)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = _np.asarray(header.label, dtype=_np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2) + label.tobytes()
    return hdr + s


def unpack(s):
    """Unpack a record payload into (IRHeader, bytes)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        arr = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        header = IRHeader(flag, arr, id_, id2)
        s = s[flag * 4:]
    else:
        header = IRHeader(flag, label, id_, id2)
    return header, s


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("recordio.pack_img and unpack_img need OpenCV "
                          "(the cv2 module), which is not installed") from e
    return cv2


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack header + image array, encoding with OpenCV."""
    cv2 = _cv2()
    encode_params = None
    if img_fmt.lower() in (".jpg", ".jpeg"):
        encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    elif img_fmt.lower() == ".png":
        encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
    ret, buf = cv2.imencode(img_fmt, img, encode_params)
    if not ret:
        raise MXNetError("failed to encode image")
    return pack(header, buf.tobytes())


def unpack_img(s, iscolor=-1):
    """Unpack a record payload into (IRHeader, decoded image ndarray)."""
    cv2 = _cv2()
    header, s = unpack(s)
    img = cv2.imdecode(_np.frombuffer(s, dtype=_np.uint8), iscolor)
    return header, img
