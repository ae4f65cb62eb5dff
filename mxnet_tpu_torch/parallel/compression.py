"""2-bit gradient compression with error feedback.

Port of ``mxnet_tpu/parallel/compression.py`` (MXNet's
``gradient_compression.cc``): each gradient element is quantized to one
of {-threshold, 0, +threshold}, encoded in 2 bits (16x smaller than
f32), and the quantization error stays in a sender-side *residual* that
is added to the next round's gradient, so the long-run sum of the
decompressed gradients tracks the true sum.

The codec runs on the host, in numpy, with the reference's arithmetic:
it serves the wire paths, the parameter server (``parallel/dist.py``)
and the ``device`` store's cross-device reduce (``kvstore/kvstore.py``),
so the packed bytes and the residuals are bit for bit the reference's.

Codes: ``0b00`` is 0, ``0b01`` +threshold, ``0b10`` -threshold, packed
four to a byte, the first value in the lowest bits.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["TwoBitCompressor", "create_compressor"]


class TwoBitCompressor:
    """Stateful 2-bit quantizer; its state is the per-key residual.

    One instance lives on each sender; a receiver needs only the
    stateless :func:`decompress`.
    """

    def __init__(self, threshold: float = 0.5):
        if threshold <= 0:
            raise ValueError("threshold must be positive, got %r"
                             % (threshold,))
        self.threshold = float(threshold)
        self._residual: Dict[object, np.ndarray] = {}

    def compress(self, key, grad: np.ndarray) -> Tuple[bytes, tuple, str]:
        """``grad`` -> (packed 2-bit codes, shape, dtype name), after
        adding the key's residual; the new residual is kept."""
        grad = np.asarray(grad)
        flat = grad.astype(np.float32).ravel()
        res = self._residual.get(key)
        if res is None or res.shape != flat.shape:
            res = np.zeros_like(flat)
        adj = flat + res
        t = self.threshold
        codes = np.zeros(flat.shape, dtype=np.uint8)
        codes[adj >= t] = 1
        codes[adj <= -t] = 2
        deq = np.where(codes == 1, t, 0.0) + np.where(codes == 2, -t, 0.0)
        self._residual[key] = adj - deq.astype(np.float32)
        pad = (-len(codes)) % 4
        if pad:
            codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
        c = codes.reshape(-1, 4)
        packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
                  | (c[:, 3] << 6)).astype(np.uint8)
        return packed.tobytes(), grad.shape, str(grad.dtype)

    def decompress(self, payload: bytes, shape: tuple,
                   dtype: str = "float32") -> np.ndarray:
        return decompress(payload, shape, self.threshold, dtype)


def decompress(payload: bytes, shape: tuple, threshold: float,
               dtype: str = "float32") -> np.ndarray:
    """The values of a packed payload; all a receiver needs."""
    packed = np.frombuffer(payload, dtype=np.uint8)
    n = int(np.prod(shape)) if shape else 1
    codes = np.empty((len(packed), 4), dtype=np.uint8)
    codes[:, 0] = packed & 0x3
    codes[:, 1] = (packed >> 2) & 0x3
    codes[:, 2] = (packed >> 4) & 0x3
    codes[:, 3] = (packed >> 6) & 0x3
    codes = codes.ravel()[:n]
    t = threshold
    out = np.where(codes == 1, t, 0.0) + np.where(codes == 2, -t, 0.0)
    return out.astype(dtype).reshape(shape)


def create_compressor(params) -> TwoBitCompressor:
    """The compressor ``set_gradient_compression``'s params name; only
    ``type='2bit'`` exists, as in MXNet."""
    params = dict(params or {})
    ctype = params.pop("type", "2bit")
    if ctype != "2bit":
        raise ValueError("unsupported gradient compression type %r "
                         "(the reference supports '2bit' only)" % ctype)
    threshold = float(params.pop("threshold", 0.5))
    if params:
        raise ValueError("unknown gradient compression params %r"
                         % (sorted(params),))
    return TwoBitCompressor(threshold)
