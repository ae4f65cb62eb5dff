"""Vision transforms.

Port of ``mxnet_tpu/gluon/data/vision/transforms.py``.  Each transform
acts on its input where it lies (the host, in a DataLoader) and makes
its constants there.  The random ones draw from Python's ``random`` (and
``RandomLighting`` from numpy), as the reference does, so seeding them
gives both packages the same flips, crops and jitters.  ``Resize``,
``CenterCrop``, ``RandomResizedCrop``, ``RandomCrop`` and the colour
jitters go through ``mxnet_tpu_torch.image``.
"""
from __future__ import annotations

import random as pyrandom

import numpy as _np

from ...block import Block, HybridBlock
from ...nn import Sequential
from .... import ndarray as nd

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "RandomCrop", "RandomGray",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (NHWC -> NCHW for a
    batch)."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std`` per channel of a CHW input; the constants are
    made on the input's device at its first call there and kept, so a
    call on the card copies nothing from the host (and a captured call
    replays with them)."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std
        self._consts = {}

    def hybrid_forward(self, F, x):
        ctx = x.context
        if ctx not in self._consts:
            self._consts[ctx] = tuple(
                nd.array(_np.asarray(v).reshape(-1, 1, 1), ctx=ctx)
                for v in (self._mean, self._std))
        mean, std = self._consts[ctx]
        return (x - mean) / std


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        if isinstance(self._size, int):
            if self._keep:
                return image.resize_short(x, self._size,
                                          self._interpolation)
            return image.imresize(x, self._size, self._size,
                                  self._interpolation)
        return image.imresize(x, self._size[0], self._size[1],
                              self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        return image.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0,
                                                       4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        from .... import image
        return image.random_size_crop(x, self._size, self._scale,
                                      self._ratio,
                                      self._interpolation)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if pyrandom.random() < 0.5:
            return x.flip(axis=1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if pyrandom.random() < 0.5:
            return x.flip(axis=0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = max(0, 1 - brightness), 1 + brightness

    def forward(self, x):
        alpha = pyrandom.uniform(*self._args)
        return (x.astype("float32") * alpha).clip(0, 255).astype(
            str(x.dtype))


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        from ....image import ContrastJitterAug
        return ContrastJitterAug(self._contrast)(x.astype("float32"))


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._saturation = saturation

    def forward(self, x):
        from ....image import SaturationJitterAug
        return SaturationJitterAug(self._saturation)(x.astype("float32"))


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        from ....image import HueJitterAug
        return HueJitterAug(self._hue)(x.astype("float32"))


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = (brightness, contrast, saturation)
        self._hue = hue

    def forward(self, x):
        from ....image import ColorJitterAug, HueJitterAug
        x = ColorJitterAug(*self._args)(x.astype("float32"))
        if self._hue:
            x = HueJitterAug(self._hue)(x)
        return x


class RandomLighting(Block):
    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        from ....image import LightingAug
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        return LightingAug(self._alpha, eigval, eigvec)(
            x.astype("float32"))


class RandomCrop(Block):
    """Random spatial crop of an HWC input to ``size``, after an optional
    ``pad``."""

    def __init__(self, size, pad=None, pad_value=0):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._pad_value = pad_value

    def forward(self, x):
        from ....image import random_crop
        if self._pad:
            p = self._pad
            arr = _np.pad(x.asnumpy(), ((p, p), (p, p), (0, 0)),
                          constant_values=self._pad_value)
            x = nd.array(arr, ctx=x.context, dtype=arr.dtype)
        # random_crop resizes undersized inputs up to `size`, so the
        # output shape is always (th, tw, C)
        out, _ = random_crop(x, (self._size[1], self._size[0]))
        return out


class RandomGray(Block):
    """Three-channel grayscale of an HWC input with probability ``p``;
    the channel weights are made on the input's device."""

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if pyrandom.random() >= self._p:
            return x
        w = nd.array(_np.array([0.299, 0.587, 0.114], "float32"),
                     ctx=x.context)
        gray = (x.astype("float32") * w.reshape((1, 1, 3))).sum(
            axis=2, keepdims=True)
        return nd.concat(gray, gray, gray, dim=2).astype(x.dtype)
