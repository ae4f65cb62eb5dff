"""SqueezeNet 1.0 and 1.1, and ``HybridConcurrent``.

Port of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``.
``HybridConcurrent`` (branches on one input, concatenated on ``axis``)
is named here, as in the reference, and Inception and DenseNet import it
from here: the contrib layer with ``axis=1`` by default.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError
from ._weights import refuse_pretrained
from ...contrib.nn.basic_layers import \
    HybridConcurrent as _ContribHybridConcurrent

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))

    paths = HybridConcurrent()
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


class HybridConcurrent(_ContribHybridConcurrent):
    """``gluon.contrib.nn.HybridConcurrent`` with the zoo's default axis,
    the channel axis (the reference's zoo defines its own with
    ``axis=1``)."""

    def __init__(self, axis=1, prefix=None, params=None):
        super().__init__(axis=axis, prefix=prefix, params=params)


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ("1.0", "1.1"):
            raise MXNetError("Unsupported SqueezeNet version %s" % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.AvgPool2D(13))
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    refuse_pretrained(pretrained, "squeezenet1.0")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    refuse_pretrained(pretrained, "squeezenet1.1")
    return SqueezeNet("1.1", **kwargs)
