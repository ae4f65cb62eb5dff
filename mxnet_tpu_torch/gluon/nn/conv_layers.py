"""Convolution and pooling layers: ``Conv2D``, ``MaxPool2D`` and
``GlobalAvgPool2D``.

Port of those classes of ``mxnet_tpu/gluon/nn/conv_layers.py`` (NCHW),
with the same parameter names and deferred shapes.
"""
from __future__ import annotations

from ..block import HybridBlock
from .activations import Activation

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._channels = channels
        self._in_channels = in_channels
        self._groups = groups
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        with self.name_scope():
            wshape = (channels, in_channels // groups if in_channels else 0) \
                + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        if self.weight.shape is None or 0 in self.weight.shape:
            self.weight.shape = (self._channels, x.shape[1] // self._groups) \
                + tuple(self._kwargs["kernel"])
        if self.bias is not None and (self.bias.shape is None
                                      or 0 in self.bias.shape):
            self.bias.shape = (self._channels,)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        return "%s(%s, kernel_size=%s)" % (type(self).__name__,
                                           self._channels,
                                           self._kwargs["kernel"])


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), _tup(strides, 2),
                         _tup(padding, 2), _tup(dilation, 2), groups, layout,
                         in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return "%s(size=%s, stride=%s, padding=%s)" % (
            type(self).__name__, self._kwargs["kernel"],
            self._kwargs["stride"], self._kwargs["pad"])


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2),
                         _tup(strides, 2) if strides is not None else None,
                         _tup(padding, 2), ceil_mode, False, "max", layout,
                         **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", layout,
                         **kwargs)
