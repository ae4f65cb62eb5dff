"""Gluon basic layers: ``Sequential``, ``HybridSequential``, ``Dense``,
``Dropout``, ``Embedding``, the four norms, ``Flatten``, ``Lambda``,
``HybridLambda``, ``Identity`` and ``(Hybrid)Concatenate``.

Port of ``mxnet_tpu/gluon/nn/basic_layers.py``, class for class, with
the same parameter names, defaults and deferred shapes, over the ops of
``ops/nn.py``.
"""
from __future__ import annotations

import numpy as np

from ...base import MXNetError
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm", "Flatten",
           "Lambda", "HybridLambda", "Identity", "Concatenate",
           "HybridConcatenate"]


class Sequential(Block):
    """Stack of Blocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks run in order."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer over the ``FullyConnected`` op;
    ``in_units=0`` defers the weight's shape to the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        self._units = units
        self._in_units = in_units
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        if self.weight.shape is None or 0 in self.weight.shape:
            in_units = int(np.prod(x.shape[1:])) if self._flatten \
                else x.shape[-1]
            self.weight.shape = (self._units, in_units)
        if self.bias is not None and (self.bias.shape is None
                                      or 0 in self.bias.shape):
            self.bias.shape = (self._units,)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        return self.act(out) if self.act is not None else out

    def __repr__(self):
        shape = self.weight.shape
        return "Dense(%s -> %s, %s)" % (
            shape[1] if shape and len(shape) > 1 else None,
            shape[0] if shape else None, self.act if self.act else "linear")


class Dropout(HybridBlock):
    """Inverted dropout at ``rate`` in training (``axes``: the axes that
    share one mask value); the identity otherwise."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.Dropout(x, p=self._rate, axes=self._axes)
        return F.identity(x)

    def __repr__(self):
        return "Dropout(p = %s, axes=%s)" % (self._rate, self._axes)


class Embedding(HybridBlock):
    """Rows of an ``(input_dim, output_dim)`` weight by index.  With
    ``sparse_grad=True`` the weight's gradient is declared
    ``row_sparse``: the forward and backward stay dense, and the Trainer
    updates only the rows whose gradient is nonzero."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def hybrid_forward(self, F, x, weight=None):
        return F.Embedding(x, weight, **self._kwargs)

    def __repr__(self):
        return "Embedding(%s -> %s)" % (self._input_dim, self._output_dim)


class BatchNorm(HybridBlock):
    """Batch norm over the ``BatchNorm`` op, with running statistics as
    ``grad_req='null'`` parameters that the op's mutate contract moves;
    ``epsilon`` defaults to 1e-5 and ``fix_gamma`` is ``not scale``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            if p.shape is None or 0 in p.shape:
                p.shape = (ch,)

    def hybrid_forward(self, F, x, gamma=None, beta=None,
                       running_mean=None, running_var=None):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)

    def __repr__(self):
        return "BatchNorm(axis=%s)" % self._axis


class _Norm(HybridBlock):
    """A norm with ``gamma``/``beta`` of ``in_channels`` (deferred to
    the input's ``_channel_axis``), each trained only when ``scale`` /
    ``center``."""

    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def _infer_param_shapes(self, x, *args):
        ch = x.shape[self._channel_axis]
        for p in (self.gamma, self.beta):
            if p.shape is None or 0 in p.shape:
                p.shape = (ch,)


class InstanceNorm(_Norm):
    """Normalise each sample's channel over its spatial axes."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        self._epsilon = epsilon
        self._axis = self._channel_axis = axis
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta,
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(_Norm):
    """Normalise over ``axis``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        self._axis = self._channel_axis = axis
        self._epsilon = epsilon
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class GroupNorm(_Norm):
    """Normalise each of ``num_groups`` groups of channels (axis 1)."""

    _channel_axis = 1

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        self._num_groups = num_groups
        self._epsilon = epsilon
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, prefix, params)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self._epsilon)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


def _nd_function(function):
    from ... import ndarray as nd
    if not hasattr(nd, function):
        raise MXNetError("Function name %s is not found in nd." % function)
    return getattr(nd, function)


class Lambda(Block):
    """A function (or the name of an ``nd`` function) as a block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = _nd_function(function) \
            if isinstance(function, str) else function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` (or the ``F`` function of that name) as
    a hybridizable block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _nd_function(function)
            self._func = lambda F, *a: getattr(F, function)(*a)
            self._func_name = function
        else:
            self._func = lambda F, *a: function(F, *a)
            self._func_name = function.__name__

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


class Identity(HybridBlock):
    """Its input, unchanged."""

    def hybrid_forward(self, F, x):
        return x


class HybridConcatenate(HybridBlock):
    """Every child on the same input, outputs concatenated on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._children.values()],
                        dim=self.axis)


class Concatenate(HybridConcatenate):
    """The reference's other name for :class:`HybridConcatenate`."""
