"""Activation layers (port of ``mxnet_tpu/gluon/nn/activations.py``):
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``
and ``Swish``, over the ``Activation`` and ``LeakyReLU`` ops."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return "Activation(%s)" % self._act_type


class LeakyReLU(HybridBlock):
    """``x`` where positive, else ``alpha * x``."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)

    def __repr__(self):
        return "LeakyReLU(%s)" % self._alpha


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope per channel (``alpha``, 0.25 at
    first)."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer as init
        if alpha_initializer is None:
            alpha_initializer = init.Constant(0.25)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha=None):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)
