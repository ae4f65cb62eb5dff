"""Weight initializers.

Port of ``Initializer``, ``Zero``, ``One``, ``Constant``, ``Uniform``,
``Normal``, ``Xavier`` and ``MSRAPrelu`` from
``mxnet_tpu/initializer.py``.  As in the
reference, values are drawn from numpy's global generator
(``np.random``) in the same order and with the same calls, so a run
seeded with ``np.random.seed`` draws the same numbers in both packages;
names ending in ``bias``/``beta``/``running_mean`` get zeros and
``gamma``/``running_var`` ones whatever the initializer.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError, Registry

__all__ = ["Initializer", "InitDesc", "Uniform", "Normal", "Zero", "One",
           "Constant", "Xavier", "MSRAPrelu", "register", "create"]

_REG = Registry("initializer")
register = _REG.register


class InitDesc(str):
    """A parameter's name (and attrs) as the initializer sees it."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer; ``init(desc, arr)`` fills the NDArray ``arr`` in
    place by the rule its name selects."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        init = desc.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(desc, arr)
        elif name.endswith("gamma"):
            self._init_one(desc, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(desc, arr)
        elif name.endswith("min") or name.endswith("max"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _set(arr, value):
        with torch.no_grad():
            arr._data.copy_(torch.from_numpy(
                np.asarray(value).astype(arr.dtype)))

    def _init_zero(self, desc, arr):
        self._set(arr, np.zeros(arr.shape))

    def _init_one(self, desc, arr):
        self._set(arr, np.ones(arr.shape))

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)


@register("uniform")
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr):
        self._set(arr, np.random.uniform(-self.scale, self.scale, arr.shape))


@register("normal")
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr):
        self._set(arr, np.random.normal(0, self.sigma, arr.shape))


@register("zeros", aliases=["zero"])
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


@register("ones", aliases=["one"])
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr):
        self._set(arr, np.full(arr.shape, self.value))


@register("xavier")
class Xavier(Initializer):
    """Xavier/Glorot initialization with the reference's defaults."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2: %s %s"
                             % (desc, shape))
        hw_scale = np.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, np.random.uniform(-scale, scale, shape))
        elif self.rnd_type == "gaussian":
            self._set(arr, np.random.normal(0, scale, shape))
        else:
            raise MXNetError("Unknown random type")


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialization for PReLU: Xavier gaussian with magnitude
    ``2 / (1 + slope**2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)
