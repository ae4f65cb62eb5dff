"""Weight initializers.

Port of ``mxnet_tpu/initializer.py``: ``Initializer``, ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Xavier``,
``MSRAPrelu``, ``Orthogonal``, ``Bilinear``, ``LSTMBias`` and
``Mixed``.  As in the reference, values are drawn from numpy's global
generator
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
           "Constant", "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear",
           "LSTMBias", "Mixed", "register", "create"]

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
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
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

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_gamma(self, desc, arr):
        self._init_one(desc, arr)

    def _init_beta(self, desc, arr):
        self._init_zero(desc, arr)

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


@register("orthogonal")
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor (from the SVD) of a uniform
    or normal draw, shaped (out, prod(in dims))."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        self._set(arr, (self.scale * q).reshape(arr.shape))


@register("bilinear")
class Bilinear(Initializer):
    """The bilinear upsampling kernel (for ``Deconvolution``)."""

    def _init_weight(self, desc, arr):
        weight = np.zeros(arr.shape).reshape(-1)
        shape = arr.shape
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        self._set(arr, weight.reshape(shape))


@register("lstmbias")
class LSTMBias(Initializer):
    """Forget-gate bias ``forget_bias``, the other gates 0 (gate order
    i, f, c, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        b = np.zeros(arr.shape)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    def _init_bias(self, desc, arr):
        self._init_weight(desc, arr)


class Mixed:
    """The first initializer whose pattern (a regular expression) matches
    the parameter's name."""

    def __init__(self, patterns, initializers):
        import re
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers mismatch")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("Parameter %s did not match any pattern" % name)


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)
