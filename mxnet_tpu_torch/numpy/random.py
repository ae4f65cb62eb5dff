"""``mx.np.random``: NumPy-style random sampling.

Port of ``mxnet_tpu/numpy/random.py``: delegates to the registered
samplers, which draw from torch's generators (``mx.random.seed`` seeds
them; the reference's ``jax.random`` streams cannot be reproduced, so
the same seed gives other numbers with the same distribution), and
rebrands the results as np ndarrays.  ``choice``, ``shuffle``,
``permutation`` and ``multinomial`` draw from numpy's global generator
on the host, as the reference's do.
"""
from __future__ import annotations

import numpy as _onp


def _nd_random():
    from .. import ndarray as _nd

    class _R:
        uniform = staticmethod(_nd.random_uniform)
        normal = staticmethod(_nd.random_normal)
        randint = staticmethod(_nd.random_randint)
        gamma = staticmethod(_nd.random_gamma)
        exponential = staticmethod(_nd.random_exponential)
        poisson = staticmethod(_nd.random_poisson)

        @staticmethod
        def seed(s):
            from .. import random as _r
            _r.seed(s)
    return _R


def _np():
    from . import _as_np, array
    return _as_np, array


def seed(s):
    _nd_random().seed(s)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None):
    _as_np, _ = _np()
    return _as_np(_nd_random().uniform(low, high, shape=_shape(size),
                                       dtype=dtype or "float32", ctx=ctx))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
    _as_np, _ = _np()
    return _as_np(_nd_random().normal(loc, scale, shape=_shape(size),
                                      dtype=dtype or "float32", ctx=ctx))


def randn(*size):
    return normal(0.0, 1.0, size=size or None)


def rand(*size):
    return uniform(0.0, 1.0, size=size or None)


def randint(low, high=None, size=None, dtype=None, ctx=None):
    _as_np, _ = _np()
    if high is None:
        low, high = 0, low
    return _as_np(_nd_random().randint(low, high, shape=_shape(size),
                                       dtype=dtype or "int32", ctx=ctx))


def choice(a, size=None, replace=True, p=None, ctx=None):
    _as_np, array = _np()
    if isinstance(a, int):
        n = a
    else:
        n = len(a)
    idx = _onp.random.choice(n, size=size, replace=replace,
                             p=None if p is None else _onp.asarray(p))
    if isinstance(a, int):
        return array(idx)
    return array(_onp.asarray(a)[idx])


def shuffle(x):
    """In-place permutation along the first axis (reference:
    ``mx.np.random.shuffle``)."""
    perm = _onp.random.permutation(x.shape[0])
    x[...] = x[perm]


def permutation(n):
    _as_np, array = _np()
    return array(_onp.random.permutation(n))


def gamma(shape_param, scale=1.0, size=None):
    _as_np, _ = _np()
    return _as_np(_nd_random().gamma(alpha=shape_param, beta=scale,
                                     shape=_shape(size)))


def exponential(scale=1.0, size=None):
    _as_np, _ = _np()
    return _as_np(_nd_random().exponential(lam=1.0 / scale,
                                           shape=_shape(size)))


def beta(a, b, size=None):
    """Beta(a, b) via two gammas, as the reference."""
    ga = gamma(a, 1.0, size=size)
    gb = gamma(b, 1.0, size=size)
    return ga / (ga + gb)


def poisson(lam=1.0, size=None):
    _as_np, _ = _np()
    return _as_np(_nd_random().poisson(lam, shape=_shape(size)))


def multinomial(n, pvals, size=None):
    _as_np, array = _np()
    return array(_onp.random.multinomial(n, _onp.asarray(pvals), size=size))


def bernoulli(prob, size=None):
    return (uniform(0.0, 1.0, size=size) < prob).astype("float32")


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)
