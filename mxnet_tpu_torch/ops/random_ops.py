"""Random samplers.

Port of ``mxnet_tpu/ops/random_ops.py``, name for name: the
``_random_*`` ops draw a ``shape`` from scalar parameters, the
``_sample_*`` ops draw ``shape`` more values for each element of their
parameter arrays, ``_sample_multinomial`` draws class indices (and
their log-probabilities), ``_shuffle`` permutes the first axis.  Every
op is ``needs_rng``: it takes a ``torch.Generator`` first (None: torch's
default generator of the device, which ``mx.random.seed`` seeds); a
sampler without array inputs puts its output on
:func:`.registry.creation_device`.  The reference's ``jax.random``
streams are not reproduced: the distributions, shapes and dtypes are.
Gamma draws come from torch's ``_standard_gamma``, Poisson draws from
``torch.poisson``; the negative binomials are Poisson draws over gamma
rates, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .elemwise import _dtype
from .registry import creation_device, register

_F32 = torch.float32


def _dt(dtype):
    if dtype is None or dtype == "None":
        return _F32
    return _dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device, dtype=_F32)


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device, dtype=_F32)


def _gamma(gen, alpha):
    """Gamma(alpha, 1) draws, one per element of the tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _exponential(gen, shape, device):
    return torch.empty(shape, device=device, dtype=_F32).exponential_(
        1.0, generator=gen)


def _poisson(gen, lam):
    return torch.poisson(lam, generator=gen)


@register("_random_uniform", aliases=("uniform", "random_uniform"),
          needs_rng=True, no_grad=True)
def random_uniform(gen, low=0.0, high=1.0, shape=(1,), dtype=None, **kw):
    u = _uniform(gen, _shape(shape), creation_device())
    return (u * (high - low) + low).to(_dt(dtype))


@register("_random_normal", aliases=("normal", "random_normal"),
          needs_rng=True, no_grad=True)
def random_normal(gen, loc=0.0, scale=1.0, shape=(1,), dtype=None, **kw):
    return (_normal(gen, _shape(shape), creation_device()) * scale
            + loc).to(_dt(dtype))


@register("_random_gamma", aliases=("random_gamma",), needs_rng=True,
          no_grad=True)
def random_gamma(gen, alpha=1.0, beta=1.0, shape=(1,), dtype=None, **kw):
    a = torch.full(_shape(shape), float(alpha), device=creation_device())
    return (_gamma(gen, a) * beta).to(_dt(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          needs_rng=True, no_grad=True)
def random_exponential(gen, lam=1.0, shape=(1,), dtype=None, **kw):
    return (_exponential(gen, _shape(shape), creation_device())
            / lam).to(_dt(dtype))


@register("_random_poisson", aliases=("random_poisson",), needs_rng=True,
          no_grad=True)
def random_poisson(gen, lam=1.0, shape=(1,), dtype=None, **kw):
    lam_t = torch.full(_shape(shape), float(lam), device=creation_device())
    return _poisson(gen, lam_t).to(_dt(dtype))


@register("_random_negative_binomial",
          aliases=("random_negative_binomial",), needs_rng=True,
          no_grad=True)
def random_negative_binomial(gen, k=1, p=1.0, shape=(1,), dtype=None,
                             **kw):
    """NB(k, p) = Poisson(Gamma(k) * (1 - p) / p)."""
    a = torch.full(_shape(shape), float(k), device=creation_device())
    return _poisson(gen, _gamma(gen, a) * ((1 - p) / p)).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",),
          needs_rng=True, no_grad=True)
def random_generalized_negative_binomial(gen, mu=1.0, alpha=1.0,
                                         shape=(1,), dtype=None, **kw):
    """GNB(mu, alpha) = Poisson(Gamma(1/alpha) * alpha * mu); Poisson(mu)
    for alpha < 1e-8."""
    dev = creation_device()
    if alpha < 1e-8:
        lam = torch.full(_shape(shape), float(mu), device=dev)
    else:
        a = torch.full(_shape(shape), 1.0 / alpha, device=dev)
        lam = _gamma(gen, a) * alpha * mu
    return _poisson(gen, lam).to(_dt(dtype))


@register("_random_randint", aliases=("randint", "random_randint"),
          needs_rng=True, no_grad=True)
def random_randint(gen, low=0, high=1, shape=(1,), dtype="int32", **kw):
    return torch.randint(int(low), int(high), _shape(shape), generator=gen,
                         device=creation_device(),
                         dtype=_dtype(dtype or "int32"))


def multinomial_log_prob(data, idx):
    """The log-probabilities of classes ``idx`` under the rows of
    ``data``: the log-softmax of ``log(max(data, 1e-38))``, as the
    reference computes ``get_prob``."""
    logits = torch.log(torch.clamp(data, min=1e-38))
    lp = torch.log_softmax(logits, dim=-1).gather(
        -1, idx.long().reshape(tuple(data.shape[:-1]) + (-1,)))
    return lp.reshape(idx.shape)


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True, no_grad=True)
def sample_multinomial(gen, data, shape=1, get_prob=False, dtype="int32",
                       **kw):
    """``shape`` class indices drawn from each row of probabilities
    ``data`` (one value, not a vector, when ``shape`` is 1);
    ``get_prob`` adds their log-probabilities
    (:func:`multinomial_log_prob`)."""
    n = shape if isinstance(shape, int) else int(np.prod(shape))
    rows = data.reshape(-1, data.shape[-1])
    idx = torch.multinomial(rows / rows.sum(-1, keepdim=True), n,
                            replacement=True, generator=gen)
    if data.dim() == 1:
        out = idx[0] if n > 1 else idx.reshape(())
    else:
        out = idx if n > 1 else idx.reshape(data.shape[0])
    out = out.to(_dtype(dtype))
    if get_prob:
        return out, multinomial_log_prob(data, out)
    return out


@register("_shuffle", aliases=("shuffle",), needs_rng=True, no_grad=True)
def shuffle(gen, data, **kw):
    perm = torch.randperm(data.shape[0], generator=gen, device=data.device)
    return data[perm]


@register("_sample_unique_zipfian", needs_rng=True, no_grad=True)
def sample_unique_zipfian(gen, range_max=None, shape=(1,), **kw):
    """Log-uniform class draws in [0, range_max), int64."""
    u = _uniform(gen, _shape(shape), creation_device())
    out = (torch.exp(u * math.log(range_max + 1.0)) - 1.0).to(torch.int64)
    return out.clamp(0, range_max - 1)


def _param_sample(name, sampler):
    """A ``_sample_*`` op: ``shape`` draws for each element of the
    parameter arrays, output shape ``params[0].shape + shape``."""
    @register(name, needs_rng=True, no_grad=True)
    def impl(gen, *params, shape=None, dtype=None, **kw):
        if shape in (None, ()):
            extra = ()
        else:
            extra = _shape(shape)
        out_shape = tuple(params[0].shape) + extra
        ps = [p.float().reshape(tuple(p.shape)
                                + (1,) * (len(out_shape) - p.dim()))
              .expand(out_shape) for p in params]
        return sampler(gen, ps, out_shape, params[0].device).to(_dt(dtype))
    impl.__name__ = name
    return impl


def _gnb(gen, ps, s, dev):
    m, a = ps
    safe_a = torch.clamp(a, min=1e-8)
    lam = _gamma(gen, 1.0 / safe_a) * safe_a * m
    return _poisson(gen, torch.where(a < 1e-8, m, lam))


_param_sample("_sample_uniform", lambda gen, ps, s, dev: _uniform(
    gen, s, dev) * (ps[1] - ps[0]) + ps[0])
_param_sample("_sample_normal", lambda gen, ps, s, dev: _normal(
    gen, s, dev) * ps[1] + ps[0])
_param_sample("_sample_gamma", lambda gen, ps, s, dev: _gamma(
    gen, ps[0].contiguous()) * ps[1])
_param_sample("_sample_exponential", lambda gen, ps, s, dev: _exponential(
    gen, s, dev) / ps[0])
_param_sample("_sample_poisson", lambda gen, ps, s, dev: _poisson(
    gen, ps[0].contiguous()))
_param_sample("_sample_negative_binomial", lambda gen, ps, s, dev: _poisson(
    gen, _gamma(gen, ps[0].contiguous()) * (1 - ps[1]) / ps[1]))
_param_sample("_sample_generalized_negative_binomial", _gnb)
