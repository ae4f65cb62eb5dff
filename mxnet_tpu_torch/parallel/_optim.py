"""The optimizer rules of ``DataParallelTrainer``, in torch ops.

The reference builds an ``optax`` chain (``mxnet_tpu/parallel/
data_parallel.py:56-71``); these are the same transforms, computed as
optax 0.2.6 computes them, operation for operation in float32:

* ``sgd(lr, momentum)``: ``trace`` (``t = g + momentum * t``), then the
  learning rate (``u = -lr * t``); with ``wd``, ``add_decayed_weights``
  (``g + wd * p``) first;
* ``adam(lr)``: ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, an int32
  step count with bias correction), then the learning rate;
* ``adamw(lr, weight_decay=wd)``: ``scale_by_adam``, ``u + wd * p``, the
  learning rate;
* ``lamb(lr, weight_decay=wd)``: ``scale_by_adam`` with eps 1e-6,
  ``u + wd * p``, the trust ratio ``|p| / |u|`` (1 where either norm is
  0), the learning rate;
* ``grad_clip``: ``clip_by_global_norm`` chained first, in optax's select
  form (``u`` if ``|g| < max``, else ``u / |g| * max``).

Then ``p += u``.  Each rule is a chain of transforms; a transform keeps
its state in tensors that it updates in place, and maps the updates to
new tensors, so a gradient tensor is never written.  The elementwise
steps over the whole parameter list run as ``torch._foreach_*`` ops (a
few launches per step instead of several per tensor), each rounding as
the per-tensor operation does.  The step count and every
data-dependent scalar (norms, ratios, bias corrections) are device
tensors computed inside the update: a CUDA graph of the update advances
them on every replay, and nothing is read back to the host.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Rule", "make_rule"]

_INT32_MAX = 2 ** 31 - 1


class _Transform:
    """One transform of a chain: ``init(params)`` -> its state, a list
    of tensors; ``update(updates, state, params)`` -> the new updates,
    the state written in place."""

    def __init__(self, init, update):
        self.init = init
        self.update = update


def _stateless(fn):
    return _Transform(lambda params: [], fn)


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


def trace(decay):
    def update(updates, state, params):
        torch._foreach_mul_(state, decay)
        torch._foreach_add_(state, updates)     # g + decay * t
        return list(state)

    return _Transform(_zeros, update)


def scale(step_size):
    return _stateless(lambda updates, state, params:
                      torch._foreach_mul(updates, step_size))


def add_decayed_weights(wd):
    # two roundings, as optax's g + wd * p (a fused multiply-add is one)
    return _stateless(lambda updates, state, params: torch._foreach_add(
        updates, torch._foreach_mul(params, wd)))


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8):
    """State: the int32 count, then the first moments, then the
    second."""
    def init(params):
        dev = params[0].device if params else None
        return ([torch.zeros((), dtype=torch.int32, device=dev)]
                + _zeros(params) + _zeros(params))

    def update(updates, state, params):
        n = len(updates)
        count, mus, nus = state[0], state[1:1 + n], state[1 + n:]
        for m, v, g in zip(mus, nus, updates):
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
        count.add_((count < _INT32_MAX).to(torch.int32))
        one = torch.ones((), dtype=torch.float32, device=count.device)
        bc1 = 1 - torch.pow(one * b1, count)
        bc2 = 1 - torch.pow(one * b2, count)
        return [(m / bc1) / (torch.sqrt(v / bc2) + eps)
                for m, v in zip(mus, nus)]

    return _Transform(init, update)


def _norm(x):
    return torch.sqrt((x * x).sum())


def scale_by_trust_ratio():
    def update(updates, state, params):
        out = []
        for u, p in zip(updates, params):
            pn, un = _norm(p), _norm(u)
            ratio = torch.where((pn == 0.0) | (un == 0.0),
                                torch.ones_like(pn), pn / un)
            out.append(u * ratio)
        return out

    return _stateless(update)


def clip_by_global_norm(max_norm):
    def update(updates, state, params):
        g_norm = torch.sqrt(torch.stack([(u * u).sum()
                                         for u in updates]).sum())
        keep = g_norm < max_norm
        return [torch.where(keep, u, (u / g_norm) * max_norm)
                for u in updates]

    return _stateless(update)


class Rule:
    """A chain of transforms over one list of parameters: ``init``
    makes the state (a list per transform), ``apply(grads, state,
    params)`` runs the chain and adds the updates to the parameters in
    place."""

    def __init__(self, transforms):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def apply(self, grads, state, params):
        updates = list(grads)
        for t, s in zip(self.transforms, state):
            updates = t.update(updates, s, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)


def make_rule(optimizer, optimizer_params=None, grad_clip=None) -> Rule:
    """The reference trainer's chain for ``optimizer`` (``sgd``,
    ``adam``, ``adamw`` or ``lamb``) with ``learning_rate`` (default
    0.01), ``momentum`` (sgd; default 0.0) and ``wd`` (default 0.0)."""
    optimizer_params = dict(optimizer_params or {})
    lr = optimizer_params.pop("learning_rate", 0.01)
    momentum = optimizer_params.pop("momentum", 0.0)
    wd = optimizer_params.pop("wd", 0.0)
    if optimizer == "sgd":
        chain = [trace(momentum), scale(-lr)]
        if wd:
            chain.insert(0, add_decayed_weights(wd))
    elif optimizer == "adam":
        chain = [scale_by_adam(), scale(-lr)]
    elif optimizer == "adamw":
        chain = [scale_by_adam(), add_decayed_weights(wd), scale(-lr)]
    elif optimizer == "lamb":
        chain = [scale_by_adam(eps=1e-6), add_decayed_weights(wd),
                 scale_by_trust_ratio(), scale(-lr)]
    else:
        raise MXNetError("DataParallelTrainer: unknown optimizer %r"
                         % optimizer)
    if grad_clip:
        chain.insert(0, clip_by_global_norm(grad_clip))
    return Rule(chain)
