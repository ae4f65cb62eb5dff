"""Optimizers: the registry, ``Optimizer``, ``SGD`` and ``Updater``.

Port of the parts of ``mxnet_tpu/optimizer/optimizer.py`` that Gluon's
``Trainer`` uses.  ``SGD.update`` dispatches to the per-tensor
``sgd_update`` / ``sgd_mom_update`` ops with ``out=weight``, exactly as
the reference does: one tensor at a time, never through the grouped
``multi_sgd_*`` ops.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray as nd
from ..base import Registry, not_ported

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]

_REG = Registry("optimizer")
register = _REG.register


class Optimizer:
    """Base optimizer: learning rate (or an ``lr_scheduler`` callable of
    the update count), weight decay, gradient rescale and clip, and
    per-parameter ``lr_mult``/``wd_mult`` read from the Gluon parameters
    in ``param_dict``."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, begin_num_update=0,
                 multi_precision=False, param_dict=None, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict if param_dict else {}

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            raise not_ported("multi_precision (float16 master weights)",
                             "mxnet_tpu.optimizer.Optimizer."
                             "create_state_multi_precision")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        if index in self.param_dict:
            lr *= getattr(self.param_dict[index], "lr_mult", 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= getattr(self.param_dict[index], "wd_mult", 1.0)
        return wd

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def __repr__(self):
        return "%s(lr=%s)" % (type(self).__name__, self.lr)


def _common_kwargs(opt):
    kw = {"rescale_grad": opt.rescale_grad}
    if opt.clip_gradient is not None:
        kw["clip_gradient"] = opt.clip_gradient
    return kw


@register("sgd")
class SGD(Optimizer):
    """SGD with MXNet's momentum (``m = momentum*m - lr*g; w += m``),
    one ``sgd_update`` / ``sgd_mom_update`` op per tensor."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, ctx=weight.context, dtype=weight.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, lr=lr, wd=wd, **kw)


class Updater:
    """Holds each index's optimizer state and applies the update
    (reference ``Updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _REG.create(name, **kwargs)
