"""Gluon ``Trainer`` for one context.

Port of ``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``scale / batch_size`` and updates each
parameter through the optimizer's ``Updater``, one tensor at a time, as
the reference does.  With one context there is nothing to reduce; a
kvstore over several contexts is not ported.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError, not_ported
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise MXNetError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
            self._params.append(param)
            param._trainer = self
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = None
        self._contexts = self._check_contexts()

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            if param._data is None and not param._deferred_init:
                continue
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise MXNetError(
                    "All Parameters must be initialized on the same set of "
                    "contexts, but Parameter %s is initialized on %s while "
                    "previous Parameters are initialized on %s."
                    % (param.name, ctx, contexts))
            contexts = ctx
        if contexts is not None and len(contexts) > 1:
            raise not_ported("Trainer over several contexts (kvstore)",
                             "mxnet_tpu.gluon.trainer.Trainer + "
                             "mxnet_tpu.kvstore")
        return contexts or []

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def allreduce_grads(self):
        """Nothing to reduce with one context."""
        self._contexts = self._check_contexts()

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter with gradients rescaled by
        ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None \
                    or param._grad is None:
                continue
            self._updater(i, param.list_grad()[0], param.list_data()[0])

    def save_states(self, fname):
        raise not_ported("Trainer.save_states",
                         "mxnet_tpu.gluon.trainer.Trainer.save_states")

    def load_states(self, fname):
        raise not_ported("Trainer.load_states",
                         "mxnet_tpu.gluon.trainer.Trainer.load_states")
