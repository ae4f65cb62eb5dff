"""Gluon ``Trainer`` for one context.

Port of ``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``scale / batch_size`` and updates each
parameter through the optimizer's ``Updater``, one tensor at a time, as
the reference does; a ``row_sparse`` parameter's gradient reaches its
optimizer as a ``RowSparseNDArray`` of its nonzero rows.  ``save_states``/``load_states`` write and read the
reference's pickle (the states and the optimizer), so either package
resumes from the other's states.  With one context there is nothing to
reduce; a kvstore over several contexts is not ported.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError, not_ported
from ..ndarray import sparse
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

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """Nothing to reduce with one context."""
        self._contexts = self._check_contexts()

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter with gradients rescaled by
        ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of :meth:`step` without its gradient reduction, for
        gradients already reduced (``allreduce_grads``) and perhaps
        clipped by the caller."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None \
                    or param._grad is None:
                continue
            grad = param.list_grad()[0]
            if param.grad_stype == "row_sparse":
                # one conversion a step: the nonzero rows of the dense
                # gradient, read to the host, feed the row-lazy update
                grad = sparse.cast_storage(grad, "row_sparse")
            self._updater(i, grad, param.list_data()[0])

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer (the
        reference's ``dump_optimizer=True`` pickle)."""
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read states written by :meth:`save_states` of either package;
        each state lands on its parameter's context, and the loaded
        optimizer takes over this Trainer's parameters."""
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        with open(fname, "rb") as f:
            states = f.read()
        contexts = {i: p.list_ctx()[0] for i, p in enumerate(self._params)
                    if p._data is not None}
        self._updater.set_states(states, contexts)
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
