"""Gluon ``Trainer``.

Port of ``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)`` sets the
optimizer's ``rescale_grad`` to ``scale / batch_size``, sums the
gradients across the parameters' contexts through a kvstore
(``allreduce_grads``: a push and a pull a parameter) and updates each
parameter through the optimizer's ``Updater``, one tensor at a time, as
the reference does; a ``row_sparse`` parameter's gradient reaches its
optimizer as a ``RowSparseNDArray`` of its nonzero rows.

With one context, or ``kvstore=None``, no store is made and nothing is
reduced (the reference's rule).  Over several contexts the store is
made at the first step (``kvstore`` a type name or a store) and each
parameter's first copy initialises its key; the first context's copy is
updated and copied to the others.  With ``update_on_kvstore=True`` the
store runs the optimizer instead (MXNet's semantics): ``step`` pushes
the gradients and pulls the updated weights into every copy, and
``save_states``/``load_states`` go through the store's updater.  The
reference instead pulls the updated weights into the gradient buffers
and updates again locally (``mxnet_tpu/gluon/trainer.py:121-124``,
``:142-166``); ``ROADMAP.md`` §C states the difference.
``compression_params`` is given to the store, as MXNet does.

``save_states``/``load_states`` write and read the reference's pickle
(the states and the optimizer), so either package resumes from the
other's states.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
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
        self._compression_params = compression_params
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
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
        return contexts or []

    def _init_kvstore(self):
        """Make the store over several contexts (none for one context
        or ``kvstore=None``), ship it the optimizer under
        ``update_on_kvstore`` and initialise one key a parameter."""
        from .. import kvstore as kvs
        self._contexts = self._check_contexts()
        if self._update_on_kvstore is None:
            self._update_on_kvstore = False
        if self._kvstore_arg is None or len(self._contexts) <= 1:
            self._kvstore = None
        else:
            kv = self._kvstore_arg
            if isinstance(kv, str):
                kv = kvs.create(kv)
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                kv.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                if param._data is not None:
                    kv.init(i, param.data())
        self._kv_initialized = True

    def _on_kvstore(self):
        return self._kvstore is not None and self._update_on_kvstore

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _grads(self):
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and param._data is not None \
                    and param._grad is not None:
                yield i, param

    def allreduce_grads(self):
        """Sum each parameter's gradients across its contexts into every
        copy (a push and a pull a parameter); nothing with one
        context."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            raise MXNetError("allreduce_grads() when parameters are "
                             "updated on kvstore is not supported")
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        for i, param in self._grads():
            grads = param.list_grad()
            self._kvstore.push(i, grads)
            if not self._update_on_kvstore:
                self._kvstore.pull(i, out=grads)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update every parameter with them
        rescaled by ``1 / batch_size``."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of :meth:`step` without its gradient reduction, for
        gradients already reduced (``allreduce_grads``) and perhaps
        clipped by the caller."""
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported")
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._on_kvstore():
            # the store updated its weights at the push: pull them
            for i, param in self._grads():
                self._kvstore.pull(i, out=param.list_data())
            return
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        for i, param in self._grads():
            grad = param.list_grad()[0]
            if param.grad_stype == "row_sparse":
                # one conversion a step: the nonzero rows of the dense
                # gradient, read to the host, feed the row-lazy update
                grad = sparse.cast_storage(grad, "row_sparse")
            datas = param.list_data()
            self._updater(i, grad, datas[0])
            for d in datas[1:]:
                datas[0].copyto(d)

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer (the
        reference's ``dump_optimizer=True`` pickle)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read states written by :meth:`save_states` of either package;
        each state lands on its parameter's context, and the loaded
        optimizer takes over this Trainer's parameters."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            if self._updater is None:
                self._updater = opt.get_updater(self._optimizer)
            with open(fname, "rb") as f:
                states = f.read()
            contexts = {i: p.list_ctx()[0]
                        for i, p in enumerate(self._params)
                        if p._data is not None}
            self._updater.set_states(states, contexts)
            self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
