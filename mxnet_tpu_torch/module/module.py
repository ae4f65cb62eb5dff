"""Module: symbolic training on a bound executor.

Port of ``mxnet_tpu/module/module.py`` (upstream
``python/mxnet/module/module.py``): ``bind`` (``simple_bind`` of the
symbol with the data and label shapes), ``init_params`` (the initializer
by parameter name, or ``arg_params``/``aux_params``), ``set_params``,
``get_params``, ``init_optimizer``, ``forward``, ``backward``,
``update`` (one optimizer update per tensor, eagerly, as
``gluon.Trainer`` does), ``get_outputs``, ``get_input_grads``,
``update_metric``, ``save_checkpoint``/``load`` and the optimizer-state
save and load.

The context defaults to the current one: the card, raising when there is
none (the reference defaults to ``cpu()``).  Every write into the
executor's arrays (``init_params``, ``set_params``, the feeds of
``forward``, ``update``) goes into them in place, so the executor's
captured programs keep reading them.  A Module over more than one
context raises ``NotImplementedError``: the reference shards the batch
over a device mesh there, which ``ROADMAP.md`` A.7 ports.
"""
from __future__ import annotations

import logging
from typing import Dict

from .. import ndarray as nd
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..symbol.executor import _assign
from .base_module import BaseModule

__all__ = ["Module"]


def _shape_list(shapes):
    """Normalize [(name, shape)] / DataDesc list / dict → list of tuples."""
    if shapes is None:
        return []
    out = []
    for s in shapes:
        if isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], str):
            out.append((s[0], tuple(s[1])))
        elif hasattr(s, "name") and hasattr(s, "shape"):
            out.append((s.name, tuple(s.shape)))
        else:
            raise MXNetError("bad data_shapes entry: %r" % (s,))
    return out


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if context is None:
            context = current_context()
        self._context = list(context) if isinstance(
            context, (list, tuple)) else [context]
        if len(self._context) > 1:
            raise NotImplementedError(
                "Module over %d contexts: the data-parallel executor group "
                "is not ported yet (ROADMAP.md A.7); bind one context"
                % len(self._context))
        self._fixed_param_names = list(fixed_param_names or [])

        arg_names = symbol.list_arguments()
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()

        self._exec = None
        self._optimizer = None
        self._opt_states: Dict[str, object] = {}
        self._data_shapes = None
        self._label_shapes = None

    # ------------------------------------------------------------------

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        shapes = dict(self._data_shapes + (self._label_shapes or []))
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    # ------------------------------------------------------------------

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._data_shapes = _shape_list(data_shapes)
        self._label_shapes = _shape_list(label_shapes)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        shapes = dict(self._data_shapes + self._label_shapes)
        reqs = {}
        for n in self._symbol.list_arguments():
            if n in self._param_names and n not in self._fixed_param_names:
                reqs[n] = grad_req if for_training else "null"
            elif inputs_need_grad and n in self._data_names:
                reqs[n] = grad_req
            else:
                reqs[n] = "null"
        old_params = None
        if self._exec is not None:
            old_params = self.get_params()
        self._exec = self._symbol.simple_bind(
            ctx=self._context[0], grad_req=reqs, **shapes)
        if old_params is not None:
            self.set_params(*old_params, allow_missing=True,
                            force_init=True, allow_extra=True)
            self.params_initialized = True
        self.binded = True

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        if arg_params is None and getattr(self, "_preloaded", None):
            arg_params, aux_params = self._preloaded
            allow_missing = True
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params is not None and name in arg_params:
                _assign(arr, arg_params[name])
            else:
                if arg_params is not None and not allow_missing:
                    raise MXNetError("init_params: %s missing" % name)
                initializer(name, arr)
        for name in self._aux_names:
            arr = self._exec.aux_dict[name]
            if aux_params is not None and name in aux_params:
                _assign(arr, aux_params[name])
            else:
                initializer(name, arr)
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=True,
                         force_init=force_init, allow_extra=allow_extra)

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copy() for n in self._param_names}
        aux = {n: self._exec.aux_dict[n].copy() for n in self._aux_names}
        return arg, aux

    # ------------------------------------------------------------------

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        from .. import optimizer as opt
        if isinstance(optimizer, str):
            optimizer = opt.create(optimizer, **dict(optimizer_params))
        self._optimizer = optimizer
        self._opt_states = {}
        for i, name in enumerate(self._param_names):
            if self._exec.grad_req.get(name, "null") != "null":
                self._opt_states[name] = optimizer.create_state(
                    i, self._exec.arg_dict[name])
        self.optimizer_initialized = True

    # ------------------------------------------------------------------

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data):
            feeds[name] = arr
        if self._label_names and data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        for i, name in enumerate(self._param_names):
            if name not in self._opt_states:
                continue
            w = self._exec.arg_dict[name]
            g = self._exec.grad_dict[name]
            self._optimizer.update(i, w, g, self._opt_states[name])

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict[n] for n in self._data_names
                if n in self._exec.grad_dict]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # ------------------------------------------------------------------

    def install_monitor(self, monitor):
        monitor.install(self._exec)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        return mod

    def save_optimizer_states(self, fname):
        import pickle
        flat = {}
        for name, st in self._opt_states.items():
            flat[name] = _states_to_numpy(st)
        with open(fname, "wb") as f:
            pickle.dump(flat, f)

    def load_optimizer_states(self, fname):
        """Load states saved by :meth:`save_optimizer_states` (by either
        package), each onto its parameter's context; an existing state
        array is written in place."""
        import pickle
        with open(fname, "rb") as f:
            flat = pickle.load(f)
        for name, st in flat.items():
            if name in self._opt_states:
                self._opt_states[name] = _states_from_numpy(
                    st, self._opt_states[name],
                    self._exec.arg_dict[name].context)


def _states_to_numpy(st):
    if st is None:
        return None
    if isinstance(st, (tuple, list)):
        return type(st)(_states_to_numpy(s) for s in st)
    if isinstance(st, NDArray):
        return st.asnumpy()
    return st


def _states_from_numpy(st, old, ctx):
    import numpy as np
    if st is None:
        return None
    if isinstance(st, (tuple, list)):
        olds = old if isinstance(old, (tuple, list)) else [None] * len(st)
        return type(st)(_states_from_numpy(s, o, ctx)
                        for s, o in zip(st, olds))
    if isinstance(st, np.ndarray):
        if isinstance(old, NDArray) and old.shape == st.shape:
            _assign(old, st)
            return old
        return nd.array(st, ctx=ctx, dtype=st.dtype)
    return st
