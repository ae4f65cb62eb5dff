"""SequentialModule: Modules chained head to tail.

Port of ``mxnet_tpu/module/sequential_module.py``: each module takes the
previous one's outputs as its data (``bind`` wires the shapes), the
module added with ``take_labels=True`` gets the labels, ``backward``
passes each module's input gradients to the one before, and
``update``/``init_optimizer`` reach every module.
"""
from __future__ import annotations

import logging
from typing import List

from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules: List[BaseModule] = []
        self._metas = []
        self._label_module = None
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    def add(self, module, **kwargs):
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        if kwargs.get(self.META_TAKE_LABELS, False):
            self._label_module = module
        return self

    def _takes_labels(self, i):
        return self._metas[i].get(self.META_TAKE_LABELS, False)

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def label_shapes(self):
        return (self._label_module.label_shapes
                if self._label_module is not None else [])

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, **kwargs):
        if not self._modules:
            raise MXNetError("SequentialModule.bind: no modules added")
        cur_shapes = data_shapes
        for i, mod in enumerate(self._modules):
            mod.bind(cur_shapes,
                     label_shapes if self._takes_labels(i) else None,
                     for_training=for_training,
                     inputs_need_grad=inputs_need_grad or i > 0)
            if i + 1 < len(self._modules):
                out_shapes = mod.output_shapes
                nxt = self._modules[i + 1]
                if len(nxt.data_names) != len(out_shapes):
                    raise MXNetError(
                        "SequentialModule: module %d emits %d outputs but "
                        "module %d takes %d inputs"
                        % (i, len(out_shapes), i + 1, len(nxt.data_names)))
                cur_shapes = [(n, s[1]) for n, s in
                              zip(nxt.data_names, out_shapes)]
        self.binded = True
        return self

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False,
                    force_init=False, **kwargs):
        """Each module initializes its own parameters; with
        ``arg_params`` and not ``allow_missing`` every parameter of the
        chain must be there."""
        if not allow_missing and arg_params:
            known = set()
            for mod in self._modules:
                known.update(mod._param_names)
            missing = [k for k in known if k not in arg_params]
            if missing:
                raise MXNetError(
                    "SequentialModule.init_params: arg_params missing %s "
                    "(pass allow_missing=True to initialize them)"
                    % missing)
        for mod in self._modules:
            mod.init_params(initializer=initializer, arg_params=arg_params,
                            aux_params=aux_params, allow_missing=True,
                            force_init=force_init)
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        for mod in self._modules:
            mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                               optimizer_params=optimizer_params or (),
                               force_init=force_init)
        self.optimizer_initialized = True

    def get_params(self):
        args, auxs = {}, {}
        for mod in self._modules:
            a, x = mod.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def forward(self, data_batch, is_train=None):
        from ..io.io import DataBatch
        batch = data_batch
        for i, mod in enumerate(self._modules):
            mod.forward(DataBatch(
                data=batch.data,
                label=data_batch.label if self._takes_labels(i) else None),
                is_train=is_train)
            if i + 1 < len(self._modules):
                batch = DataBatch(data=mod.get_outputs(),
                                  label=data_batch.label)

    def backward(self, out_grads=None):
        grads = out_grads
        for i in range(len(self._modules) - 1, -1, -1):
            mod = self._modules[i]
            mod.backward(out_grads=grads)
            if i > 0:
                grads = mod.get_input_grads()

    def update(self):
        for mod in self._modules:
            mod.update()

    def get_outputs(self):
        return self._modules[-1].get_outputs()

    def get_input_grads(self):
        return self._modules[0].get_input_grads()

    def update_metric(self, eval_metric, labels):
        for i, mod in enumerate(self._modules):
            if self._takes_labels(i):
                mod.update_metric(eval_metric, labels)
