"""BucketingModule: variable-length training with one executor per
bucket.

Port of ``mxnet_tpu/module/bucketing_module.py`` (upstream
``python/mxnet/module/bucketing_module.py``, the Sockeye/NMT path): one
``Module`` per bucket key from ``sym_gen``, binding the default bucket
first.  The reference copies the parameters into a bucket's module on
every switch and shares the optimizer and its states.  Here a new
bucket's executor is bound to the default bucket's parameter and aux
arrays themselves (its gradients stay its own), so every bucket reads
and updates one set of tensors, in place, and nothing is copied on a
switch; the optimizer and its states are shared as in the reference.
The numbers are the reference's: its copy on each switch brings the
latest values to the bucket that runs next.  ``get_params`` therefore
returns the latest values, where the reference's returns the default
bucket's as of its last run.

On the card each bucket's executor replays its own CUDA graphs, each in
a memory pool of its own, so buckets may arrive in any order.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key must be given")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_args = None

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write"):
        if self.binded and not force_rebind:
            return
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, **self._bind_args)
        self._buckets = {self._default_bucket_key: module}
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("switch_bucket before bind")
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, **self._bind_args)
            master = self._buckets[self._default_bucket_key]
            self._share(master, module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    @staticmethod
    def _share(master, module):
        """Bind ``module``'s executor to ``master``'s parameter and aux
        arrays, and give it ``master``'s optimizer and states."""
        exe, mexe = module._exec, master._exec
        for name in module._param_names:
            if name in mexe.arg_dict:
                exe.arg_dict[name] = mexe.arg_dict[name]
        for name in module._aux_names:
            if name in mexe.aux_dict:
                exe.aux_dict[name] = mexe.aux_dict[name]
        module.params_initialized = master.params_initialized
        if master.optimizer_initialized:
            module._optimizer = master._optimizer
            module._opt_states = master._opt_states
            module.optimizer_initialized = True

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True

    def set_params(self, *args, **kwargs):
        self._curr_module.set_params(*args, **kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def init_optimizer(self, **kwargs):
        master = self._buckets[self._default_bucket_key]
        master.init_optimizer(**kwargs)
        for module in self._buckets.values():
            if module is not master:
                self._share(master, module)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None)
        if key is None:
            key = self._default_bucket_key
        self.switch_bucket(key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
