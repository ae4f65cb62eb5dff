"""Optimizers: the registry, ``Optimizer``, every optimizer of the
reference's registry, ``Updater`` and its states.

Port of ``mxnet_tpu/optimizer/optimizer.py``, with the same dispatch:
SGD, NAG, Adam, FTRL, RMSProp, Signum and LAMB update each tensor
through their fused ops (``nd.adam_update(..., out=weight)`` and so
on), with the host-side parts in Python floats as in the reference
(Adam's bias correction folded into ``lr``, LAMB's phase 1, norms and
phase 2, LARS's norms read on the host); AdaGrad, AdaDelta, Adamax,
Nadam and Test update by NDArray arithmetic.  ``multi_precision`` keeps
a float32 master copy of each float16 weight (SGD through the ``mp_*``
ops, the others by updating the master and casting it back).  Per-tensor
``lr_mult``/``wd_mult`` come from the Gluon parameters in
``param_dict``, else from ``set_lr_mult``/``set_wd_mult`` by index or by
name through ``param_idx2name``.

``Updater.get_states`` pickles the states as numpy arrays, with the
optimizer when ``dump_optimizer`` (its ``param_dict`` left out);
``set_states`` reads them, and the reference's pickles too: the
reference's optimizer and scheduler classes map to the port's and the
rest of its objects (the Parameters it pickles with the optimizer) are
dropped, so no JAX is needed to read them.
"""
from __future__ import annotations

import io
import math
import pickle

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError, Registry
from ..ndarray import sparse

__all__ = ["Optimizer", "SGD", "Adam", "AdaGrad", "RMSProp", "FTRL", "NAG",
           "Signum", "LAMB", "AdaDelta", "Adamax", "Nadam", "LARS", "Test",
           "Updater", "get_updater", "create", "register", "state_zeros"]

_REG = Registry("optimizer")
register = _REG.register


def state_zeros(weight, dtype=None):
    """Zeros shaped like ``weight`` on its context (its dtype unless
    ``dtype`` is given)."""
    return nd.zeros(weight.shape, ctx=weight.context,
                    dtype=dtype or weight.dtype)


def _zeros32(weight):
    return nd.zeros(weight.shape, ctx=weight.context)


class Optimizer:
    """Base optimizer (reference ``mxnet.optimizer.Optimizer``)."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01,
                 lr_scheduler=None, sym=None, begin_num_update=0,
                 multi_precision=False, param_dict=None,
                 aggregate_num=0, **kwargs):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}

    def __getstate__(self):
        """Pickled without ``param_dict`` (the Trainer's Parameters): a
        loading Trainer sets its own."""
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _mp(self, weight):
        return self.multi_precision and weight.dtype == np.float16

    def create_state_multi_precision(self, index, weight):
        """The state of a float16 weight under ``multi_precision``: (the
        state of its float32 master copy, the master copy)."""
        if self._mp(weight):
            master = weight.astype("float32")
            return self.create_state(index, master), master
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp(weight):
            original_state, weight32 = state
            self.update(index, weight32, grad.astype("float32"),
                        original_state)
            weight._set_data(weight32.astype(weight.dtype)._data)
        else:
            self.update(index, weight, grad, state)

    # -- per-weight multipliers -------------------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined.")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def __repr__(self):
        return "%s(lr=%s)" % (type(self).__name__, self.lr)

    @staticmethod
    def create_optimizer(name, **kwargs):
        return _REG.create(name, **kwargs)


def _common_kwargs(opt):
    kw = {"rescale_grad": opt.rescale_grad}
    if opt.clip_gradient is not None:
        kw["clip_gradient"] = opt.clip_gradient
    return kw


def _prep(opt, grad, weight, wd):
    """``rescale * grad``, clipped, ``+ wd * weight``, by NDArray
    arithmetic (the optimizers without a fused op)."""
    grad = grad * opt.rescale_grad
    if opt.clip_gradient is not None:
        grad = nd.clip(grad, -opt.clip_gradient, opt.clip_gradient)
    return grad + wd * weight


@register("sgd")
class SGD(Optimizer):
    """SGD with MXNet's momentum (``m = momentum*m - lr*g; w += m``),
    one ``sgd_update`` / ``sgd_mom_update`` op per tensor (``mp_*``
    under ``multi_precision``).  A ``row_sparse`` gradient takes the
    row-lazy update under ``lazy_update`` and is made dense otherwise."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        if grad.stype == "row_sparse" and self.lazy_update:
            if state is not None:
                sparse.sgd_mom_update(weight, grad, state, out=weight, lr=lr,
                                      wd=wd, momentum=self.momentum, **kw)
            else:
                sparse.sgd_update(weight, grad, out=weight, lr=lr, wd=wd,
                                  **kw)
            return
        if grad.stype != "default":
            grad = grad.todense()
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, lr=lr, wd=wd, **kw)

    def update_multi_precision(self, index, weight, grad, state):
        if not self._mp(weight):
            self.update(index, weight, grad, state)
            return
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        mom, w32 = state
        if mom is not None:
            nd.mp_sgd_mom_update(weight, grad, mom, w32, out=weight, lr=lr,
                                 wd=wd, momentum=self.momentum, **kw)
        else:
            nd.mp_sgd_update(weight, grad, w32, out=weight, lr=lr, wd=wd,
                             **kw)


@register("nag")
class NAG(Optimizer):
    """Nesterov momentum (``nag_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        if state is not None:
            nd.nag_mom_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, lr=lr, wd=wd, **kw)


@register("adam")
class Adam(Optimizer):
    """Adam: ``adam_update`` per tensor, the bias correction
    ``sqrt(1 - beta2**t) / (1 - beta1**t)`` folded into ``lr`` on the
    host, ``t`` the tensor's own update count (for a row-lazy update
    too: one count per parameter, not per row)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return state_zeros(weight), state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        if grad.stype == "row_sparse" and self.lazy_update:
            sparse.adam_update(weight, grad, mean, var, out=weight, lr=lr,
                               wd=wd, beta1=self.beta1, beta2=self.beta2,
                               epsilon=self.epsilon, **_common_kwargs(self))
            return
        if grad.stype != "default":
            grad = grad.todense()
        nd.adam_update(weight, grad, mean, var, out=weight, lr=lr, wd=wd,
                       beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, **_common_kwargs(self))


@register("adagrad")
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        grad = _prep(self, grad, weight, self._get_wd(index))
        state._set_data((state + grad * grad)._data)
        weight._set_data((weight - lr * grad / (nd.sqrt(state)
                                                 + self.float_stable_eps))
                         ._data)


@register("rmsprop")
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_update``), or with ``centered`` Graves's form
    (``rmspropalex_update``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros32(weight), _zeros32(weight), _zeros32(weight)
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if not self.centered:
            nd.rmsprop_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                              gamma1=self.gamma1, epsilon=self.epsilon, **kw)
        else:
            n, g, delta = state
            nd.rmspropalex_update(weight, grad, n, g, delta, out=weight,
                                  lr=lr, wd=wd, gamma1=self.gamma1,
                                  gamma2=self.gamma2, epsilon=self.epsilon,
                                  **kw)


@register("ftrl")
class FTRL(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        z, n = state
        nd.ftrl_update(weight, grad, z, n, out=weight, lr=lr, wd=wd,
                       lamda1=self.lamda1, beta=self.beta,
                       **_common_kwargs(self))


@register("signum")
class Signum(Optimizer):
    """Signum (``signum_update``), SignSGD without momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return state_zeros(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        kw = _common_kwargs(self)
        if state is not None:
            nd.signum_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                             momentum=self.momentum, wd_lh=self.wd_lh, **kw)
        else:
            nd.signsgd_update(weight, grad, out=weight, lr=lr, wd=wd, **kw)


@register("lamb")
class LAMB(Optimizer):
    """LAMB: phase 1 (moments and the raw update), the norms of the
    weight and of the update, then phase 2 (the trust-ratio step)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return state_zeros(weight), state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        g = nd.lamb_update_phase1(weight, grad, mean, var, beta1=self.beta1,
                                  beta2=self.beta2, epsilon=self.epsilon,
                                  t=t, bias_correction=self.bias_correction,
                                  wd=wd, **_common_kwargs(self))
        r1 = nd.norm(weight)
        r2 = nd.norm(g)
        kw2 = {}
        if self.lower_bound is not None:
            kw2["lower_bound"] = self.lower_bound
        if self.upper_bound is not None:
            kw2["upper_bound"] = self.upper_bound
        nd.lamb_update_phase2(weight, g, r1, r2, out=weight, lr=lr, **kw2)


@register("lars")
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the norms of the weight and the
    rescaled gradient read on the host scale ``lr``, then SGD."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w_norm = float(nd.norm(weight).asscalar())
        g_norm = float(nd.norm(grad * self.rescale_grad).asscalar())
        if w_norm > 0 and g_norm > 0:
            lr = lr * self.eta * w_norm / (g_norm + wd * w_norm
                                           + self.epsilon)
        kw = _common_kwargs(self)
        if state is not None:
            nd.sgd_mom_update(weight, grad, state, out=weight, lr=lr, wd=wd,
                              momentum=self.momentum, **kw)
        else:
            nd.sgd_update(weight, grad, out=weight, lr=lr, wd=wd, **kw)


@register("adadelta")
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros32(weight), _zeros32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        grad = _prep(self, grad, weight, self._get_wd(index))
        acc_g, acc_delta = state
        acc_g._set_data((self.rho * acc_g
                         + (1 - self.rho) * grad * grad)._data)
        delta = (nd.sqrt(acc_delta + self.epsilon)
                 / nd.sqrt(acc_g + self.epsilon)) * grad
        acc_delta._set_data((self.rho * acc_delta
                             + (1 - self.rho) * delta * delta)._data)
        weight._set_data((weight - delta)._data)


@register("adamax")
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return state_zeros(weight), state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        t = self._index_update_count[index]
        lr /= (1. - self.beta1 ** t)
        grad = _prep(self, grad, weight, self._get_wd(index))
        m_t, u_t = state
        m_t._set_data((self.beta1 * m_t + (1 - self.beta1) * grad)._data)
        u_t._set_data(nd.maximum(self.beta2 * u_t, nd.abs(grad))._data)
        weight._set_data((weight - lr * m_t / (u_t + 1e-8))._data)


@register("nadam")
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return state_zeros(weight), state_zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        # the reference adds the weight decay before clipping here
        grad = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            grad = nd.clip(grad, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t._set_data((self.beta1 * m_t + (1. - self.beta1) * grad)._data)
        v_t._set_data((self.beta2 * v_t
                       + (1. - self.beta2) * grad * grad)._data)
        grad_prime = grad / (1. - self.m_schedule)
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = ((1. - momentum_t) * grad_prime
                   + momentum_t_1 * m_t_prime)
        weight._set_data((weight - lr * m_t_bar
                          / (nd.sqrt(v_t_prime) + self.epsilon))._data)


@register("test")
class Test(Optimizer):
    """``w += rescale * grad``; the state mirrors the weight."""

    def create_state(self, index, weight):
        return _zeros32(weight)

    def update(self, index, weight, grad, state):
        weight._set_data((weight + grad * self.rescale_grad)._data)
        state._set_data(weight._data)


# the reference's pickled optimizer and scheduler classes, read as the
# port's; anything else of the reference in its pickle is dropped
_REF_MODULES = {"mxnet_tpu.optimizer.optimizer": "optimizer",
                "mxnet_tpu.optimizer": "optimizer",
                "mxnet_tpu.lr_scheduler": "lr_scheduler"}


class _Dropped:
    """Stands for an object of the reference the port does not read
    (a Parameter, an NDArray, a JAX array)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass

    def __call__(self, *args, **kwargs):
        return _Dropped()


class _StatesUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _REF_MODULES:
            if _REF_MODULES[module] == "optimizer":
                return _REG.find(name) if name not in globals() \
                    else globals()[name]
            from .. import lr_scheduler
            return getattr(lr_scheduler, name)
        if module.split(".")[0] in ("mxnet_tpu", "jax", "jaxlib"):
            return _Dropped
        return super().find_class(module, name)


def _loads(data):
    return _StatesUnpickler(io.BytesIO(data)).load()


class Updater:
    """Holds each index's optimizer state and applies the update
    (reference ``Updater``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states pickled as numpy arrays (tuples kept), with the
        optimizer when ``dump_optimizer``."""
        def host(s):
            if s is None:
                return None
            if isinstance(s, (list, tuple)):
                return tuple(host(x) for x in s)
            return s.asnumpy()
        states = {k: host(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states, contexts=None):
        """Read :meth:`get_states`' bytes (or the reference's); each
        state goes to ``contexts[index]`` (default: the current
        context), as float32 unless it was float16."""
        data = _loads(states)
        if isinstance(data, tuple) and len(data) == 2 and \
                isinstance(data[1], Optimizer):
            states, self.optimizer = data
        else:
            states = data
        contexts = contexts or {}

        def dev(s, ctx):
            if s is None:
                return None
            if isinstance(s, (list, tuple)):
                return tuple(dev(x, ctx) for x in s)
            return nd.array(s, ctx=ctx,
                            dtype=s.dtype if s.dtype == np.float16
                            else None)
        self.states = {k: dev(v, contexts.get(k))
                       for k, v in states.items()}
        self.states_synced = {k: False for k in self.states}


def get_updater(optimizer):
    return Updater(optimizer)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    return _REG.create(name, **kwargs)
