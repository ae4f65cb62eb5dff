"""Gluon ``Parameter`` and ``ParameterDict``.

Port of ``mxnet_tpu/gluon/parameter.py``: deferred initialization (the
shape is filled in by the first forward), per-context copies,
``grad_req`` (``write``/``add``/``null``), ``lr_mult``/``wd_mult``, and
``data``/``list_data``/``grad``/``list_grad``/``set_data``/``zero_grad``.
Initial values are drawn on the CPU, as in the reference, and copied to
each context; every copy with a gradient is an autograd variable.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from .. import initializer
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was known."""


def _shape_known(shape):
    return shape is not None and len(shape) > 0 and all(s > 0 for s in shape)


class Parameter:
    """A weight or auxiliary tensor held by Blocks: one NDArray per
    context in ``_data`` and, unless ``grad_req`` is ``null``, one
    gradient buffer per context in ``_grad``."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = None
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data: Optional[Dict[Context, NDArray]] = None
        self._grad: Optional[Dict[Context, NDArray]] = None
        self._deferred_init = ()
        self._ctx_list: Optional[List[Context]] = None
        self._trainer = None
        self.grad_req = "null" if not differentiable else grad_req

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add, or null, got %s"
                             % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                for d in self._data.values():
                    d._mark_variable(None, "null")
        elif self._data is not None:
            self._init_grad()

    def _check_initialized(self, ctx=None):
        if self._data is not None:
            if ctx is not None and ctx not in self._data:
                raise MXNetError(
                    "Parameter '%s' was not initialized on context %s. It "
                    "was only initialized on %s."
                    % (self.name, ctx, list(self._data)))
            return
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass." % self.name)
        raise MXNetError(
            "Parameter '%s' has not been initialized. You should initialize "
            "parameters and create Trainer with Block.collect_params() "
            "instead of Block.params." % self.name)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        if default_init is None:
            default_init = initializer.Uniform()
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        if init is None:
            init = default_init if self.init is None else self.init
        if not _shape_known(self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self.shape))
        self._finish_init(init, ctx)

    def _finish_init(self, init, ctx):
        data = nd.zeros(self.shape, dtype=self.dtype, ctx=cpu())
        init_obj = initializer.create(init) if isinstance(init, str) \
            else init
        init_obj(initializer.InitDesc(self.name), data)
        self._data = OrderedDict((c, data.copyto(c)) for c in ctx)
        if self._grad_req != "null":
            self._init_grad()
        self._deferred_init = ()

    def _init_from_value(self, value, ctx=None):
        """Create the buffers from a value (the load path) instead of
        drawing and then overwriting them."""
        value = value if isinstance(value, NDArray) \
            else nd.array(value, ctx=cpu())
        self.shape = tuple(value.shape)
        if ctx is None:
            ctx = (self._deferred_init[1] if self._deferred_init
                   else self._ctx_list) or [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        self._ctx_list = list(ctx)
        self._data = OrderedDict((c, value.copyto(c)) for c in ctx)
        if self._grad_req != "null":
            self._init_grad()
        self._deferred_init = ()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if not _shape_known(self.shape):
            raise DeferredInitializationError(
                "Parameter '%s' shape still unknown at deferred init"
                % self.name)
        self._finish_init(init if init is not None else default_init, ctx)

    def _init_grad(self):
        from .. import autograd
        self._grad = OrderedDict()
        for c, d in self._data.items():
            g = NDArray(torch.zeros_like(d._data.detach()))
            self._grad[c] = g
            autograd.mark_variables([d], [g], [self._grad_req])

    def data(self, ctx=None) -> NDArray:
        self._check_initialized(ctx)
        if ctx is None:
            return next(iter(self._data.values()))
        return self._data[ctx]

    def list_data(self):
        self._check_initialized()
        return list(self._data.values())

    def grad(self, ctx=None) -> NDArray:
        if self._grad is None:
            raise MXNetError("Cannot get gradient array for Parameter '%s' "
                             "because grad_req='null'" % self.name)
        self._check_initialized(ctx)
        if ctx is None:
            return next(iter(self._grad.values()))
        return self._grad[ctx]

    def list_grad(self):
        self._check_initialized()
        if self._grad is None:
            raise MXNetError("grad_req='null' for Parameter '%s'"
                             % self.name)
        return list(self._grad.values())

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise MXNetError("Parameter '%s' has not been initialized"
                             % self.name)
        return list(self._data)

    def zero_grad(self):
        if self._grad is None:
            return
        for g in self._grad.values():
            g._data.zero_()

    def reset_ctx(self, ctx):
        """Move the value to the context(s) ``ctx``: new arrays (and
        gradient buffers) there, copied from the first context's
        (reference ``Parameter.reset_ctx``)."""
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None:
            cur = next(iter(self._data.values()))
            self._data = OrderedDict((c, cur.copyto(c)) for c in ctx)
            self._ctx_list = list(ctx)
            if self._grad_req != "null":
                self._init_grad()
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx, default_init)

    def set_data(self, data):
        """Write ``data`` into every context's copy, in place."""
        self.shape = tuple(data.shape)
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter '%s' has not been initialized"
                                 % self.name)
            self._finish_deferred_init()
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(data)
        for d in self._data.values():
            d._set_data(src.to(d._data.device, d._data.dtype))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                       self.dtype)


class ParameterDict:
    """Name -> Parameter mapping with a prefix and sharing (reference
    ``ParameterDict``)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs) -> Parameter:
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None:
                v = tuple(v)
                if len(existing) == len(v):
                    param.shape = tuple(a if a else b
                                        for a, b in zip(existing, v))
                elif not existing:
                    param.shape = v
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other because they "
                                 "have different Parameters with the same "
                                 "name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def __repr__(self):
        return "%s(\n%s)" % (type(self).__name__, "".join(
            "  %s\n" % v for v in self.values()))
