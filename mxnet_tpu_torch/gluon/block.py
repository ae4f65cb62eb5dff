"""Gluon ``Block`` and ``HybridBlock``.

Port of ``mxnet_tpu/gluon/block.py``: name scopes and prefixes (the
global ``dense0_``-style counters), child registration by attribute,
``collect_params``, ``save_parameters`` / ``load_parameters`` keyed by
the structural names of :meth:`Block._collect_params_with_prefix`
(``features.0.weight``), and ``HybridBlock.forward`` calling
``hybrid_forward(F=nd, x, **params)`` after finishing deferred
initialization, as the reference's ``forward_raw`` does.

``hybridize()`` is accepted and the block keeps running eagerly: the
reference compiles the forward with ``jax.jit``; capturing it as a CUDA
graph is later work.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _NameManager(threading.local):
    def __init__(self):
        self.counter = {}

    def get(self, hint):
        n = self.counter.get(hint, 0)
        self.counter[hint] = n + 1
        return "%s%d" % (hint, n)


_NM = _NameManager()


class _BlockScope:
    """Auto-naming scope (reference ``_BlockScope``: dense0_, dense1_)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _NM.get(hint) + "_"
            params = ParameterDict(prefix) if params is None \
                else ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base building block (reference ``gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)) and \
                    not isinstance(existing, type(value)):
                raise MXNetError("Changing attribute type for %s from %s to "
                                 "%s is not allowed." % (name, type(existing),
                                                         type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if self._reg_params.get(name, value) is not value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """This block's and every descendant's parameters, in registration
        order; ``select`` is a regex on the full names."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update(OrderedDict((n, v) for n, v in self.params.items()
                                   if pattern.match(n)))
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def _collect_params_with_prefix(self, prefix=""):
        """Parameters by structural name (``features.0.weight``), which
        does not depend on the global name counters."""
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        params = self._collect_params_with_prefix()
        nd.save(filename, {k: v.data().copyto(cpu())
                           for k, v in params.items() if v._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        loaded = nd.load(filename)
        params = self._collect_params_with_prefix()
        if not loaded and not params:
            return
        if not isinstance(loaded, dict):
            raise MXNetError("load_parameters needs a name-keyed file")
        if not any("." in k for k in loaded):
            # written by ParameterDict.save: full names
            params = {p.name: p for p in self.collect_params().values()}
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("Parameter '%s' loaded from file is not "
                                     "present in this Block" % name)
                continue
            p = params[name]
            if p._data is None:
                p._init_from_value(value, ctx=ctx)
            else:
                p.set_data(value)
        if not allow_missing:
            for name, p in params.items():
                if name not in loaded and p._data is None \
                        and not p._deferred_init:
                    raise MXNetError("Parameter '%s' is missing in file"
                                     % name)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def __repr__(self):
        lines = ["  (%s): %s" % (k, repr(b).replace("\n", "\n  "))
                 for k, b in self._children.items()]
        if not lines:
            return "%s()" % type(self).__name__
        return "%s(\n%s\n)" % (type(self).__name__, "\n".join(lines))


class HybridBlock(Block):
    """A block whose ``hybrid_forward(F, x, **params)`` is written
    against the ``nd`` namespace.  ``hybridize()`` is accepted and the
    forward still runs eagerly, op by op (the reference jit-compiles it;
    CUDA-graph capture is not ported yet)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        self._active = active
        super().hybridize(active, **kwargs)

    def _infer_param_shapes(self, *args):
        """Layers fill in deferred parameter shapes from the inputs."""

    def _deferred_init_params(self, *args):
        needs = [p for p in self._reg_params.values() if p._deferred_init]
        if needs:
            self._infer_param_shapes(*args)
            for p in needs:
                p._finish_deferred_init()

    def forward(self, *args):
        self._deferred_init_params(*args)
        ctx = args[0].context if args and hasattr(args[0], "context") \
            else None
        params = {}
        for k, v in self._reg_params.items():
            d = v._data.get(ctx) if ctx is not None and v._data else None
            params[k] = d if d is not None else v.data()
        return self.hybrid_forward(nd, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
