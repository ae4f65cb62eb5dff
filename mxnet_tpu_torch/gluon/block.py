"""Gluon ``Block`` and ``HybridBlock``.

Port of ``mxnet_tpu/gluon/block.py``: name scopes and prefixes (the
global ``dense0_``-style counters), child registration by attribute,
``collect_params``, ``save_parameters`` / ``load_parameters`` keyed by
the structural names of :meth:`Block._collect_params_with_prefix`
(``features.0.weight``), and ``HybridBlock.forward`` calling
``hybrid_forward(F=nd, x, **params)`` after finishing deferred
initialization, as the reference's ``forward_raw`` does.

``hybridize()`` turns on the reference's ``_CachedOp`` layer: the block
keeps one compiled entry per call signature (input shapes, dtypes and
devices, training and recording flags, argument tree).  On a CUDA
device an entry is a CUDA graph of the forward (and, under
``autograd.record()``, one of the backward, through
``torch.cuda.make_graphed_callables``, captured once more for each
call made while the earlier ones still owe their backward), as the
reference compiles the forward with ``jax.jit``; on the CPU the entry
runs the forward eagerly.
"""
from __future__ import annotations

import contextlib
import re
import threading
import weakref
from collections import OrderedDict

import torch

from .. import autograd
from .. import ndarray as nd
from .._graphs import (GraphCache, Program, no_collection,
                       recorded_launches, warm_up)
from ..base import MXNetError
from ..context import Context, cpu
from ..ndarray.ndarray import NDArray
from ..ops.registry import shape_resolve_scope
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]

_TRACE = threading.local()


def _in_trace() -> bool:
    """True while a cached entry's body (or a shape probe) runs: the
    blocks under it run their forward directly."""
    return getattr(_TRACE, "depth", 0) > 0


@contextlib.contextmanager
def _tracing():
    _TRACE.depth = getattr(_TRACE, "depth", 0) + 1
    try:
        yield
    finally:
        _TRACE.depth -= 1


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


def _flatten_nds(args):
    """(NDArray leaves, tree) of nested lists/tuples of NDArrays; other
    values stay in the tree as constants (reference ``_flatten_nds``)."""
    leaves = []

    def rec(a):
        if isinstance(a, NDArray):
            leaves.append(a)
            return "#"
        if isinstance(a, (list, tuple)):
            return [rec(x) for x in a]
        return ("const", a)

    return leaves, [rec(a) for a in args]


def _unflatten_nds(tree, leaves):
    it = iter(leaves)

    def rec(t):
        if t == "#":
            return next(it)
        if isinstance(t, list):
            return [rec(x) for x in t]
        return t[1]

    return [rec(t) for t in tree]


def _tree_sig(tree):
    if isinstance(tree, list):
        return tuple(_tree_sig(t) for t in tree)
    if isinstance(tree, tuple):
        try:
            hash(tree[1])
            return tree
        except TypeError:
            return ("const", str(tree[1]))
    return tree


class _Pending:
    """Marks one forward of a :class:`_Replica` whose backward is still
    owed; it lives in that forward's autograd node, so it dies with the
    node when the caller drops the outputs without a backward."""

    __slots__ = ("__weakref__",)


class _Outputs(torch.autograd.Function):
    """A graph's static outputs copied out for the caller (the next
    replay overwrites them).  The backward frees the replica for its
    next forward, counts the backward graph's kernel launches, which
    its replay runs next, and passes the gradients through."""

    @staticmethod
    def forward(ctx, replica, *outs):
        ctx.replica, ctx.call = replica, replica.calls
        ctx.pending = _Pending()
        replica.owner = weakref.ref(ctx.pending)
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        replica = ctx.replica
        if replica.graphed is not None:
            if replica.calls != ctx.call:
                raise MXNetError(
                    "hybridize: a later call of this block overwrote the "
                    "activations this backward needs (a graph kept with "
                    "retain_graph=True is differentiated again after the "
                    "block's next recorded call)")
            replica.bwd_launches.add()
        replica.owner = None
        return (None,) + grads


class _Replica:
    """One capture of a recorded entry: its forward and backward graphs
    (``torch.cuda.make_graphed_callables``) in a memory pool of their
    own, so no other graph's replay reuses the activations they save.
    Those activations serve one forward at a time: the replica is busy
    from a forward until that forward's backward has run or its
    autograd graph is gone.  On the CPU nothing is captured and the
    body runs eagerly."""

    def __init__(self, op):
        self.calls = 0
        self.owner = None           # weak reference to a _Pending
        self.graphed = None
        if op.device.type == "cuda":
            self._capture(op)

    def busy(self):
        return self.owner is not None and self.owner() is not None

    def _capture(self, op):
        """The graphed callable, and the launches each graph stands for
        (the forward's taken inside the body, the backward's over the
        call).  Its arguments are fresh leaves over the parameters'
        storage and static inputs of the replica's own, which its
        backward graph reads; a replay hands the gradients to the
        parameters' own accumulators.  The warm-up runs here, on other
        fresh leaves whose autograd graph dies with it, and
        ``make_graphed_callables`` none: its own warm-up keeps its graph
        alive into the capture (torch 2.11), so the capture's backward
        would meet gradient accumulators made on the warm-up's stream,
        or, for leaves an earlier eager backward still holds, on the
        default stream, which ends the capture."""
        def leaves():
            with torch.no_grad():
                return ([t.detach().requires_grad_() if t.requires_grad
                         else t for t in op.bound]
                        + [s.clone().requires_grad_(s.requires_grad)
                           for s in op.static])

        def warm():
            args = leaves()
            outs = [o for o in op._body(*args) if o.requires_grad]
            wrt = [a for a in args if a.requires_grad]
            if outs and wrt:
                torch.autograd.grad(outs, wrt,
                                    [torch.zeros_like(o) for o in outs],
                                    allow_unused=True)

        fwd = []

        def counted(*tensors):
            out, launches = recorded_launches(lambda: op._body(*tensors))
            fwd.append(launches)
            return out

        with op._kept():
            warm_up(warm)
            with no_collection():
                self.graphed, self.bwd_launches = recorded_launches(
                    lambda: torch.cuda.make_graphed_callables(
                        counted, tuple(leaves()), num_warmup_iters=0,
                        allow_unused_input=True))
        (self.launches,) = fwd

    def __call__(self, op, args):
        self.calls += 1
        if self.graphed is None:
            outs = op._body(*op.bound, *args)
        else:
            outs = self.graphed(*op.bound, *args)
            self.launches.add()
        return _Outputs.apply(self, *outs)


class _CachedOp:
    """One compiled entry of a hybridized block: the reference's
    ``_CachedOp`` (``mxnet_tpu/gluon/block.py:353``).

    Its body is a function of ``(parameter tensors..., argument
    tensors...)``, the reference's ``(param_vals, arg_vals, key)``: it
    binds each parameter to an NDArray over its tensor on the entry's
    device, runs the block's ``forward_raw`` and puts the bindings
    back.  The mutated aux values (BatchNorm's running statistics) are
    written in place by ``invoke``, so inside a graph that write is a
    captured copy and each replay moves them once.

    The entry's device is its inputs' (part of the signature).  On
    CUDA, under ``autograd.record()`` a call runs a :class:`_Replica`
    that is not busy, capturing another when every one is (a block
    called twice before one backward, as a GAN's discriminator on real
    and fake batches): it replays the forward graph and its backward
    replays the backward graph, the gradients reaching each parameter
    by its ``grad_req``.  Not recording, the forward is one graph
    captured under ``no_grad`` into the block's pool for the device.
    The arguments are copied into static buffers and the outputs
    copied out.  The warm-up runs before capture move no running
    statistic and no gradient: both are put back.  On the CPU the body
    runs eagerly through the same bookkeeping.
    """

    def __init__(self, block, params, leaves, tree, training, recording,
                 device, cache):
        self.block = block
        self.params = params
        self.tree = tree
        self.training = training
        self.recording = recording
        self.device = device
        self.ctx = Context.of(device)
        self.out_tree = None
        self.bound = self.param_tensors()
        self.replicas = []
        if device.type != "cuda":
            return
        self.static = [torch.empty_like(a._data).requires_grad_(
            a._data.requires_grad) for a in leaves]
        with torch.no_grad():
            for s, a in zip(self.static, leaves):
                s.copy_(a._data)
        if recording:
            self.replica()
        else:
            with self._kept():
                self._capture_forward(cache.pool(device))

    def _param_nd(self, p):
        """(key, NDArray) of ``p``'s value on the entry's device."""
        if self.ctx in p._data:
            return self.ctx, p._data[self.ctx]
        return next(iter(p._data.items()))

    def param_tensors(self):
        return [self._param_nd(p)[1]._data for p in self.params]

    def _body(self, *tensors):
        n = len(self.params)
        saved = [(p, p._data) for p in self.params]
        try:
            for p, t in zip(self.params, tensors[:n]):
                p._data = OrderedDict({self._param_nd(p)[0]: NDArray(t)})
            args = _unflatten_nds(self.tree,
                                  [NDArray(t) for t in tensors[n:]])
            with _tracing(), autograd._scope(self.recording, self.training):
                out = self.block.forward_raw(*args)
        finally:
            for p, data in saved:
                p._data = data
        seq = isinstance(out, (list, tuple))
        leaves, tree = _flatten_nds(out if seq else [out])
        self.out_tree = (tree, seq)
        return tuple(o._data for o in leaves)

    @contextlib.contextmanager
    def _kept(self):
        """The aux values (the parameters without a gradient, which a
        forward may write) and every gradient as on entry, again on
        exit: the warm-up runs leave no trace."""
        aux = [t for t in self.bound if not t.requires_grad]
        grads = [g for p in self.params if p._grad is not None
                 for g in p._grad.values()]
        with torch.no_grad():
            values = [t.clone() for t in aux]
            grad_values = [g._data.clone() for g in grads]
        try:
            yield
        finally:
            with torch.no_grad():
                for t, v in zip(aux, values):
                    t.copy_(v)
                for g, v in zip(grads, grad_values):
                    g._data.copy_(v)

    def _capture_forward(self, pool):
        def body():
            return self._body(*self.bound, *self.static)

        with torch.no_grad():
            warm_up(body)
            self.program = Program(body, self.device, pool)

    def replica(self):
        """A replica that is not busy, captured when none is free."""
        for r in self.replicas:
            if not r.busy():
                return r
        self.replicas.append(_Replica(self))
        return self.replicas[-1]

    def __call__(self, leaves):
        args = [a._data for a in leaves]
        if self.recording:
            outs = self.replica()(self, args)
        elif self.device.type != "cuda":
            outs = self._body(*self.bound, *args)
        else:
            for s, a in zip(self.static, args):
                s.copy_(a)
            outs = [o.clone() for o in self.program()]
        tree, seq = self.out_tree
        result = _unflatten_nds(tree, [NDArray(o) for o in outs])
        return result if seq else result[0]


class HybridBlock(Block):
    """A block whose ``hybrid_forward(F, x, **params)`` is written
    against the ``nd`` namespace.  After ``hybridize()`` a call goes
    through a per-signature :class:`_CachedOp` (a CUDA graph on the
    card, as the reference's jitted ``_CachedOp``); ``hybridize(False)``
    runs it op by op again."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_ops = None

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._cached_ops = None
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
        if self._active and not _in_trace():
            return self._call_cached(*args)
        return self.forward_raw(*args)

    def forward_raw(self, *args):
        """``hybrid_forward`` on this call's inputs, op by op."""
        self._deferred_init_params(*args)
        ctx = args[0].context if args and hasattr(args[0], "context") \
            else None
        params = {}
        for k, v in self._reg_params.items():
            d = v._data.get(ctx) if ctx is not None and v._data else None
            params[k] = d if d is not None else v.data()
        return self.hybrid_forward(nd, *args, **params)

    def _resolve_deferred(self, *args):
        """Finish deferred initialization across the subtree with one
        eager probe forward in predict mode, writing back no mutated
        value, so the running statistics do not move (reference
        ``_resolve_deferred``)."""
        if not any(p._deferred_init
                   for p in self.collect_params().values()):
            return
        with _tracing(), autograd._scope(False, False), \
                shape_resolve_scope():
            self.forward_raw(*args)

    def _call_cached(self, *args):
        leaves, tree = _flatten_nds(args)
        # the reference's signature, plus the recording flag (a recorded
        # call also captures the backward) and each input's device and
        # requires_grad (make_graphed_callables needs them to match)
        sig = (tuple((a.shape, str(a.dtype), a._data.device,
                      a._data.requires_grad) for a in leaves),
               autograd.is_training(), autograd.is_recording(),
               _tree_sig(tree))
        if self._cached_ops is None:
            self._cached_ops = GraphCache()
        entry = self._cached_ops.get(sig)
        if entry is None or any(a is not b for a, b in zip(
                entry.param_tensors(), entry.bound)):
            self._resolve_deferred(*args)
            params = [p for p in self.collect_params().values()
                      if p._data is not None]
            device = leaves[0]._data.device if leaves else \
                torch.device("cpu")
            entry = self._cached_ops.put(sig, _CachedOp(
                self, params, leaves, tree, autograd.is_training(),
                autograd.is_recording(), device, self._cached_ops))
        return entry(leaves)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
