"""Operator registry and imperative ``invoke``.

Port of ``mxnet_tpu/ops/registry.py`` (``OpDef``, ``register``,
``get_op``, ``invoke``).  An op's impl is a torch function
``impl(*tensors, *pos_attrs, **attrs)`` (a list of tensors first for a
``variadic`` op).  :func:`invoke` keeps the reference's contracts:

* ``training_aware`` ops get ``_training=autograd.is_training()``;
* ops with ``mutate`` return the new values of the mutated inputs after
  their outputs, and invoke writes them back into those inputs (a
  ``mutate`` callable takes the attrs, for variadic ops);
* ``out=`` writes the outputs into the given NDArrays in place and
  returns them; it is refused while recording.  An op registered with
  ``writes_out`` gets the ``out`` tensors as its ``out`` attr and may
  write into them itself (the grouped SGD kernel writes the new
  weights there), saving the copy;
* an op runs with torch's grad mode on only while ``autograd``
  records, so torch's graph is the tape;
* inside :func:`shape_resolve_scope` nothing is written back;
* the AMP cast hook (:func:`set_cast_hook`, set by ``contrib.amp``)
  maps the input tensors before the impl runs, inside the grad-mode
  block, so that autograd records the casts.

PyTorch's stream is the engine (the reference's ``engine.py`` has no
counterpart) and there is no eager-jit cache: torch runs eagerly.
"""
from __future__ import annotations

import contextlib
import inspect
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..base import MXNetError, not_ported

__all__ = ["OpDef", "register", "get_op", "list_ops", "op_exists", "invoke",
           "shape_resolve_scope", "in_shape_resolve", "set_cast_hook"]

_OPS: Dict[str, "OpDef"] = {}
_RESOLVE = threading.local()

# set by contrib.amp: a callable (op, tensors) -> tensors
_CAST_HOOK = None


def set_cast_hook(hook):
    global _CAST_HOOK
    _CAST_HOOK = hook


def in_shape_resolve() -> bool:
    """True while a shape-resolving probe runs (a hybridized block
    finishing deferred initialization): ``mutate`` write-back and
    ``out=`` writes are skipped, so the probe moves no running
    statistics (reference ``in_shape_resolve``)."""
    return getattr(_RESOLVE, "active", 0) > 0


@contextlib.contextmanager
def shape_resolve_scope():
    _RESOLVE.active = getattr(_RESOLVE, "active", 0) + 1
    try:
        yield
    finally:
        _RESOLVE.active -= 1


class OpDef:
    """A registered operator: ``name``, ``impl``, ``num_outputs`` (-1:
    attr-dependent), ``mutate`` (indices of mutated inputs, or a
    callable of the attrs), ``variadic`` (the impl takes one list of
    tensors), ``training_aware`` and ``writes_out`` (the impl takes the
    ``out=`` tensors as its ``out`` attr)."""

    __slots__ = ("name", "impl", "num_outputs", "mutate", "variadic",
                 "aliases", "doc", "training_aware", "writes_out")

    def __init__(self, name, impl, num_outputs=1, mutate=(), variadic=False,
                 aliases=(), doc="", training_aware=False, writes_out=False):
        self.name = name
        self.impl = impl
        self.num_outputs = num_outputs
        self.mutate = mutate if callable(mutate) else tuple(mutate)
        self.variadic = variadic
        self.aliases = tuple(aliases)
        self.doc = doc or (impl.__doc__ or "")
        self.training_aware = training_aware
        self.writes_out = writes_out

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name: Optional[str] = None, aliases: Sequence[str] = (),
             num_outputs: int = 1, mutate=(), variadic: bool = False,
             training_aware: bool = False, writes_out: bool = False):
    """Register a torch impl as an op; returns the impl unchanged."""
    def _dec(fn: Callable):
        opname = name or fn.__name__
        op = OpDef(opname, fn, num_outputs=num_outputs, mutate=mutate,
                   variadic=variadic, aliases=aliases,
                   training_aware=training_aware, writes_out=writes_out)
        for n in (opname,) + tuple(aliases):
            if n in _OPS:
                raise MXNetError("Duplicate op registration: %s" % n)
            _OPS[n] = op
        return fn
    return _dec


def get_op(name: str) -> OpDef:
    if name not in _OPS:
        raise not_ported("operator %r" % name, "mxnet_tpu.ops")
    return _OPS[name]


def list_ops() -> List[str]:
    return sorted(_OPS)


def op_exists(name: str) -> bool:
    return name in _OPS


_SIG: Dict[int, List[str]] = {}


def _bind_pos_attrs(op, n_arrays, pos_attrs, attrs):
    """attrs plus the positional attrs bound to the impl's parameter
    names, for ops whose ``mutate`` reads the attrs."""
    if not pos_attrs:
        return attrs
    names = _SIG.get(id(op))
    if names is None:
        names = [p.name for p in inspect.signature(op.impl).parameters
                 .values() if p.kind in (p.POSITIONAL_OR_KEYWORD,
                                         p.POSITIONAL_ONLY)]
        _SIG[id(op)] = names
    base = 1 if op.variadic else n_arrays
    merged = dict(attrs)
    for i, v in enumerate(pos_attrs):
        if base + i < len(names):
            merged.setdefault(names[base + i], v)
    return merged


def invoke(op: OpDef, inputs: Sequence, pos_attrs=(), attrs=None,
           out=None):
    """Run ``op`` on NDArrays ``inputs``; returns an NDArray or a tuple
    of them (reference ``Imperative::Invoke``)."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    attrs = {} if attrs is None else attrs
    if op.training_aware and "_training" not in attrs:
        attrs = dict(attrs, _training=autograd.is_training())
    arrays = [i._data if isinstance(i, NDArray) else i for i in inputs]
    recording = autograd.is_recording()
    if recording and out is not None:
        raise MXNetError("Inplace/out= operations are not supported when "
                         "autograd recording is on (reference semantics).")
    outs = None if out is None else \
        (out if isinstance(out, (tuple, list)) else [out])
    if op.writes_out and outs is not None:
        attrs = dict(attrs, out=[o._data for o in outs])
    with torch.set_grad_enabled(recording):
        if _CAST_HOOK is not None:
            arrays = _CAST_HOOK(op, arrays)
        if op.variadic:
            results = op.impl(list(arrays), *pos_attrs, **attrs)
        else:
            results = op.impl(*arrays, *pos_attrs, **attrs)

    multi = isinstance(results, (tuple, list))
    rlist = list(results) if multi else [results]
    mutate_idx = op.mutate(_bind_pos_attrs(op, len(arrays), pos_attrs,
                                           attrs)) \
        if callable(op.mutate) else op.mutate
    n_out = len(rlist) - len(mutate_idx)
    resolving = in_shape_resolve()
    for idx, new in zip(mutate_idx, rlist[n_out:]):
        if isinstance(inputs[idx], NDArray) and not resolving:
            inputs[idx]._set_data(new)
    rlist = rlist[:n_out]

    if outs is not None and resolving:
        return out
    if outs is not None:
        if len(outs) != len(rlist):
            raise MXNetError("out= arity mismatch for op %s" % op.name)
        for o, r in zip(outs, rlist):
            o._set_data(r)
        return out
    outputs = [NDArray(r) for r in rlist]
    if len(outputs) == 1 and (not multi or op.num_outputs == 1):
        return outputs[0]
    return tuple(outputs)
