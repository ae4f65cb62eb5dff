"""Operator registry and imperative ``invoke``.

Port of ``mxnet_tpu/ops/registry.py`` (``OpDef``, ``register``,
``get_op``, ``invoke``).  An op's impl is a torch function
``impl(*tensors, *pos_attrs, **attrs)`` (a list of tensors first for a
``variadic`` op).  :func:`invoke` keeps the reference's contracts:

* ``training_aware`` ops get ``_training=autograd.is_training()``;
* ``no_grad`` ops (a bool, or a callable of the attrs, as ``topk``'s
  ``ret_typ``) run with torch's grad mode off, so their outputs come
  back detached and never enter autograd (integer and index outputs);
* ``ctx=`` runs the op inside :func:`device_scope` of that context's
  device: an op that creates its tensors (``_zeros``, ``_arange``, the
  ``_random_*`` samplers) puts them on :func:`creation_device`, the
  innermost scope's device, else the current context's;
* ``needs_rng`` ops take a ``torch.Generator`` (or None: torch's
  default generator of the tensors' device) before their tensors;
  ``invoke`` passes None, a symbolic executor its node's generator;
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

PyTorch's stream is the engine: ``invoke`` goes through
``engine.Engine.push`` (the op hooks the profiler sets, the
``NaiveEngine`` wait) only while a hook is set or the engine is
synchronous, as the reference does, and runs the op directly
otherwise.  There is no eager-jit cache: torch runs eagerly.
"""
from __future__ import annotations

import contextlib
import inspect
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..base import MXNetError, not_ported
from ..engine import Engine

__all__ = ["OpDef", "register", "get_op", "list_ops", "op_exists", "invoke",
           "invoke_impl", "shape_resolve_scope", "in_shape_resolve",
           "set_cast_hook", "device_scope", "creation_device"]

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


@contextlib.contextmanager
def device_scope(device):
    """Ops that create tensors put them on ``device`` inside this scope
    (the reference's ``jax.default_device`` around ``invoke(ctx=)``)."""
    stack = _RESOLVE.__dict__.setdefault("devices", [])
    stack.append(torch.device(device))
    try:
        yield
    finally:
        stack.pop()


def creation_device() -> torch.device:
    """The device a creation op's tensors go to: the innermost
    :func:`device_scope`, else the current context's (the card unless a
    ``with mx.cpu():`` scope is open)."""
    stack = getattr(_RESOLVE, "devices", None)
    if stack:
        return stack[-1]
    from ..context import current_context
    return current_context().torch_device


class OpDef:
    """A registered operator: ``name``, ``impl``, ``num_outputs`` (-1:
    attr-dependent), ``mutate`` (indices of mutated inputs, or a
    callable of the attrs), ``no_grad`` (outputs not differentiable: a
    bool or a callable of the attrs), ``variadic`` (the impl takes one
    list of tensors), ``needs_rng`` (the impl takes a generator first),
    ``training_aware`` and ``writes_out`` (the impl takes the ``out=``
    tensors as its ``out`` attr)."""

    __slots__ = ("name", "impl", "num_outputs", "mutate", "no_grad",
                 "variadic", "aliases", "doc", "needs_rng", "training_aware",
                 "writes_out")

    def __init__(self, name, impl, num_outputs=1, mutate=(), no_grad=False,
                 variadic=False, aliases=(), doc="", needs_rng=False,
                 training_aware=False, writes_out=False):
        self.name = name
        self.impl = impl
        self.num_outputs = num_outputs
        self.mutate = mutate if callable(mutate) else tuple(mutate)
        self.no_grad = no_grad
        self.variadic = variadic
        self.aliases = tuple(aliases)
        self.doc = doc or (impl.__doc__ or "")
        self.needs_rng = needs_rng
        self.training_aware = training_aware
        self.writes_out = writes_out

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name: Optional[str] = None, aliases: Sequence[str] = (),
             num_outputs: int = 1, mutate=(), no_grad=False,
             variadic: bool = False, needs_rng: bool = False,
             training_aware: bool = False, writes_out: bool = False):
    """Register a torch impl as an op; returns the impl unchanged."""
    def _dec(fn: Callable):
        opname = name or fn.__name__
        op = OpDef(opname, fn, num_outputs=num_outputs, mutate=mutate,
                   no_grad=no_grad, variadic=variadic, aliases=aliases,
                   needs_rng=needs_rng, training_aware=training_aware,
                   writes_out=writes_out)
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


def invoke_impl(op, arrays, pos_attrs, attrs, generator=None):
    """The op's impl on tensors after the AMP cast hook, under the
    caller's grad mode (reference ``invoke_impl``): the one call through
    which ``invoke`` and the symbolic executor's graph walk both run an
    op.  A ``needs_rng`` op gets ``generator`` first."""
    if _CAST_HOOK is not None:
        arrays = _CAST_HOOK(op, arrays)
    lead = (generator,) if op.needs_rng else ()
    if op.variadic:
        return op.impl(*lead, list(arrays), *pos_attrs, **attrs)
    return op.impl(*lead, *arrays, *pos_attrs, **attrs)


def _run(op, arrays, pos_attrs, attrs, recording):
    """The op's impl under the grad mode of ``recording``."""
    with torch.set_grad_enabled(recording):
        return invoke_impl(op, arrays, pos_attrs, attrs)


def _operand(a, opname):
    """The tensor an op reads for NDArray ``a``.  No op of the registry
    has a sparse kernel, so a sparse array enters in its dense form,
    with one warning per op name: MXNet's storage fallback."""
    if a.stype == "default":
        return a._data
    from ..ndarray.sparse import _fallback_warn
    _fallback_warn(opname)
    return a._to_dense()


def _dense_target(a, opname):
    """``a``'s tensor, for an op that writes into it; a sparse target
    would take a dense result into its compact block, so it raises."""
    if a.stype != "default":
        raise MXNetError("%s: cannot write a dense result into a %s array"
                         % (opname, a.stype))
    return a._data


def invoke(op: OpDef, inputs: Sequence, pos_attrs=(), attrs=None,
           out=None, ctx=None):
    """Run ``op`` on NDArrays ``inputs`` (its created tensors on ``ctx``
    when given); returns an NDArray or a tuple of them (reference
    ``Imperative::Invoke``)."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray, _tagged, _lead_ctx

    attrs = {} if attrs is None else attrs
    if op.training_aware and "_training" not in attrs:
        attrs = dict(attrs, _training=autograd.is_training())
    arrays = [_operand(i, op.name) if isinstance(i, NDArray) else i
              for i in inputs]
    no_grad = op.no_grad
    if callable(no_grad):
        no_grad = no_grad(_bind_pos_attrs(op, len(arrays), pos_attrs, attrs))
    recording = autograd.is_recording() and not no_grad
    if recording and out is not None:
        raise MXNetError("Inplace/out= operations are not supported when "
                         "autograd recording is on (reference semantics).")
    outs = None if out is None else \
        (out if isinstance(out, (tuple, list)) else [out])
    if outs is not None:
        targets = [_dense_target(o, op.name) for o in outs]
        if op.writes_out:
            attrs = dict(attrs, out=targets)
    eng = Engine.get()
    scope = contextlib.nullcontext() if ctx is None else \
        device_scope(ctx.torch_device)
    with scope:
        if eng._op_hooks or eng.synchronous:
            # the profiler's hook or NaiveEngine: through the engine's push
            results = eng.push(lambda: _run(op, arrays, pos_attrs, attrs,
                                            recording), op.name)
        else:
            results = _run(op, arrays, pos_attrs, attrs, recording)

    multi = isinstance(results, (tuple, list))
    rlist = list(results) if multi else [results]
    mutate_idx = op.mutate(_bind_pos_attrs(op, len(arrays), pos_attrs,
                                           attrs)) \
        if callable(op.mutate) else op.mutate
    n_out = len(rlist) - len(mutate_idx)
    resolving = in_shape_resolve()
    for idx, new in zip(mutate_idx, rlist[n_out:]):
        if isinstance(inputs[idx], NDArray) and not resolving:
            _dense_target(inputs[idx], op.name)
            inputs[idx]._set_data(new)
    rlist = rlist[:n_out]
    if ctx is not None and ctx.device_type == "cpu_pinned":
        rlist = [r.pin_memory() for r in rlist]

    if outs is not None and resolving:
        return out
    if outs is not None:
        if len(outs) != len(rlist):
            raise MXNetError("out= arity mismatch for op %s" % op.name)
        for o, r in zip(outs, rlist):
            o._set_data(r)
        return out
    outputs = [NDArray(r) for r in rlist]
    if recording and any(getattr(i, "_reach", False) for i in inputs
                         if isinstance(i, NDArray)):
        for o in outputs:
            o._reach = True
    at = ctx if ctx is not None else _lead_ctx(inputs)
    if at is not None:
        outputs = [_tagged(o, at) for o in outputs]
    if len(outputs) == 1 and (not multi or op.num_outputs == 1):
        return outputs[0]
    return tuple(outputs)
