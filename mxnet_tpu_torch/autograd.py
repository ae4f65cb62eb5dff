"""Autograd: MXNet's recording API on torch autograd.

Port of ``mxnet_tpu/autograd.py`` (``record``, ``pause``,
``train_mode``/``predict_mode``, ``is_recording``, ``is_training``,
``mark_variables``, ``backward``, ``grad`` and ``Function``).  Where the
reference keeps a tape of
ops and replays it under ``jax.vjp``, the tape here is torch's graph:
``ops.registry.invoke`` runs an op with torch's grad mode on only while
recording, a marked variable is a torch leaf that requires grad, and
:func:`backward` calls ``torch.autograd.backward``.  A hook on each
variable moves the gradient torch accumulates into the variable's
gradient buffer by its ``grad_req``: ``write`` replaces the buffer's
value, ``add`` adds to it, ``null`` asks for no gradient.
:func:`grad` returns the gradients through ``torch.autograd.grad``
instead, leaving the buffers alone; with ``create_graph=True`` they are
on torch's graph themselves, so a gradient of a gradient works wherever
each op's backward is written in torch ops.  A node whose backward
launches a hand-written kernel (flash attention, ``Custom``, a
replayed CUDA graph) is differentiable once: through it a second
derivative raises instead of coming back as zeros.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    old, _STATE.recording = _STATE.recording, flag
    return old


def set_training(flag: bool) -> bool:
    old, _STATE.training = _STATE.training, flag
    return old


@contextlib.contextmanager
def _scope(recording, training):
    old = (_STATE.recording, _STATE.training)
    if recording is not None:
        _STATE.recording = recording
    if training is not None:
        _STATE.training = training
    try:
        yield
    finally:
        _STATE.recording, _STATE.training = old


def record(train_mode: bool = True):
    """Scope in which executed ops are recorded for differentiation."""
    return _scope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope in which recording is suspended."""
    return _scope(False, train_mode)


def train_mode():
    return _scope(None, True)


def predict_mode():
    return _scope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a variable whose gradient
    ``backward`` writes into the matching NDArray of ``gradients``."""
    if not isinstance(variables, (list, tuple)):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        v._mark_variable(g, req)


def _deliver(t, ref):
    """Post-accumulate hook of a variable's tensor: move ``t.grad`` into
    the variable's gradient buffer by its ``grad_req``."""
    nd = ref()
    if nd is None or t.grad is None or nd._grad is None:
        return
    if nd._grad_req == "add":
        nd._grad._data.add_(t.grad)
    else:
        nd._grad._data = t.grad
    t.grad = None


def _heads(heads, head_grads):
    """The heads' tensors and their head gradients (ones where missing).
    A head computed under ``record()`` from a variable but off torch's
    graph (an integer output such as ``topk``'s indices, or an output of
    ``grad_req="null"`` variables only) adds no gradient, as in the
    reference; a head no variable reaches cannot be differentiated."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    tensors, grads = [], []
    for h, g in zip(heads, head_grads):
        if not h._data.requires_grad:
            if getattr(h, "_reach", False):
                continue
            raise MXNetError(
                "Cannot differentiate: output is not on the autograd tape "
                "(was it computed under autograd.record() from a variable "
                "with attach_grad?)")
        tensors.append(h._data)
        grads.append(torch.ones_like(h._data) if g is None
                     else getattr(g, "_data", g))
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays computed under :func:`record`)
    with respect to every variable they depend on, written into the
    variables' gradient buffers.  A missing head gradient is ones."""
    tensors, grads = _heads(heads, head_grads)
    if tensors:
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables`` (marked
    with ``attach_grad``), returned as NDArrays; the variables'
    gradient buffers are left as they are.  One variable, not in a
    list, gives one array.  ``create_graph=True`` puts the gradients on
    the graph, so they can be differentiated again; ``retain_graph``
    defaults to ``create_graph``."""
    from .ndarray.ndarray import NDArray
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("grad() variables must be marked "
                             "(attach_grad/mark_variables)")
    if retain_graph is None:
        retain_graph = create_graph
    tensors, grads = _heads(heads, head_grads)
    if not tensors:
        res = [None] * len(variables)
    else:
        with torch.enable_grad():
            res = torch.autograd.grad(tensors, [v._data for v in variables],
                                      grads, retain_graph=retain_graph,
                                      create_graph=create_graph,
                                      allow_unused=True)
    out = [NDArray(torch.zeros_like(v._data.detach()) if g is None
                   else g if create_graph else g.detach())
           for v, g in zip(variables, res)]
    return out[0] if single else out


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported; use "
                     "HybridBlock.export() for graph extraction.")


class _UserFunction(torch.autograd.Function):
    """A :class:`Function`'s ``forward`` and ``backward`` as one node."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outs = func.forward(*[NDArray(t) for t in tensors])
        ctx.func = func
        func._single = not isinstance(outs, (tuple, list))
        return tuple(o._data for o in ([outs] if func._single else outs))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            res = ctx.func.backward(*[NDArray(g) for g in grads])
        res = res if isinstance(res, (tuple, list)) else [res]
        return (None,) + tuple(None if r is None else r._data for r in res)


class Function:
    """A differentiable function written by the user (reference
    ``autograd.Function``): subclass it with ``forward(self, *inputs)``
    and ``backward(self, *output_grads)`` on NDArrays, keeping what the
    backward needs with :meth:`save_for_backward`.  The forward runs
    under :func:`pause`, as in the reference."""

    def __init__(self):
        self._saved = ()
        self._single = True

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording()
                and any(i._data.requires_grad for i in inputs)):
            with pause():
                return self.forward(*inputs)
        outs = [NDArray(t) for t in _UserFunction.apply(
            self, *[i._data for i in inputs])]
        return outs[0] if self._single else tuple(outs)
