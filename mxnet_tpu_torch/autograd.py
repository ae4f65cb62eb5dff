"""Autograd: MXNet's recording API on torch autograd.

Port of ``mxnet_tpu/autograd.py`` (``record``, ``pause``,
``train_mode``/``predict_mode``, ``is_recording``, ``is_training``,
``mark_variables``, ``backward``).  Where the reference keeps a tape of
ops and replays it under ``jax.vjp``, the tape here is torch's graph:
``ops.registry.invoke`` runs an op with torch's grad mode on only while
recording, a marked variable is a torch leaf that requires grad, and
:func:`backward` calls ``torch.autograd.backward``.  A hook on each
variable moves the gradient torch accumulates into the variable's
gradient buffer by its ``grad_req``: ``write`` replaces the buffer's
value, ``add`` adds to it, ``null`` asks for no gradient.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward"]


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


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (NDArrays computed under :func:`record`)
    with respect to every variable they depend on, written into the
    variables' gradient buffers.  A missing head gradient is ones."""
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    tensors, grads = [], []
    for h, g in zip(heads, head_grads):
        if not h._data.requires_grad:
            raise MXNetError(
                "Cannot differentiate: output is not on the autograd tape "
                "(was it computed under autograd.record() from a variable "
                "with attach_grad?)")
        tensors.append(h._data)
        grads.append(torch.ones_like(h._data) if g is None
                     else getattr(g, "_data", g))
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)
