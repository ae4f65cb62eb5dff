"""Device contexts.

Port of ``mxnet_tpu/context.py``.  A :class:`Context` names a torch
device: ``gpu(i)`` is CUDA device ``i`` and ``cpu()`` the host.  The
default context, where no ``with ctx:`` scope is open, is the current
CUDA device through :func:`mxnet_tpu_torch.resolve_device`, which raises
when there is none: arrays and parameters land on the card unless the
caller names ``cpu()``.  The reference's ``tpu()`` has no counterpart.
"""
from __future__ import annotations

import threading

import torch

from . import resolve_device
from .base import MXNetError, not_ported

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context"]

_STACK = threading.local()


class Context:
    """Execution device (reference ``Context``): ``device_type`` is
    ``"cpu"`` or ``"gpu"``, ``device_id`` its index.  ``with ctx:`` makes
    it the default context of the thread."""

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type == "tpu":
            raise not_ported("Context('tpu')", "mxnet_tpu.context.tpu")
        if device_type not in ("cpu", "gpu"):
            raise MXNetError("Unknown device type %r" % device_type)
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The torch device; a ``gpu`` context raises without CUDA."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device("cuda:%d" % self.device_id)

    @staticmethod
    def of(device: torch.device) -> "Context":
        """The context of a tensor's device."""
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        if device.type == "cpu":
            return Context("cpu", 0)
        raise MXNetError("unsupported device %s" % device)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __str__ = __repr__

    def __enter__(self):
        if not hasattr(_STACK, "ctx"):
            _STACK.ctx = []
        _STACK.ctx.append(self)
        return self

    def __exit__(self, *args):
        _STACK.ctx.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    raise not_ported("tpu()", "mxnet_tpu.context.tpu; use gpu(i)")


def current_context() -> Context:
    """The innermost ``with ctx:`` context, else the current CUDA device
    (raises when there is none)."""
    stack = getattr(_STACK, "ctx", None)
    if stack:
        return stack[-1]
    return Context.of(resolve_device())
