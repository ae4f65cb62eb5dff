"""Execution engine facade: the reference's scheduling semantics over
PyTorch's streams.  Port of ``mxnet_tpu/engine.py``.

PyTorch already gives each device an ordered stream: an op returns
once enqueued and data dependencies on one stream hold by order.  So,
as in the reference over PjRt, the mechanism of MXNet's dependency
engine (versioned vars, worker threads) dissolves and its semantics
stay:

* ``MXNET_ENGINE_TYPE=NaiveEngine``: synchronous execution, every op
  waits for its device stream before returning (the reference's tool
  for bisecting asynchronous bugs);
* ``wait_for_var`` / ``wait_for_all`` sync points, done as stream
  synchronisation on the device that holds the data (never a
  ``torch.cuda.synchronize()`` of every device); a deferred device
  error surfaces there;
* ``bulk`` / ``set_bulk_size``: the reference's op-bulking knob, kept
  for its API (torch runs eagerly, there is nothing to bulk);
* op start/stop hooks, which the profiler attaches to: ``ops/registry
  invoke`` routes an op through :meth:`Engine.push` only while a hook
  is set or the engine is synchronous.
"""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, List, Optional

import torch

__all__ = ["Engine", "engine", "bulk", "set_bulk_size"]


def _leaves(result):
    """The tensors of ``result`` (a tensor, or lists, tuples and dicts
    of them)."""
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (list, tuple)):
        for x in result:
            yield from _leaves(x)
    elif isinstance(result, dict):
        for x in result.values():
            yield from _leaves(x)


class Engine:
    """Process-global engine facade.

    ``push`` runs ``fn`` (a closure that issues torch ops) and returns
    its result; the stream is the asynchronous boundary.  Under
    ``NaiveEngine`` it waits for the stream of every CUDA output."""

    _instance: Optional["Engine"] = None
    _lock = threading.Lock()

    def __init__(self):
        etype = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
        self.engine_type = etype
        self.synchronous = etype == "NaiveEngine"
        self._op_hooks: List[Callable[[str, str], None]] = []
        self._bulk_size = 15
        self._devices = set()     # CUDA device indices pushed ops ran on

    @classmethod
    def get(cls) -> "Engine":
        inst = cls._instance
        if inst is not None:
            return inst
        with cls._lock:
            if cls._instance is None:
                cls._instance = Engine()
            return cls._instance

    # -- hooks (the profiler attaches here) --------------------------------
    def add_op_hook(self, hook: Callable[[str, str], None]):
        self._op_hooks.append(hook)

    def remove_op_hook(self, hook):
        if hook in self._op_hooks:
            self._op_hooks.remove(hook)

    def notify(self, event: str, name: str):
        for h in self._op_hooks:
            h(event, name)

    # -- execution ---------------------------------------------------------
    def push(self, fn: Callable[[], Any], name: str = "op") -> Any:
        """Run an op closure between the hooks' start and stop; under
        NaiveEngine wait for its outputs' streams."""
        if self._op_hooks:
            self.notify("start", name)
        try:
            result = fn()
        finally:
            if self._op_hooks:
                self.notify("stop", name)
        for t in _leaves(result):
            if t.is_cuda:
                self._devices.add(t.device.index)
                if self.synchronous:
                    torch.cuda.current_stream(t.device).synchronize()
        return result

    def wait_for_all(self):
        """Wait until the work enqueued on the current stream of every
        CUDA device in use has completed (reference
        ``Engine::WaitForAll`` / ``mx.nd.waitall()``); a deferred device
        error surfaces here.  Nothing to wait for on the CPU."""
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        for i in sorted(self._devices | {torch.cuda.current_device()}):
            torch.cuda.current_stream(i).synchronize()

    @staticmethod
    def wait_for_var(data):
        """Wait until ``data`` (a tensor, or a list, tuple or dict of
        them) is computed: one synchronisation of the current stream of
        each CUDA device it lies on (reference ``Engine::WaitForVar``)."""
        for i in sorted({t.device.index for t in _leaves(data)
                         if t.is_cuda}):
            torch.cuda.current_stream(i).synchronize()

    def set_bulk_size(self, size: int) -> int:
        old = self._bulk_size
        self._bulk_size = size
        return old


def engine() -> Engine:
    return Engine.get()


@contextlib.contextmanager
def bulk(size: int = 15):
    """Bulk-execution scope (reference ``mx.engine.bulk``): sets the
    bulk-size knob for its body and restores it after, so code reading
    it back behaves as in the reference; torch runs every op eagerly."""
    eng = Engine.get()
    old = eng.set_bulk_size(size)
    try:
        yield
    finally:
        eng.set_bulk_size(old)


def set_bulk_size(size: int) -> int:
    return Engine.get().set_bulk_size(size)
