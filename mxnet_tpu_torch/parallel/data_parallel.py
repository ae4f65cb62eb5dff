"""Data-parallel training of a Gluon block, on one device.

Port of ``mxnet_tpu/parallel/data_parallel.py`` ``DataParallelTrainer``:
the same constructor, :meth:`~DataParallelTrainer.step`,
:meth:`~DataParallelTrainer.run_steps` (reuse mode with ``steps=K``,
superbatch mode with ``steps=None``), :meth:`~DataParallelTrainer.sync`
and :meth:`~DataParallelTrainer.sync_back`, and the reference's
observable semantics:

* the trainer owns a copy of the parameter values, taken at its first
  step on the mesh's device (parameters initialised on the CPU move
  there); the Gluon Parameters change only at ``sync_back()``;
* the loss is ``loss.astype(float32).mean()``;
* every parameter takes the optimizer update (``_optim.py``); one that
  an op mutated in the forward (BatchNorm's running statistics, through
  the ``mutate`` contract) then takes its forward value instead;
* with ``amp=True`` the bfloat16 cast hook of ``contrib.amp`` is set for
  the step's forward only, the previous hook restored after it; the
  parameters stay float32 masters.

The reference compiles one step with ``jax.jit`` and ``run_steps``'
K steps with ``lax.scan``.  On CUDA the port captures one whole step,
forward, backward and update, as one CUDA graph (``_graphs.Program``)
per batch signature: ``step()`` replays it once and ``run_steps(K)`` K
times, copying slice k into the static input before replay k in
superbatch mode.  Before the capture one step runs as a warm-up and the
parameters and optimizer state are put back, so replay 1 is step 1.  A
capture that fails raises.  On the CPU the same code runs the step
eagerly; ``_eager = True`` runs it eagerly on CUDA too (the comparator
of the captured step).  A mesh of more than one device raises
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import logging
import types
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd
from .._graphs import GraphCache, Program, warm_up
from ..base import MXNetError
from ..context import Context
from ..gluon.block import _tracing
from ..ndarray.ndarray import NDArray
from ..ops import registry as _registry
from ._optim import make_rule
from .mesh import check_one_device, default_mesh

__all__ = ["DataParallelTrainer"]


class _Bound(NDArray):
    """A parameter's value inside the step.  A write through an op's
    ``mutate`` contract rebinds it to the new value (as the reference
    swaps an immutable buffer) instead of writing the trainer's tensor,
    so the step can tell which parameters the forward moved."""

    __slots__ = ()

    def _set_data(self, new):
        self._data = new


def _as_tensor(x):
    """A torch tensor of an NDArray, tensor or array-like; float64
    becomes float32, as the reference's arrays without x64."""
    if isinstance(x, NDArray):
        t = x._data
    elif torch.is_tensor(x):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    return t.float() if t.dtype == torch.float64 else t


class DataParallelTrainer:
    """Train ``block`` with ``loss_fn`` and an optax-style optimizer in
    one compiled step per call.

    Usage::

        mesh = make_mesh({"dp": -1})
        dpt = DataParallelTrainer(net, loss_fn, "sgd",
                                  {"learning_rate": 0.1}, mesh)
        loss = dpt.step(data_batch, label_batch)
        losses = dpt.run_steps(data_batch, label_batch, steps=K)
        dpt.sync_back()            # trained values into the Parameters

    ``optimizer`` is ``sgd``, ``adam``, ``adamw`` or ``lamb``
    (``_optim.make_rule``); ``grad_clip`` clips by the global norm.
    ``shard_optimizer`` (ZeRO-1) acts only on a data axis of more than
    one device, so on one device it is accepted and does nothing, as in
    the reference."""

    def __init__(self, block, loss_fn, optimizer="sgd",
                 optimizer_params=None, mesh=None, grad_clip=None,
                 amp=False, shard_optimizer=False):
        self.block = block
        self.loss_fn = loss_fn
        self.amp = amp
        self.mesh = mesh if mesh is not None else default_mesh()
        self.device = check_one_device(self.mesh, "DataParallelTrainer")
        self._ctx = Context.of(self.device)
        self.rule = make_rule(optimizer, optimizer_params, grad_clip)
        self._param_objs = list(block.collect_params().values())
        self._eager = False
        self._params = None         # the trainer's values, one per Parameter
        self._opt_state = None
        self._hook = None
        self._zero_grads = {}       # index -> zeros, for unreached params
        self._graphs = GraphCache(self.device)

    # -- parameter values <-> Gluon Parameters -----------------------------
    def _gather_params(self):
        """A copy of every Parameter's value on the mesh's device."""
        vals = [p.data()._data.detach() for p in self._param_objs]
        if self.device.type != "cpu" and any(v.device.type == "cpu"
                                             for v in vals):
            logging.getLogger(__name__).info(
                "DataParallelTrainer: moved host-resident params onto %s "
                "(initialize with ctx=mx.gpu() to avoid the transfer)",
                self.device)
        return [v.to(self.device, copy=True) for v in vals]

    def _state_tensors(self):
        """Every tensor of the trainer's state: the parameter values,
        then the optimizer state."""
        return self._params + [t for s in self._opt_state for t in s]

    def sync(self):
        """Wait until every queued step has run on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def sync_back(self):
        """Write the trained values into the Gluon Parameters."""
        if self._params is None:
            return
        for p, v in zip(self._param_objs, self._params):
            for nd in p._data.values():
                nd._set_data(v.to(nd._data.device))

    # -- the step ----------------------------------------------------------
    def _build(self, d):
        """Resolve deferred shapes, take the parameter values and make
        the optimizer state."""
        if hasattr(self.block, "_resolve_deferred"):
            ctx = self._param_objs[0].list_ctx()[0] if self._param_objs \
                else self._ctx
            self.block._resolve_deferred(NDArray(d.to(ctx.torch_device)))
        self._params = self._gather_params()
        self._opt_state = self.rule.init(self._params)
        if self.amp:
            from ..contrib.amp.amp import _make_hook
            self._hook = _make_hook("bfloat16")

    def _loss(self, leaves, d, l):
        """The forward on ``leaves`` bound to the Parameters: (the mean
        loss, the bound values after the forward)."""
        params = self._param_objs
        saved = [(p, p._data) for p in params]
        prev_hook = _registry._CAST_HOOK
        try:
            if self.amp:
                _registry.set_cast_hook(self._hook)
            bound = [_Bound(t) for t in leaves]
            for p, b in zip(params, bound):
                p._data = OrderedDict({self._ctx: b})
            with torch.enable_grad(), _tracing(), \
                    autograd.record(train_mode=True):
                out = self.block.forward_raw(NDArray(d))
                loss = self.loss_fn(out, NDArray(l))
        finally:
            _registry.set_cast_hook(prev_hook)
            for p, data in saved:
                p._data = data
        with torch.enable_grad():
            return loss._data.float().mean(), bound

    def _step_body(self, d, l):
        """One step on the trainer's state, in place; returns the loss
        (a 0-d device tensor)."""
        params = self._params
        leaves = [p.detach().requires_grad_() for p in params]
        loss, bound = self._loss(leaves, d, l)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else self._zeros(i)
                 for i, g in enumerate(grads)]
        with torch.no_grad():
            self.rule.apply(grads, self._opt_state, params)
            for p, b, leaf in zip(params, bound, leaves):
                if b._data is not leaf:         # mutated in the forward
                    p.copy_(b._data)
        return loss.detach()

    def _zeros(self, i):
        """The zero gradient of a parameter the loss does not reach, made
        once (the rules never write a gradient)."""
        if i not in self._zero_grads:
            self._zero_grads[i] = torch.zeros_like(self._params[i])
        return self._zero_grads[i]

    @contextlib.contextmanager
    def _restored(self):
        """The trainer's state as on entry, again on exit."""
        tensors = self._state_tensors()
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        try:
            yield
        finally:
            with torch.no_grad():
                for t, v in zip(tensors, saved):
                    t.copy_(v)

    def _entry(self, d, l):
        """The batch signature's static inputs and its step over them as
        a :class:`Program` (captured on CUDA)."""
        key = (tuple(d.shape), d.dtype, tuple(l.shape), l.dtype)
        entry = self._graphs.get(key)
        if entry is not None:
            return entry
        dev = self.device
        static_d = torch.empty(d.shape, dtype=d.dtype, device=dev)
        static_l = torch.empty(l.shape, dtype=l.dtype, device=dev)

        def body():
            return self._step_body(static_d, static_l)

        if dev.type == "cuda":
            static_d.copy_(d)
            static_l.copy_(l)
            with self._restored():
                warm_up(body)
        entry = types.SimpleNamespace(
            data=static_d, label=static_l,
            program=Program(body, dev, self._graphs.pool()))
        return self._graphs.put(key, entry)

    def _place(self, x):
        return _as_tensor(x).to(self.device)

    def step(self, data, label):
        """One training step; returns the scalar loss as an NDArray."""
        d, l = self._place(data), self._place(label)
        if self._params is None:
            self._build(d)
        if self._eager:
            return NDArray(self._step_body(d, l))
        entry = self._entry(d, l)
        entry.data.copy_(d)
        entry.label.copy_(l)
        return NDArray(entry.program().clone())

    def run_steps(self, data, label, steps=None):
        """Many training steps in one call; returns the per-step losses
        as an NDArray of shape ``(K,)``.

        * ``steps=None``, superbatch: ``data``/``label`` carry a leading
          ``K`` axis and step ``k`` trains on slice ``k``;
        * ``steps=K``, reuse: the one batch trains every step.

        On CUDA each step is one replay of the captured step."""
        d, l = self._place(data), self._place(label)
        superbatch = steps is None
        if superbatch:
            if d.shape[0] != l.shape[0]:
                raise MXNetError("run_steps: superbatch leading dims "
                                 "disagree: %r vs %r"
                                 % (tuple(d.shape), tuple(l.shape)))
            steps = int(d.shape[0])
        d0, l0 = (d[0], l[0]) if superbatch else (d, l)
        if self._params is None:
            self._build(d0)
        losses = torch.empty(steps, dtype=torch.float32, device=self.device)
        if self._eager:
            for k in range(steps):
                losses[k] = self._step_body(*((d[k], l[k]) if superbatch
                                              else (d, l)))
            return NDArray(losses)
        entry = self._entry(d0, l0)
        if not superbatch:
            entry.data.copy_(d)
            entry.label.copy_(l)
        for k in range(steps):
            if superbatch:
                entry.data.copy_(d[k])
                entry.label.copy_(l[k])
            losses[k] = entry.program()
        return NDArray(losses)
