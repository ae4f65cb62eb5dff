"""Executor: bound evaluation of a Symbol graph.

Port of ``mxnet_tpu/symbol/executor.py`` (upstream
``src/executor/graph_executor.cc`` and ``python/mxnet/executor.py``):
``arg_dict``, ``grad_dict``, ``aux_dict``, ``grad_req`` (``write``,
``add``, ``null``), ``forward``, ``backward``, ``outputs``,
``copy_params_from`` and ``reshape``, with the reference's lazy training
forward: ``forward(is_train=True)`` only records that a training step is
pending, ``backward`` runs one fused forward and backward, and reading
``outputs`` first runs a forward-only training pass (which moves the
aux states), after which ``backward`` starts again from the aux states
as they were at ``forward``.

The reference compiles its three functions (inference forward, training
forward, forward+backward) with ``jax.jit``.  On the card the port
captures each as a CUDA graph (``_graphs.Program``), keyed by the
arguments' and aux states' shapes and dtypes and by the head gradients'
(``grad_req`` is fixed per executor), and replays it.  A program reads
the executor's own argument, aux and gradient tensors, which every
writer (``forward(**feeds)``, ``copy_params_from``, ``Module``'s
``set_params`` and ``update``) fills in place; before a replay each one
is checked and, where an array was given a new tensor since the
capture, its value is copied into the captured one and the array bound
back to it.  Each program captures into a memory pool of its own, so
replays in any order (the three modes, the buckets of a
``BucketingModule``) never overwrite one another's outputs.  The body
walks the graph (``symbol.eval_graph``) and, for ``backward``, calls
``torch.autograd.grad`` on the differentiable arguments; each
``needs_rng`` node draws from a generator of its own, registered with
the graphs.  With ``out_grads=None`` the head gradient is ones, as in
the reference; ``SoftmaxOutput``'s backward ignores it.  On the CPU the
same code runs the body eagerly; ``_eager = True`` runs it eagerly on
the card too (the comparator of the captured executor), and so does an
executor with ``group2ctx``, as the reference's does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .._graphs import Program, warm_up
from ..base import MXNetError
from ..context import current_context
from ..ndarray.ndarray import NDArray
from .symbol import Symbol, eval_graph

__all__ = ["Executor"]


def _tensor(value):
    """The tensor of an NDArray, a tensor, or a copy of an array-like."""
    if isinstance(value, NDArray):
        return value._data
    if torch.is_tensor(value):
        return value
    return torch.from_numpy(np.array(value, copy=True))


def _assign(arr: NDArray, value):
    """Write ``value`` into ``arr`` in place (its device and dtype kept)
    when the shapes match; a new shape rebinds ``arr`` to a copy on its
    device, as the reference swaps the buffer (never to the caller's
    tensor, which a later write would then change)."""
    like = arr._data
    t = _tensor(value)
    if tuple(t.shape) == tuple(like.shape):
        arr._set_data(t.to(like.device, like.dtype))
    else:
        arr._set_data(t.to(like.device, copy=True))


class Executor:
    def __init__(self, symbol: Symbol, ctx, args, args_grad=None,
                 grad_req: Union[str, Dict[str, str]] = "write",
                 aux_states=None, group2ctx=None):
        from .. import ndarray as nd

        self._sym = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()

        self.arg_dict: Dict[str, NDArray] = self._to_dict(
            args, self.arg_names, "args")
        missing = [n for n in self.arg_names if n not in self.arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)

        self.aux_dict: Dict[str, NDArray] = self._to_dict(
            aux_states or {}, self.aux_names, "aux_states")
        if any(n not in self.aux_dict for n in self.aux_names):
            # allocate the missing ones as zeros of the inferred shapes
            shapes = {k: v.shape for k, v in self.arg_dict.items()}
            _, _, aux_shapes = self._sym.infer_shape(**shapes)
            self.aux_dict = {
                nm: self.aux_dict.get(nm, nd.zeros(s, ctx=self._ctx))
                for nm, s in zip(self.aux_names, aux_shapes)}

        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in self.arg_names}
        else:
            self.grad_req = {n: grad_req.get(n, "null")
                             for n in self.arg_names}

        self.grad_dict: Dict[str, NDArray] = self._to_dict(
            args_grad or {}, self.arg_names, "args_grad")
        for n in self.arg_names:
            if self.grad_req[n] != "null" and n not in self.grad_dict:
                self.grad_dict[n] = NDArray(torch.zeros_like(
                    self.arg_dict[n]._data))

        self._group2ctx = dict(group2ctx or {})
        self._diff_names = [n for n in self.arg_names
                            if self.grad_req[n] != "null"]
        self._outputs: Optional[List[NDArray]] = None
        self._pending = False       # a training forward awaits backward
        self._saved = None          # aux and generators before it ran
        self._eager = False
        self._programs = {}
        # one generator per needs_rng node, seeded from torch's default
        # generator (as the reference draws its key from mx.random)
        n_rng = sum(1 for n in symbol._nodes()
                    if not n.is_var and n.op.needs_rng)
        seed = int(torch.randint(0, 2 ** 62, (1,)).item()) if n_rng else 0
        self._generators = [
            torch.Generator(device=self._device).manual_seed(seed + i)
            for i in range(n_rng)]

    # ------------------------------------------------------------------

    def _to_dict(self, values, names, what) -> Dict[str, NDArray]:
        """NDArrays by name, each on the executor's device (an array
        already there is bound as it is)."""
        if values is None:
            return {}
        if isinstance(values, dict):
            items = list(values.items())
        elif isinstance(values, (list, tuple)):
            if len(values) > len(names):
                raise MXNetError("%s: too many entries" % what)
            items = [(n, v) for n, v in zip(names, values) if v is not None]
        else:
            raise MXNetError("%s must be dict or list" % what)
        out = {}
        for n, v in items:
            if isinstance(v, NDArray) and v._data.device == self._device:
                out[n] = v
            else:
                t = _tensor(v).to(self._device)
                out[n] = NDArray(t.float() if t.dtype == torch.float64
                                 else t)
        return out

    # -- the three bodies ------------------------------------------------

    def _slots(self):
        """The NDArrays a program reads and writes: the arguments, the
        aux states and the differentiable arguments' gradients."""
        return ([self.arg_dict[n] for n in self.arg_names]
                + [self.aux_dict[n] for n in self.aux_names]
                + [self.grad_dict[n] for n in self._diff_names])

    def _body(self, mode, tensors, head_grads):
        """One run of ``mode`` (``infer``, ``train``: the training
        forward, which writes the aux states, or ``fwd_bwd``: the
        training forward and backward, which write the aux states and
        the gradients) on ``tensors`` (in :meth:`_slots` order);
        returns the outputs."""
        n_arg, n_aux = len(self.arg_names), len(self.aux_names)
        args, aux = tensors[:n_arg], tensors[n_arg:n_arg + n_aux]
        grads = tensors[n_arg + n_aux:]
        values = dict(zip(self.arg_names, args))
        values.update(zip(self.aux_names, aux))
        heads = self._sym._outputs
        if mode == "infer":
            with torch.no_grad():
                outs, _ = eval_graph(heads, values, False, self._generators,
                                     self._group2ctx)
            return outs
        if mode == "train":
            with torch.no_grad():
                outs, aux_new = eval_graph(heads, values, True,
                                           self._generators, self._group2ctx)
                self._write_aux(aux, aux_new)
            return outs
        leaves = [values[n].detach().requires_grad_()
                  for n in self._diff_names]
        values.update(zip(self._diff_names, leaves))
        with torch.enable_grad():
            outs, aux_new = eval_graph(heads, values, True, self._generators,
                                       self._group2ctx)
            if head_grads is None:
                head_grads = [torch.ones_like(o) for o in outs]
            pairs = [(o, g) for o, g in zip(outs, head_grads)
                     if o.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], leaves, [g for _, g in pairs],
                allow_unused=True) if pairs and leaves else \
                [None] * len(leaves)
        with torch.no_grad():
            self._write_aux(aux, aux_new)
            for n, tgt, g in zip(self._diff_names, grads, got):
                if g is None:
                    if self.grad_req[n] != "add":
                        tgt.zero_()
                elif self.grad_req[n] == "add":
                    tgt.add_(g)
                else:
                    tgt.copy_(g)
        return [o.detach() for o in outs]

    def _write_aux(self, aux, aux_new):
        for n, t in zip(self.aux_names, aux):
            new = aux_new.get(n)
            if new is not None and new is not t:
                t.copy_(new)

    # -- programs ----------------------------------------------------------

    @contextlib.contextmanager
    def _kept(self, slots):
        """The aux states, the gradients and the generators as on entry,
        again on exit: a warm-up run leaves no trace."""
        n_arg = len(self.arg_names)
        written = [a._data for a in slots[n_arg:]]
        with torch.no_grad():
            values = [t.clone() for t in written]
        states = [g.get_state() for g in self._generators]
        try:
            yield
        finally:
            with torch.no_grad():
                for t, v in zip(written, values):
                    t.copy_(v)
            for g, s in zip(self._generators, states):
                g.set_state(s)

    def _run(self, mode, head_grads=None):
        """The outputs of one run of ``mode``: op by op (``_eager``, the
        CPU, ``group2ctx``), else by the mode's program for this
        signature, captured at its first call."""
        slots = self._slots()
        if self._eager or self._group2ctx:
            return self._body(mode, [a._data for a in slots], head_grads)
        key = (mode, tuple((tuple(a.shape), a._data.dtype) for a in slots),
               None if head_grads is None else
               tuple((tuple(g.shape), g.dtype) for g in head_grads))
        entry = self._programs.get(key)
        if entry is None:
            entry = self._programs[key] = self._capture(mode, slots,
                                                        head_grads)
        else:
            for a, t in zip(slots, entry.tensors):
                if a._data is not t:        # rebound since the capture
                    with torch.no_grad():
                        t.copy_(a._data)
                    a._data = t
        if head_grads is not None:
            for s, g in zip(entry.head_grads, head_grads):
                s.copy_(g)
        outs = entry.program()
        return [o.clone() for o in outs] if entry.program.graph is not None \
            else outs

    def _capture(self, mode, slots, head_grads):
        """The mode's program over the current tensors, with static head
        gradients; on the card one warm-up run first (on a side stream,
        its writes undone), then the capture into a pool of its own."""
        tensors = [a._data for a in slots]
        static = None if head_grads is None else \
            [g.detach().clone() for g in head_grads]

        def body():
            return self._body(mode, tensors, static)

        if self._device.type == "cuda":
            with self._kept(slots):
                warm_up(body)
        return _Entry(tensors, static,
                      Program(body, self._device, pool=None,
                              generators=self._generators))

    # ------------------------------------------------------------------

    @property
    def outputs(self) -> List[NDArray]:
        if self._outputs is None and self._pending:
            self._run_forward_only()
        return self._outputs or []

    def forward(self, is_train: bool = False, **kwargs) -> List[NDArray]:
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            _assign(self.arg_dict[k], v)
        self._saved = None
        if is_train:
            # lazy: backward() runs one fused forward and backward
            self._pending = True
            self._outputs = None
            return _LazyOutputs(self)
        self._pending = False
        self._outputs = [NDArray(o) for o in self._run("infer")]
        return self._outputs

    def _run_forward_only(self):
        """The training forward, for outputs read before ``backward``;
        the aux states and generators it moves are kept as they were,
        for ``backward`` to start again from."""
        with torch.no_grad():
            self._saved = ([self.aux_dict[n]._data.clone()
                            for n in self.aux_names],
                           [g.get_state() for g in self._generators])
        self._outputs = [NDArray(o) for o in self._run("train")]

    def backward(self, out_grads=None):
        if not self._pending:
            raise MXNetError("backward called before forward(is_train=True)")
        if self._saved is not None:
            aux, states = self._saved
            with torch.no_grad():
                for n, v in zip(self.aux_names, aux):
                    self.aux_dict[n]._data.copy_(v)
            for g, s in zip(self._generators, states):
                g.set_state(s)
            self._saved = None
        og = None
        if out_grads is not None:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            og = [_tensor(g).to(self._device) for g in out_grads]
        self._outputs = [NDArray(o) for o in self._run("fwd_bwd", og)]
        self._pending = False

    # ------------------------------------------------------------------

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                _assign(self.arg_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError("unknown parameter %r" % k)
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                _assign(self.aux_dict[k], v)
            elif not allow_extra_params:
                raise MXNetError("unknown aux state %r" % k)

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """Rebind with new input shapes: the arrays whose shape changes
        are allocated again (zeros, on the executor's device); the
        programs are keyed by shape, so each shape captures its own."""
        shapes = {k: v.shape for k, v in self.arg_dict.items()}
        shapes.update(kwargs)
        arg_shapes, _, aux_shapes = self._sym.infer_shape(**shapes)

        def zeros(s, like):
            return NDArray(torch.zeros(s, dtype=like._data.dtype,
                                       device=self._device))

        for n, s in zip(self.arg_names, arg_shapes):
            if tuple(self.arg_dict[n].shape) != tuple(s):
                self.arg_dict[n] = zeros(s, self.arg_dict[n])
                if n in self.grad_dict:
                    self.grad_dict[n] = zeros(s, self.grad_dict[n])
        for n, s in zip(self.aux_names, aux_shapes):
            if tuple(self.aux_dict[n].shape) != tuple(s):
                self.aux_dict[n] = zeros(s, self.aux_dict[n])
        return self


class _Entry:
    """A captured mode: the tensors it reads and writes, its static head
    gradients and its program."""

    __slots__ = ("tensors", "head_grads", "program")

    def __init__(self, tensors, head_grads, program):
        self.tensors = tensors
        self.head_grads = head_grads
        self.program = program


class _LazyOutputs(list):
    """List-like placeholder returned by forward(is_train=True): touching it
    forces the forward computation (otherwise backward() runs one fused
    forward+backward)."""

    def __init__(self, exe: Executor):
        super().__init__()
        self._exe = exe

    def _force(self):
        outs = self._exe.outputs
        if not list.__len__(self):
            self.extend(outs)
        return outs

    def __len__(self):
        return len(self._force())

    def __getitem__(self, i):
        return self._force()[i]

    def __iter__(self):
        return iter(self._force())
