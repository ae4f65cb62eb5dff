"""``mx.operator``: user-defined operators in Python (CustomOp).

Port of ``mxnet_tpu/operator.py`` (upstream ``python/mxnet/operator.py``
and ``src/operator/custom/custom.cc``): users subclass ``CustomOpProp``
(arguments, outputs, shape and type inference, and the creation of the
runtime op) and ``CustomOp`` (imperative ``forward`` / ``backward`` that
write their results through ``assign``), register the prop under a name
and call ``nd.Custom(..., op_type=name)``.

Where the reference wraps the user's functions in ``jax.custom_vjp``,
the port uses a ``torch.autograd.Function``: its forward runs the user's
``forward`` with recording paused into zero-filled outputs, and its
backward runs the user's ``backward`` into zero-filled input gradients
(auxiliary states get zero gradients).  Every array the user's code
gets is dense (contiguous), as MXNet's are, so a kernel may take its
pointer.  ``create_operator`` receives the
inputs' :class:`~mxnet_tpu_torch.context.Context` (the reference passes
``None``): an ``rtc`` kernel launched from ``forward`` or ``backward``
needs it.  ``forward`` gets ``is_train`` as it was when the op was
called (the reference reads it after pausing, where it is always
False).
"""
from __future__ import annotations

from typing import Dict, List, Type

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_PROPS: Dict[str, Type["CustomOpProp"]] = {}


class CustomOp:
    """Base class of the runtime operator (reference
    ``mx.operator.CustomOp``)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request says: ``null``
        skips, ``add`` adds, ``write`` / ``inplace`` overwrite."""
        if req == "null":
            return
        if req == "add":
            dst[:] = dst + src
        else:
            dst[:] = src


class CustomOpProp:
    """Operator properties: names, shapes, types and op creation
    (reference ``mx.operator.CustomOpProp``)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Class decorator registering a ``CustomOpProp`` under ``reg_name``
    (reference ``mx.operator.register``)."""
    def _wrap(prop_cls):
        if not (isinstance(prop_cls, type)
                and issubclass(prop_cls, CustomOpProp)):
            raise MXNetError("register(%r): expected a CustomOpProp "
                             "subclass" % reg_name)
        _PROPS[reg_name] = prop_cls
        return prop_cls
    return _wrap


def get_all_registered_operators() -> List[str]:
    return sorted(_PROPS)


def _get_prop(op_type, attrs) -> CustomOpProp:
    if op_type not in _PROPS:
        raise MXNetError(
            "Custom: op_type %r is not registered (have: %s)"
            % (op_type, ", ".join(sorted(_PROPS)) or "<none>"))
    return _PROPS[op_type](**attrs)


class _CustomFunction(torch.autograd.Function):
    """The user's ``forward`` and ``backward`` as one autograd node."""

    @staticmethod
    def forward(ctx, spec, *raw):
        from . import autograd
        from .ndarray.ndarray import NDArray, zeros
        op, n_args, out_shapes, out_types, context, is_train = spec
        in_nd = [NDArray(t.contiguous()) for t in raw[:n_args]]
        aux_nd = [NDArray(t) for t in raw[n_args:]]
        out_nd = [zeros(s, ctx=context, dtype=t)
                  for s, t in zip(out_shapes, out_types)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train=is_train, req=["write"] * len(out_nd),
                       in_data=in_nd, out_data=out_nd, aux=aux_nd)
        outs = tuple(o._data for o in out_nd)
        ctx.spec = spec
        ctx.save_for_backward(*raw, *outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        from . import autograd
        from .ndarray.ndarray import NDArray
        op, n_args, _, _, _, _ = ctx.spec
        saved = ctx.saved_tensors
        n_in = len(saved) - len(grads)
        raw, outs = saved[:n_in], saved[n_in:]
        in_nd = [NDArray(t.contiguous()) for t in raw[:n_args]]
        in_grad = [NDArray(torch.zeros_like(t, memory_format=torch
                                            .contiguous_format))
                   for t in raw[:n_args]]
        with autograd.pause():
            op.backward(req=["write"] * n_args,
                        out_grad=[NDArray(g.contiguous()) for g in grads],
                        in_data=in_nd, out_data=[NDArray(o) for o in outs],
                        in_grad=in_grad,
                        aux=[NDArray(t) for t in raw[n_args:]])
        return (None,) + tuple(g._data for g in in_grad) + tuple(
            torch.zeros_like(t) for t in raw[n_args:])


def _custom_impl(*arrays, op_type=None, **attrs):
    """Registry impl behind ``nd.Custom``: the torch tensors of the
    arguments and auxiliary states, in the prop's order."""
    from . import autograd
    from .context import Context
    from .ndarray.ndarray import NDArray

    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    prop = _get_prop(op_type, attrs)
    n_args = len(prop.list_arguments())
    n_out = len(prop.list_outputs())
    n_aux = len(prop.list_auxiliary_states())
    if len(arrays) != n_args + n_aux:
        raise MXNetError(
            "Custom(%s): expected %d arguments + %d aux states, got %d "
            "inputs" % (op_type, n_args, n_aux, len(arrays)))
    in_shapes = [tuple(a.shape) for a in arrays[:n_args]]
    _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
    in_types = [NDArray(a).dtype for a in arrays[:n_args]]
    _, out_types, _ = prop.infer_type(list(in_types))
    context = Context.of(arrays[0].device)
    op = prop.create_operator(context, in_shapes, in_types)
    spec = (op, n_args, [tuple(s) for s in out_shapes],
            list(out_types), context, autograd.is_training())
    outs = _CustomFunction.apply(spec, *arrays)
    return outs[0] if n_out == 1 else tuple(outs)


def _register_custom_op():
    from .ops.registry import register as _reg

    @_reg("Custom", num_outputs=-1)
    def Custom(*arrays, op_type=None, **attrs):  # noqa: N802
        """User-defined Python operator (reference:
        ``src/operator/custom/custom.cc``).  See ``mx.operator``."""
        return _custom_impl(*arrays, op_type=op_type, **attrs)


_register_custom_op()
