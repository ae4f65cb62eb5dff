"""``mx.nd.contrib``: the control-flow operators and the ``_contrib_*``
ops under their short names.

Port of ``mxnet_tpu/ndarray/contrib.py``.  The reference lowers
``foreach`` to ``lax.scan``, ``while_loop`` to a masked ``lax.scan``
over ``max_iterations`` and ``cond`` to ``lax.cond``, each one node of
its tape.  Here each construct is a Python loop over a static count of
steps whose body runs through the registry like any other code, so
torch's autograd records it step by step and a hybridized block
captures it into its CUDA graph: no construct reads a value back to the
host, so none depends on the data for its control flow.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops.registry import OpDef, invoke
from .ndarray import NDArray, stack

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    """(list, was_list)."""
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _flag(pred, device):
    """``pred`` (an NDArray of one element, or a bool) as a 0-d boolean
    tensor, outside autograd; a bool is filled on ``device`` (no copy
    from the host, which a CUDA graph capture refuses)."""
    if isinstance(pred, NDArray):
        return pred._data.detach().reshape(()).bool()
    return torch.full((), bool(pred), dtype=torch.bool, device=device)


# the selects keep a gradient for the operand they pass on, as any op
_SELECT = OpDef("_select", lambda m, a, b: torch.where(m, a, b))
_KEEP = OpDef("_keep", lambda m, a: torch.where(m, a, torch.zeros_like(a)))


def _select(flag, a, b):
    return invoke(_SELECT, [flag, a, b])


def foreach(body, data, init_states):
    """``body(data[t], states) -> (outputs, new_states)`` for each ``t``
    along axis 0 of ``data`` (an NDArray or a list of them); returns
    (the outputs stacked on axis 0, the final states), as the reference
    ``foreach``."""
    data_list, data_was_list = _as_list(data)
    states, states_was_list = _as_list(init_states)
    n_states = len(states)
    steps, outs_was_list = [], False
    for t in range(data_list[0].shape[0]):
        x_t = [d[t] for d in data_list]
        outs, new_states = body(x_t if data_was_list else x_t[0],
                                states if states_was_list else states[0])
        outs, outs_was_list = _as_list(outs)
        states, _ = _as_list(new_states)
        if len(states) != n_states:
            raise MXNetError("foreach: body returned %d states, expected %d"
                             % (len(states), n_states))
        steps.append(outs)
    outputs = [stack(*col, axis=0) for col in zip(*steps)]
    return (outputs if outs_was_list else outputs[0],
            states if states_was_list else states[0])


def _while_loop(cond, func, loop_vars, max_iterations):
    """The masked loop of :func:`while_loop`: (outputs, final loop vars,
    was_list, the count of steps taken as a 0-d int64 tensor)."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    lv, was_list = _as_list(loop_vars)
    n_vars = len(lv)
    device = lv[0]._data.device
    alive = torch.ones((), dtype=torch.bool, device=device)
    taken = torch.zeros((), dtype=torch.int64, device=device)
    steps, outs_was_list = [], False
    for _ in range(max_iterations):
        alive = alive & _flag(cond(*lv), device)
        taken = taken + alive
        flag = NDArray(alive)
        outs, new_vars = func(*lv)
        outs, outs_was_list = _as_list(outs)
        new_vars, _ = _as_list(new_vars)
        if len(new_vars) != n_vars:
            raise MXNetError("while_loop: func returned %d loop_vars, "
                             "expected %d" % (len(new_vars), n_vars))
        lv = [_select(flag, nv, v) for nv, v in zip(new_vars, lv)]
        steps.append([invoke(_KEEP, [flag, o]) for o in outs])
    outputs = [stack(*col, axis=0) for col in zip(*steps)]
    return (outputs if outs_was_list else outputs[0], lv, was_list, taken)


def while_loop(cond, func, loop_vars, max_iterations):
    """``while cond(*loop_vars): outputs, loop_vars = func(*loop_vars)``
    (reference ``while_loop``), as the reference lowers it: a loop of
    ``max_iterations`` steps that runs ``func`` at each and keeps its
    results only while every ``cond`` so far held.  Returns (the
    outputs stacked over ``max_iterations`` steps, zeros past the end;
    the final loop vars)."""
    outputs, lv, was_list, _ = _while_loop(cond, func, loop_vars,
                                           max_iterations)
    return outputs, (lv if was_list else lv[0])


def cond(pred, then_func, else_func, inputs=None):
    """``then_func(*inputs) if pred else else_func(*inputs)`` (reference
    ``cond``).  Both branches run and ``torch.where`` selects each
    output by ``pred`` on its device, with no read back to the host, so
    the construct stays capturable; outputs and gradients are
    ``lax.cond``'s, as the unselected branch gets no gradient (a branch
    whose own derivative is infinite where it is not taken, as ``log``
    at 0, still gives NaN there).  The branches must return the same
    shapes and dtypes."""
    in_list, _ = _as_list(inputs if inputs is not None else [])
    a, was_list = _as_list(then_func(*in_list))
    b, _ = _as_list(else_func(*in_list))
    flag = NDArray(_flag(pred, a[0]._data.device))
    out = [_select(flag, x, y) for x, y in zip(a, b)]
    return out if was_list else out[0]


def _populate_contrib():
    """Every ``_contrib_*`` op as ``nd.contrib.<short name>``."""
    from ..ops import registry as _registry
    from .register import _make_stub
    for name in _registry.list_ops():
        if name.startswith("_contrib_"):
            short = name[len("_contrib_"):]
            if short not in globals():
                globals()[short] = _make_stub(_registry.get_op(name))


_populate_contrib()
