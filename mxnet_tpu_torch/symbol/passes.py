"""Graph optimization passes over the Symbol IR.

Port of ``mxnet_tpu/symbol/passes.py`` (upstream: the nnvm pass
machinery and the subgraph API, ``eliminate_common_expr_pass.cc``,
``SubgraphProperty``, ``Symbol.optimize_for``).  They matter for (a)
inference-time *param* rewrites (conv+BN folding changes the
checkpoint), and (b) shrinking the graph before it is captured.

``register_pass`` is the extension point (usable from
``mx.library.load``-ed extensions, mirroring ``lib_api.h`` partitioner
registration).
"""
from __future__ import annotations

from typing import Dict

import numpy as _np

from .. import ndarray as nd
from ..base import MXNetError
from ..context import cpu

__all__ = ["register_pass", "list_passes", "apply_pass",
           "fold_conv_bn", "eliminate_common_expr"]

_PASSES = {}


def register_pass(name):
    """Register ``fn(sym, arg_params, aux_params, **kw) -> (sym, args,
    aux)`` as a named graph pass."""
    def dec(fn):
        _PASSES[name] = fn
        return fn
    return dec


def list_passes():
    return sorted(_PASSES)


def apply_pass(sym, name, arg_params=None, aux_params=None, **kw):
    if name not in _PASSES:
        raise MXNetError("unknown graph pass %r; have %s"
                         % (name, list_passes()))
    return _PASSES[name](sym, dict(arg_params or {}),
                         dict(aux_params or {}), **kw)


def _rebuild(sym, replace):
    """Rebuild a Symbol applying ``replace``: id(node) -> node'
    substitution (consumers keep their output index)."""
    from .symbol import Symbol, _Node

    memo = {}

    def go(node):
        if id(node) in memo:
            return memo[id(node)]
        if id(node) in replace:
            new = go(replace[id(node)])
            memo[id(node)] = new
            return new
        if node.is_var:
            memo[id(node)] = node
            return node
        new_inputs = [(go(inp), oi) for (inp, oi) in node.inputs]
        new = _Node(node.op, node.name, new_inputs, node.pos_attrs,
                    node.attrs, node.user_attrs)
        memo[id(node)] = new
        return new

    return Symbol([(go(n), i) for (n, i) in sym._outputs])


@register_pass("fold_conv_bn")
def fold_conv_bn(sym, arg_params, aux_params, eps_default=1e-3, **kw):
    """Fold inference-mode BatchNorm into the preceding Convolution's
    weight/bias (reference: the oneDNN/TensorRT subgraph fusers do this
    below the C ABI).  Rewrites BOTH the graph and the params; returns
    (sym, arg_params, aux_params) with the BN params consumed.
    """
    from .symbol import _Node

    def p(name):
        if name in arg_params:
            return arg_params[name].asnumpy() \
                if hasattr(arg_params[name], "asnumpy") \
                else _np.asarray(arg_params[name])
        if name in aux_params:
            return aux_params[name].asnumpy() \
                if hasattr(aux_params[name], "asnumpy") \
                else _np.asarray(aux_params[name])
        return None

    replace = {}
    order = sym._nodes()
    conv_consumers: Dict[int, int] = {}
    for n in order:
        for (inp, oi) in n.inputs:
            if not inp.is_var:
                conv_consumers[id(inp)] = conv_consumers.get(
                    id(inp), 0) + 1

    for node in order:
        if node.is_var or node.op.name != "BatchNorm":
            continue
        if int(node.attrs.get("axis", 1)) != 1:
            # folding assumes channel-axis stats matching the conv's
            # output-filter dim; other axes would fold wrong silently
            continue
        data, oi = node.inputs[0]
        if (data.is_var or data.op.name != "Convolution" or oi != 0
                or conv_consumers.get(id(data), 0) != 1):
            continue
        names = [inp.name for (inp, _) in node.inputs[1:5]]
        gamma, beta, mean, var = (p(nm) for nm in names)
        if any(v is None for v in (gamma, beta, mean, var)):
            continue
        if node.attrs.get("fix_gamma", True):
            gamma = _np.ones_like(gamma)
        eps = float(node.attrs.get("eps", eps_default))

        wname = data.inputs[1][0].name
        w = p(wname)
        if w is None:
            continue
        no_bias = bool(data.attrs.get("no_bias", False))
        bname = None if no_bias else data.inputs[2][0].name
        b = _np.zeros(w.shape[0], w.dtype) if no_bias else p(bname)
        if b is None:
            continue

        std = _np.sqrt(var + eps)
        scale = gamma / std
        new_w = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
        new_b = beta + (b - mean) * scale

        fw_name = data.name + "_bnfold_weight"
        fb_name = data.name + "_bnfold_bias"
        # the folded params live where the conv's weight lived (the CPU
        # for a host array)
        ctx = getattr(arg_params[wname], "context", cpu())
        arg_params[fw_name] = nd.array(new_w, ctx=ctx)
        arg_params[fb_name] = nd.array(new_b, ctx=ctx)

        attrs = dict(data.attrs)
        attrs["no_bias"] = False
        new_conv = _Node(data.op, data.name + "_bnfold",
                         [data.inputs[0],
                          (_Node(None, fw_name), 0),
                          (_Node(None, fb_name), 0)],
                         data.pos_attrs, attrs, data.user_attrs)
        replace[id(node)] = new_conv

    if not replace:
        return sym, arg_params, aux_params
    new_sym = _rebuild(sym, replace)
    used = {n.name for n in new_sym._nodes() if n.is_var}
    arg_params = {k: v for k, v in arg_params.items()
                  if k in used}
    aux_params = {k: v for k, v in aux_params.items() if k in used}
    return new_sym, arg_params, aux_params


@register_pass("eliminate_common_expr")
def eliminate_common_expr(sym, arg_params, aux_params, **kw):
    """Deduplicate structurally-identical pure subexpressions
    (reference: ``src/executor/eliminate_common_expr_pass.cc``).
    Stateful ops (RNG, mutation, training-aware) are never merged."""
    canon: Dict[tuple, object] = {}
    replace = {}

    for node in sym._nodes():
        if node.is_var:
            continue
        op = node.op
        if op.needs_rng or getattr(op, "training_aware", False):
            continue
        mut = node.mutate_indices()
        if mut:
            continue
        key = (op.name,
               tuple((id(replace.get(id(i), i)), oi)
                     for (i, oi) in node.inputs),
               repr(node.pos_attrs),
               tuple(sorted((k, repr(v))
                            for k, v in node.attrs.items())))
        if key in canon:
            replace[id(node)] = canon[key]
        else:
            canon[key] = node

    if not replace:
        return sym, arg_params, aux_params
    return _rebuild(sym, replace), arg_params, aux_params
