"""Symbol: the lazy graph-building API.

Port of ``mxnet_tpu/symbol/symbol.py`` (upstream ``python/mxnet/symbol/``
and the nnvm graph IR).  A Symbol is a small DAG over the same op
registry that serves the imperative ``nd`` namespace.  There is no
separate inference pass: ``infer_shape``/``infer_type`` run the op impls
on ``device="meta"`` tensors (the reference runs them under
``jax.eval_shape``), with the reference's per-op table back-inferring
parameter shapes (weight, bias, gamma, ...) from the data's, which is
what lets ``simple_bind`` allocate parameters.  The JSON of
``tojson``/``save`` is the reference's, so either package loads the
other's ``-symbol.json``.

:func:`eval_graph` walks the graph on tensors, one op at a time through
``registry.invoke_impl``; the bound :class:`~.executor.Executor` runs it
and, on the card, replays it as a CUDA graph.
"""
from __future__ import annotations

import inspect
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from ..context import current_context
from ..ops import registry as _registry

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "eval_graph", "torch_dtype", "dtype_name"]


# ---------------------------------------------------------------------------
# Naming
# ---------------------------------------------------------------------------

class _SymNameManager:
    """Delegates to the active ``mx.name`` scope (reference:
    ``NameManager.current``) so ``with mx.name.Prefix('p_'):`` affects
    symbol auto-naming."""

    def get(self, name, hint):
        from .. import name as _name
        return _name.current().get(name, hint)


_NM = _SymNameManager()


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a torch dtype, a numpy dtype or a name
    (``"bfloat16"`` included, which numpy lacks)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype)
    if isinstance(getattr(torch, name, None), torch.dtype):
        return getattr(torch, name)
    return torch.from_numpy(_np.zeros(0, _np.dtype(dtype))).dtype


def dtype_name(dtype) -> str:
    """``"float32"``-style name of any dtype :func:`torch_dtype` takes."""
    return str(torch_dtype(dtype)).split(".")[-1]


def _np_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype, as ``NDArray.dtype`` answers
    (bfloat16, which numpy lacks, as ``NDArray.dtype``'s stand-in)."""
    from ..ndarray.ndarray import _BF16, _NP_OF
    if dtype in _NP_OF:
        return _np.dtype(_NP_OF[dtype])
    return _BF16 if dtype == torch.bfloat16 else dtype


# ---------------------------------------------------------------------------
# Per-op metadata tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------

# Array-input slot names for parameterized ops: missing trailing slots are
# auto-created as Variables named "<node>_<slot>" (reference behavior: nnvm
# Symbol composition auto-creates variable nodes for unfilled inputs).
_ARRAY_SLOTS: Dict[str, List[str]] = {
    "FullyConnected": ["data", "weight", "bias"],
    "Convolution": ["data", "weight", "bias"],
    "Deconvolution": ["data", "weight", "bias"],
    "BatchNorm": ["data", "gamma", "beta", "moving_mean", "moving_var"],
    "LayerNorm": ["data", "gamma", "beta"],
    "InstanceNorm": ["data", "gamma", "beta"],
    "GroupNorm": ["data", "gamma", "beta"],
    "L2Normalization": ["data"],
    "Embedding": ["data", "weight"],
    "SoftmaxOutput": ["data", "label"],
    "LinearRegressionOutput": ["data", "label"],
    "LogisticRegressionOutput": ["data", "label"],
    "MAERegressionOutput": ["data", "label"],
    "RNN": ["data", "parameters", "state", "state_cell"],
}

# MXNet names the auto-created label of an output op "<name>_label", except
# the canonical "softmax" head whose label is "softmax_label".
_OUTPUT_OPS = {"SoftmaxOutput", "LinearRegressionOutput",
               "LogisticRegressionOutput", "MAERegressionOutput"}


def _slot_skipped(op_name: str, slot: str, attrs: Dict[str, Any]) -> bool:
    """True if an optional array slot is disabled by attrs."""
    if slot == "bias" and attrs.get("no_bias", False):
        return True
    if slot == "state_cell" and attrs.get("mode", "lstm") != "lstm":
        return True
    return False


def _resolve_num_outputs(op, n_inputs: int, pos_attrs, attrs) -> int:
    if op.num_outputs != -1:
        return op.num_outputs
    name = op.name
    if name in ("split", "SliceChannel"):
        return int(attrs.get("num_outputs",
                             pos_attrs[0] if pos_attrs else 1))
    if name == "split_v2":
        ios = attrs.get("indices_or_sections",
                        pos_attrs[0] if pos_attrs else 1)
        if isinstance(ios, int):
            return ios
        return len(tuple(ios)) + 1
    if name == "RNN":
        if attrs.get("state_outputs", False):
            return 3 if attrs.get("mode", "lstm") == "lstm" else 2
        return 1
    if name == "topk":
        return 2 if attrs.get("ret_typ", "indices") == "both" else 1
    if name == "amp_multicast":
        return n_inputs
    if name == "Custom":
        from ..operator import _get_prop
        a = dict(attrs)
        op_type = a.pop("op_type", None)
        return len(_get_prop(op_type, a).list_outputs())
    raise MXNetError(
        "Cannot statically resolve output count for op %r in symbolic "
        "mode" % name)


def _prod(xs):
    r = 1
    for x in xs:
        r *= int(x)
    return r


def _hint_shapes(op_name: str, known: Dict[int, Tuple[int, ...]],
                 slot_names: List[str], attrs: Dict[str, Any]
                 ) -> Dict[int, Tuple[int, ...]]:
    """Given known input shapes (by slot index), return shapes for the
    remaining parameter slots (the reference's ``FInferShape``
    back-inference for parameterized layers)."""
    out: Dict[int, Tuple[int, ...]] = {}
    data = known.get(0)
    if data is None:
        return out

    def setslot(slot, shape):
        if slot in slot_names:
            out[slot_names.index(slot)] = tuple(int(s) for s in shape)

    if op_name == "FullyConnected":
        nh = int(attrs["num_hidden"])
        flatten = attrs.get("flatten", True)
        in_units = _prod(data[1:]) if flatten else int(data[-1])
        setslot("weight", (nh, in_units))
        setslot("bias", (nh,))
    elif op_name == "Convolution":
        nf = int(attrs["num_filter"])
        kernel = tuple(attrs["kernel"])
        ng = int(attrs.get("num_group", 1))
        setslot("weight", (nf, int(data[1]) // ng) + kernel)
        setslot("bias", (nf,))
    elif op_name == "Deconvolution":
        nf = int(attrs["num_filter"])
        kernel = tuple(attrs["kernel"])
        ng = int(attrs.get("num_group", 1))
        setslot("weight", (int(data[1]), nf // ng) + kernel)
        setslot("bias", (nf,))
    elif op_name in ("BatchNorm", "InstanceNorm", "GroupNorm"):
        axis = int(attrs.get("axis", 1))
        c = int(data[axis])
        for s in ("gamma", "beta", "moving_mean", "moving_var"):
            setslot(s, (c,))
    elif op_name == "LayerNorm":
        axis = int(attrs.get("axis", -1))
        c = int(data[axis])
        setslot("gamma", (c,))
        setslot("beta", (c,))
    elif op_name == "Embedding":
        setslot("weight", (int(attrs["input_dim"]),
                           int(attrs["output_dim"])))
    elif op_name == "SoftmaxOutput":
        if attrs.get("multi_output", False):
            setslot("label", (data[0],) + tuple(data[2:]))
        else:
            setslot("label", tuple(data[:-1]))
    elif op_name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput"):
        setslot("label", tuple(data))
    return out


# ---------------------------------------------------------------------------
# Graph nodes
# ---------------------------------------------------------------------------

class _Node:
    """One graph node: a variable (op is None) or an op application."""

    __slots__ = ("op", "name", "inputs", "pos_attrs", "attrs", "user_attrs",
                 "num_outputs")

    def __init__(self, op, name, inputs=(), pos_attrs=(), attrs=None,
                 user_attrs=None):
        self.op = op                    # OpDef | None
        self.name = name
        self.inputs = list(inputs)      # [(node, out_idx)]
        self.pos_attrs = tuple(pos_attrs)
        self.attrs = dict(attrs or {})
        self.user_attrs = dict(user_attrs or {})
        if op is None:
            self.num_outputs = 1
        else:
            self.num_outputs = _resolve_num_outputs(
                op, len(self.inputs), self.pos_attrs, self.attrs)

    @property
    def is_var(self):
        return self.op is None

    def mutate_indices(self):
        if self.op is None:
            return ()
        m = self.op.mutate
        return m(self.attrs) if callable(m) else m


def _topo_order(heads: Sequence[Tuple[_Node, int]]) -> List[_Node]:
    order: List[_Node] = []
    seen = set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for (inp, _) in node.inputs:
            visit(inp)
        order.append(node)

    for (n, _) in heads:
        visit(n)
    return order


# ---------------------------------------------------------------------------
# Symbol
# ---------------------------------------------------------------------------

class Symbol:
    """An immutable handle on one or more outputs of the graph."""

    def __init__(self, outputs: Sequence[Tuple[_Node, int]]):
        self._outputs: List[Tuple[_Node, int]] = list(outputs)

    # -- introspection ----------------------------------------------------

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def _nodes(self) -> List[_Node]:
        return _topo_order(self._outputs)

    def _var_nodes(self) -> List[_Node]:
        return [n for n in self._nodes() if n.is_var]

    def _aux_var_names(self) -> List[str]:
        aux = []
        for n in self._nodes():
            for idx in n.mutate_indices():
                if idx < len(n.inputs) and n.inputs[idx][0].is_var:
                    nm = n.inputs[idx][0].name
                    if nm not in aux:
                        aux.append(nm)
        return aux

    def list_arguments(self) -> List[str]:
        aux = set(self._aux_var_names())
        return [n.name for n in self._var_nodes() if n.name not in aux]

    def list_auxiliary_states(self) -> List[str]:
        return self._aux_var_names()

    def list_outputs(self) -> List[str]:
        names = []
        for (n, i) in self._outputs:
            if n.num_outputs == 1:
                names.append(n.name + "_output")
            else:
                names.append("%s_output%d" % (n.name, i))
        return names

    def get_internals(self) -> "Symbol":
        outs = []
        for n in self._nodes():
            for i in range(n.num_outputs):
                outs.append((n, i))
        return Symbol(outs)

    def list_attr(self):
        if len(self._outputs) != 1:
            raise MXNetError("list_attr on multi-output symbol")
        return dict(self._outputs[0][0].user_attrs)

    def attr(self, key):
        return self._outputs[0][0].user_attrs.get(key)

    def _set_attr(self, **kwargs):
        self._outputs[0][0].user_attrs.update(
            {k: str(v) for k, v in kwargs.items()})

    def __getitem__(self, index):
        if isinstance(index, str):
            idx = self.list_outputs().index(index)
            return Symbol([self._outputs[idx]])
        if isinstance(index, slice):
            return Symbol(self._outputs[index])
        if len(self._outputs) == 1 and self._outputs[0][0].num_outputs > 1:
            node = self._outputs[0][0]
            if index >= node.num_outputs:
                raise IndexError(index)
            return Symbol([(node, index)])
        return Symbol([self._outputs[index]])

    def __len__(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].num_outputs
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "<Symbol %s>" % (self.name or
                                ",".join(self.list_outputs()))

    # -- composition ------------------------------------------------------

    def __call__(self, **kwargs):
        """Compose: replace named variables with the given symbols."""
        mapping = {}
        for k, v in kwargs.items():
            if not isinstance(v, Symbol):
                raise MXNetError("compose expects Symbols")
            mapping[k] = v._outputs[0]
        memo: Dict[int, _Node] = {}

        def rebuild(node: _Node) -> _Node:
            if id(node) in memo:
                return memo[id(node)]
            if node.is_var:
                new = node
            else:
                new_inputs = []
                for (inp, oi) in node.inputs:
                    if inp.is_var and inp.name in mapping:
                        new_inputs.append(mapping[inp.name])
                    else:
                        new_inputs.append((rebuild(inp), oi))
                new = _Node(node.op, node.name, new_inputs, node.pos_attrs,
                            node.attrs, node.user_attrs)
            memo[id(node)] = new
            return new

        return Symbol([(rebuild(n), i) for (n, i) in self._outputs])

    # -- arithmetic sugar -------------------------------------------------

    def _binop(self, other, op_name, scalar_op):
        if isinstance(other, Symbol):
            return _apply_op(op_name, [self, other], {})
        return _apply_op(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return _apply_op("_rminus_scalar", [self], {"scalar": float(o)})

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return _apply_op("_rdiv_scalar", [self], {"scalar": float(o)})

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __neg__(self):
        return _apply_op("negative", [self], {})

    # -- inference --------------------------------------------------------

    def infer_shape(self, *args, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes) in the order of
        ``list_arguments()`` / ``list_outputs()`` / ``list_auxiliary_states``.
        Unknown parameter shapes are back-inferred per op (the hints
        table)."""
        arg_names = self.list_arguments()
        known: Dict[str, Tuple[int, ...]] = {}
        if args:
            for n, s in zip(arg_names, args):
                if s is not None:
                    known[n] = tuple(s)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        structs = self._infer_structs(known, {})
        if structs is None:
            return None, None, None
        var_structs, out_structs = structs
        aux_names = self.list_auxiliary_states()
        return ([tuple(var_structs[n].shape) for n in arg_names],
                [tuple(s.shape) for s in out_structs],
                [tuple(var_structs[n].shape) for n in aux_names])

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except MXNetError:
            return None, None, None

    def infer_type(self, **kwargs):
        arg_names = self.list_arguments()
        structs = self._infer_structs({}, kwargs, shapes_opt=True)
        if structs is None:
            return None, None, None
        var_structs, out_structs = structs
        aux_names = self.list_auxiliary_states()
        return ([_np_dtype(var_structs[n].dtype) for n in arg_names],
                [_np_dtype(s.dtype) for s in out_structs],
                [_np_dtype(var_structs[n].dtype) for n in aux_names])

    def _infer_structs(self, known_shapes: Dict[str, Tuple[int, ...]],
                       known_dtypes: Dict[str, Any], shapes_opt=False):
        """Core inference: the graph run on ``meta`` tensors, the hints
        table back-filling parameter shapes.  Returns ({var_name: meta
        tensor}, [output meta tensors])."""
        order = self._nodes()
        var_structs: Dict[str, torch.Tensor] = {}
        vals: Dict[Tuple[int, int], torch.Tensor] = {}

        def meta(shape, dtype):
            return torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device="meta")

        # seed known variables; "__shape__" user attrs count as known
        for n in order:
            if not n.is_var:
                continue
            shape = known_shapes.get(n.name)
            if shape is None and "__shape__" in n.user_attrs:
                shape = tuple(json.loads(n.user_attrs["__shape__"]))
            dtype = known_dtypes.get(
                n.name, n.user_attrs.get("__dtype__", "float32"))
            if shape is not None:
                var_structs[n.name] = meta(shape, dtype)

        for n in order:
            if n.is_var:
                if n.name in var_structs:
                    vals[(id(n), 0)] = var_structs[n.name]
                continue
            slot_names = _ARRAY_SLOTS.get(n.op.name, [])
            # back-infer unresolved variable inputs from resolved ones
            known_slots = {}
            for i, (inp, oi) in enumerate(n.inputs):
                v = vals.get((id(inp), oi))
                if v is not None:
                    known_slots[i] = tuple(v.shape)
            missing = [i for i, (inp, oi) in enumerate(n.inputs)
                       if (id(inp), oi) not in vals]
            if missing:
                hints = _hint_shapes(n.op.name, known_slots, slot_names,
                                     n.attrs)
                for i in missing:
                    inp, oi = n.inputs[i]
                    if inp.is_var and i in hints:
                        dtype = known_dtypes.get(
                            inp.name,
                            inp.user_attrs.get("__dtype__", "float32"))
                        st = meta(hints[i], dtype)
                        var_structs[inp.name] = st
                        vals[(id(inp), 0)] = st
                still = [n.inputs[i][0].name for i in missing
                         if (id(n.inputs[i][0]), n.inputs[i][1]) not in vals]
                if still:
                    if shapes_opt:
                        return None
                    raise MXNetError(
                        "infer_shape: cannot resolve shapes for %s "
                        "(inputs of %s); provide them explicitly"
                        % (still, n.name))
            in_structs = [vals[(id(inp), oi)] for (inp, oi) in n.inputs]
            out_structs = _eval_node_abstract(n, in_structs)
            for i, s in enumerate(out_structs):
                vals[(id(n), i)] = s

        return var_structs, [vals[(id(n), i)] for (n, i) in self._outputs]

    # -- serialization ----------------------------------------------------

    def tojson(self) -> str:
        """The reference's graph JSON (its ``framework`` tag included),
        so a file written by either package loads in the other."""
        order = self._nodes()
        nid = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "attrs": {k: json.dumps(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(inp)], oi, 0] for (inp, oi) in n.inputs],
            }
            if n.pos_attrs:
                entry["attrs"]["__pos_attrs__"] = json.dumps(
                    list(n.pos_attrs))
            if n.user_attrs:
                entry["user_attrs"] = dict(n.user_attrs)
            nodes.append(entry)
        graph = {
            "nodes": nodes,
            "arg_nodes": [i for i, n in enumerate(order) if n.is_var],
            "heads": [[nid[id(n)], i, 0] for (n, i) in self._outputs],
            "attrs": {"mxnet_version": ["int", 10900],
                      "framework": ["str", "mxnet_tpu"]},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def optimize_for(self, backend, args=None, aux=None, **kwargs):
        """Apply a named graph pass or the ``"default"`` recipe (CSE,
        then conv/BN folding); returns ``(sym, arg_params, aux_params)``
        (reference ``Symbol.optimize_for``)."""
        from . import passes
        names = ([backend] if backend != "default"
                 else ["eliminate_common_expr", "fold_conv_bn"])
        sym, args, aux = self, dict(args or {}), dict(aux or {})
        for name in names:
            sym, args, aux = passes.apply_pass(sym, name, args, aux,
                                               **kwargs)
        return sym, args, aux

    # -- binding ----------------------------------------------------------

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, **kwargs):
        return self._bind(ctx, args, args_grad=args_grad, grad_req=grad_req,
                          aux_states=aux_states, group2ctx=group2ctx)

    def _bind(self, ctx, args, args_grad=None, grad_req="write",
              aux_states=None, group2ctx=None):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, **shapes):
        """Infer every shape from the given input shapes and allocate
        argument, gradient and aux arrays (zeros: initialization is the
        caller's job, as in the reference) on ``ctx``, by default the
        current context (the card; raises without one)."""
        from .. import ndarray as nd
        from .executor import Executor
        ctx = ctx if ctx is not None else current_context()
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("simple_bind: shape inference incomplete")
        type_dict = type_dict or {}
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        args = {n: nd.zeros(s, ctx=ctx,
                            dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)}
        aux = {n: nd.zeros(s, ctx=ctx)
               for n, s in zip(aux_names, aux_shapes)}
        grads = None
        if grad_req != "null":
            grads = {n: nd.zeros(s, ctx=ctx)
                     for n, s in zip(arg_names, arg_shapes)}
        return Executor(self, ctx, args, args_grad=grads, grad_req=grad_req,
                        aux_states=aux, group2ctx=group2ctx)

    # -- eval (imperative convenience) ------------------------------------

    def eval(self, ctx=None, **kwargs):
        exe = self._bind(ctx, kwargs, grad_req="null")
        return exe.forward(is_train=False)


# ---------------------------------------------------------------------------
# Abstract/concrete node evaluation (shared by infer + executor)
# ---------------------------------------------------------------------------

def _call_impl(node: _Node, arrays, generator=None, is_train=False):
    op = node.op
    attrs = dict(node.attrs)
    if op.training_aware and "_training" not in attrs:
        attrs["_training"] = is_train
    return _registry.invoke_impl(op, list(arrays), node.pos_attrs, attrs,
                                 generator=generator)


def _eval_node_abstract(node: _Node, in_structs):
    """The node's output ``meta`` tensors in inference, the mutated
    inputs' new values left out."""
    with torch.no_grad():
        res = _call_impl(node, in_structs, is_train=False)
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    n_mut = len(node.mutate_indices())
    if n_mut:
        res = res[:len(res) - n_mut]
    return res


def eval_graph(heads: Sequence[Tuple[_Node, int]],
               var_values: Dict[str, torch.Tensor], is_train: bool,
               generators=(), group2ctx=None):
    """Evaluate the graph on tensors, under the caller's grad mode.

    Returns (outputs, aux_updates), where aux_updates maps the mutated
    variables' names to their new values in training (BatchNorm's
    running statistics, by the registry's mutate contract: an op returns
    its outputs, then the new values of the inputs it mutates); in
    inference nothing is updated.  ``generators`` holds one
    ``torch.Generator`` for each ``needs_rng`` node in topological order
    (the reference folds a node counter into one key); without them
    those ops draw from torch's default generator.

    ``group2ctx`` maps ``ctx_group`` attribute values (attached via
    ``mx.AttrScope``) to Contexts: each op node whose group is mapped
    runs on that device, its inputs moved there (the reference's
    ``place_device`` pass and cross-device copies)."""
    order = _topo_order(heads)
    vals: Dict[Tuple[int, int], torch.Tensor] = {}
    aux_updates: Dict[str, torch.Tensor] = {}
    gens = iter(generators)

    for n in order:
        if n.is_var:
            if n.name not in var_values:
                raise MXNetError("unbound variable %r" % n.name)
            vals[(id(n), 0)] = var_values[n.name]
            continue
        arrays = []
        for (inp, oi) in n.inputs:
            v = vals[(id(inp), oi)]
            # a mutated upstream variable may have a fresher value
            if inp.is_var and inp.name in aux_updates:
                v = aux_updates[inp.name]
            arrays.append(v)
        if group2ctx:
            grp = n.user_attrs.get("ctx_group")
            if grp is not None and grp in group2ctx:
                dev = group2ctx[grp].torch_device
                arrays = [a.to(dev) for a in arrays]
        gen = next(gens, None) if n.op.needs_rng else None
        res = _call_impl(n, arrays, generator=gen, is_train=is_train)
        rlist = list(res) if isinstance(res, (tuple, list)) else [res]
        mut = n.mutate_indices()
        n_out = len(rlist) - len(mut)
        for j, idx in enumerate(mut):
            inp, _ = n.inputs[idx]
            if inp.is_var and is_train:
                aux_updates[inp.name] = rlist[n_out + j]
        for i, v in enumerate(rlist[:n_out]):
            vals[(id(n), i)] = v

    outputs = [vals[(id(n), i)] for (n, i) in heads]
    return outputs, aux_updates


# ---------------------------------------------------------------------------
# Constructors & op application
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, dtype=None, init=None,
             lr_mult=None, wd_mult=None, **kwargs):
    """Create a variable (graph input) symbol.  Attributes from active
    ``mx.AttrScope``s are attached (reference: ``attribute.py``)."""
    from .. import attribute as _attribute
    user = _attribute.current().get(attr)
    if shape is not None:
        user["__shape__"] = json.dumps(list(shape))
    if dtype is not None:
        user["__dtype__"] = dtype_name(dtype)
    if init is not None:
        user["__init__"] = init if isinstance(init, str) else \
            init.__class__.__name__
    if lr_mult is not None:
        user["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        user["__wd_mult__"] = str(wd_mult)
    return Symbol([(_Node(None, name, user_attrs=user), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _impl_slot_names(op) -> List[str]:
    try:
        params = list(inspect.signature(op.impl).parameters)
    except (TypeError, ValueError):
        return []
    if op.needs_rng and params:
        params = params[1:]             # the generator
    return params


def _apply_op(op_name: str, sym_inputs: List[Symbol],
              attrs: Dict[str, Any], pos_attrs: Tuple = (),
              name: Optional[str] = None,
              user_attr: Optional[Dict[str, str]] = None) -> Symbol:
    from .. import attribute as _attribute
    op = _registry.get_op(op_name)
    node_name = _NM.get(name, op.name)
    user_attrs = _attribute.current().get(user_attr)

    inputs = [s._outputs[0] for s in sym_inputs]

    # Auto-create missing parameter variables (reference: composition
    # auto-creates variable nodes for unfilled inputs).
    slots = _ARRAY_SLOTS.get(op.name)
    if slots and not op.variadic and len(inputs) < len(slots):
        for slot in slots[len(inputs):]:
            if _slot_skipped(op.name, slot, attrs):
                continue
            if op.name in _OUTPUT_OPS and slot == "label":
                vname = node_name + "_label"
            else:
                vname = "%s_%s" % (node_name, slot)
            inputs.append(Variable(vname)._outputs[0])

    node = _Node(op, node_name, inputs, pos_attrs, attrs,
                 user_attrs=user_attrs)
    return Symbol([(node, i) for i in range(node.num_outputs)]
                  if node.num_outputs > 1 else [(node, 0)])


def _make_sym_stub(op):
    def stub(*args, **kwargs):
        name = kwargs.pop("name", None)
        user_attr = kwargs.pop("attr", None)
        sym_inputs: List[Symbol] = []
        pos_attrs: List[Any] = []
        flat = []
        for a in args:
            if isinstance(a, (list, tuple)) and a and \
                    all(isinstance(x, Symbol) for x in a):
                flat.extend(a)
            else:
                flat.append(a)
        seen_attr = False
        for a in flat:
            if isinstance(a, Symbol) and not seen_attr:
                sym_inputs.append(a)
            else:
                seen_attr = True
                pos_attrs.append(a)
        # keyword Symbol inputs fill named slots (data=..., weight=...)
        kw_syms = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        if kw_syms:
            for k in kw_syms:
                kwargs.pop(k)
            slot_names = _impl_slot_names(op)
            slotted: Dict[int, Symbol] = {
                i: s for i, s in enumerate(sym_inputs)}
            for k, v in kw_syms.items():
                if k not in slot_names:
                    raise MXNetError("unknown input %r for op %s"
                                     % (k, op.name))
                slotted[slot_names.index(k)] = v
            idxs = sorted(slotted)
            if idxs != list(range(len(idxs))):
                raise MXNetError(
                    "inputs of %s must fill leading slots; got %s"
                    % (op.name, idxs))
            sym_inputs = [slotted[i] for i in idxs]
        return _apply_op(op.name, sym_inputs, kwargs,
                         pos_attrs=tuple(pos_attrs), name=name,
                         user_attr=user_attr)

    stub.__name__ = op.name
    stub.__doc__ = op.doc
    return stub


def populate(namespace: dict):
    """Install a ``sym.<Op>`` stub for every op of the port's registry."""
    for opname in _registry.list_ops():
        if opname not in namespace:
            namespace[opname] = _make_sym_stub(_registry.get_op(opname))


# ---------------------------------------------------------------------------
# JSON load
# ---------------------------------------------------------------------------

def load_json(json_str: str) -> Symbol:
    graph = json.loads(json_str)
    nodes: List[_Node] = []
    for entry in graph["nodes"]:
        raw_attrs = dict(entry.get("attrs", {}))
        pos_attrs = ()
        if "__pos_attrs__" in raw_attrs:
            pos_attrs = tuple(json.loads(raw_attrs.pop("__pos_attrs__")))
        attrs = {}
        for k, v in raw_attrs.items():
            try:
                attrs[k] = json.loads(v)
            except (ValueError, TypeError):
                attrs[k] = v
        if entry["op"] == "null":
            node = _Node(None, entry["name"],
                         user_attrs=entry.get("user_attrs"))
        else:
            op = _registry.get_op(entry["op"])
            inputs = [(nodes[i], oi) for (i, oi, _) in entry["inputs"]]
            node = _Node(op, entry["name"], inputs, pos_attrs, attrs,
                         entry.get("user_attrs"))
        nodes.append(node)
    heads = [(nodes[i], oi) for (i, oi, _) in graph["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())
