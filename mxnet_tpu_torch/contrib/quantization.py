"""Post-training INT8 quantization.

Port of ``mxnet_tpu/contrib/quantization.py``: ``quantize_model`` /
``quantize_graph``, the layer-output collectors, naive (min/max) and
entropy (KL-divergence) calibration.

The graph pass rewrites a ``Symbol`` so that FullyConnected and
Convolution run as int8 x int8 -> int32 products (``ops/quantization.py``),
with ``quantize_v2`` -> op -> ``requantize`` chains threaded through
min/max range symbols, weights quantized offline, and ``dequantize``
inserted wherever a float consumer reads a quantized producer.
Pooling, Flatten and relu stay in int8 when their producer is already
quantized.

Calibration runs the float graph's outputs that the pass reads (each
quantizable op's output and its data input), where the reference runs
every internal output and keeps the rest unread: the thresholds the
pass reads, and so the quantized graph, are the same.  The entropy
collector's threshold searches (a Python loop over the histogram, about
a second a layer) run in forked worker processes when there are many
layers; each is the same computation on the same histogram.
"""
from __future__ import annotations

import logging
import multiprocessing
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from ..ops.registry import get_op
from ..symbol.symbol import Symbol, _Node

__all__ = ["quantize_model", "quantize_symbol", "quantize_graph",
           "calib_graph", "CalibrationCollector",
           "LayerOutputMinMaxCollector", "LayerHistogramCollector"]

_QUANTIZED_OPS = {
    "FullyConnected": "_contrib_quantized_fully_connected",
    "Convolution": "_contrib_quantized_conv",
}
_PASSTHROUGH_OPS = {"Pooling": "_contrib_quantized_pooling",
                    "Flatten": "_contrib_quantized_flatten"}


def _mk(opname, inputs, attrs, name):
    return _Node(get_op(opname), name, inputs, (), dict(attrs))


# ---------------------------------------------------------------------------
# Graph pass
# ---------------------------------------------------------------------------

def quantize_symbol(sym: Symbol, excluded_sym_names: Sequence[str] = (),
                    excluded_op_names: Sequence[str] = (),
                    offline_params: Sequence[str] = (),
                    quantized_dtype: str = "int8",
                    calib_info: Optional[Dict[str, Tuple[float, float]]]
                    = None) -> Symbol:
    """Rewrite ``sym`` into its int8 form (reference: ``quantize_graph``
    pass driven from ``contrib/quantization.py``)."""
    if quantized_dtype not in ("int8", "uint8", "auto"):
        raise MXNetError("quantized_dtype must be 'int8'/'uint8'/'auto' "
                         "(s8 weights; 'auto' picks u8 activations for "
                         "non-negative calibrated ranges, the reference "
                         "quantized-conv default)")
    excluded_sym_names = set(excluded_sym_names)
    excluded_op_names = set(excluded_op_names)
    offline = set(offline_params)
    calib_info = calib_info or {}

    fmap: Dict[Tuple[int, int], Tuple[_Node, int]] = {}
    qmap: Dict[Tuple[int, int], Tuple] = {}
    # param (weight/bias) quantizes are cached separately from activation
    # quantizes: a tensor consumed BOTH as an activation and as a param of
    # two quantized ops must not reuse the activation's (possibly u8)
    # quantize for the param edge, which is always s8
    pmap: Dict[Tuple[int, int], Tuple] = {}

    def fkey(node, slot):
        return (id(node), slot)

    def get_float(node, slot) -> Tuple[_Node, int]:
        k = fkey(node, slot)
        if k in fmap:
            return fmap[k]
        if k in qmap:  # only quantized exists: dequantize
            (qn, qs), (mnn, mns), (mxn, mxs) = qmap[k]
            dq = _mk("_contrib_dequantize",
                     [(qn, qs), (mnn, mns), (mxn, mxs)],
                     {}, node.name + "_dequantize")
            fmap[k] = (dq, 0)
            return fmap[k]
        raise MXNetError("internal: no float version of %s" % node.name)

    def get_quantized(node, slot, param=False) -> Tuple:
        """Int8 triple for an input edge, inserting quantize_v2 or offline
        param vars as needed.  ``param=True`` marks a weight/bias edge of a
        quantized op: those are ALWAYS symmetric s8 regardless of
        ``quantized_dtype`` — quantized_fully_connected/conv rescale them
        assuming rb/127, and a uint8 quantize would clip negative bias
        values to 0 (reference: params are s8 even under uint8 mode)."""
        k = fkey(node, slot)
        cache = pmap if param else qmap
        if k in cache:
            return cache[k]
        if node.is_var and node.name in offline:
            # offline vars are symmetric s8 — one triple serves both
            # activation and param edges
            if k not in qmap:
                qv = _Node(None, node.name + "_quantize")
                mnv = _Node(None, node.name + "_quantize_min")
                mxv = _Node(None, node.name + "_quantize_max")
                qmap[k] = ((qv, 0), (mnv, 0), (mxv, 0))
            cache[k] = qmap[k]
            return cache[k]
        fn, fs = get_float(node, slot)
        # activations follow quantized_dtype; quantize_v2 resolves
        # "auto" per node from the calibrated min (u8 iff min >= 0).
        # Param edges (see docstring) are forced s8.
        out_type = "int8" if param else quantized_dtype
        attrs: Dict[str, Any] = {"out_type": out_type}
        rng = calib_info.get(node.name)
        if rng is not None:
            attrs["min_calib_range"] = float(rng[0])
            attrs["max_calib_range"] = float(rng[1])
        # keep graph node names unique when the same edge is quantized
        # once per kind
        name = node.name + "_quantize"
        if param and k in qmap:
            name = node.name + "_quantize_s8"
        elif not param and k in pmap:
            name = node.name + "_quantize_act"
        qn = _mk("_contrib_quantize_v2", [(fn, fs)], attrs, name)
        cache[k] = ((qn, 0), (qn, 1), (qn, 2))
        return cache[k]

    def quantizable(node) -> bool:
        if node.is_var or node.name in excluded_sym_names:
            return False
        opname = node.op.name
        if opname in excluded_op_names:
            return False
        if opname in _QUANTIZED_OPS:
            return True
        if opname in _PASSTHROUGH_OPS or \
                (opname == "Activation" and
                 node.attrs.get("act_type", "relu") == "relu"):
            # stay in int8 only if the producer is already quantized
            return bool(node.inputs) and \
                fkey(*node.inputs[0]) in qmap
        return False

    for node in sym._nodes():
        if node.is_var:
            fmap[fkey(node, 0)] = (node, 0)
            continue
        if quantizable(node):
            opname = node.op.name
            if opname in _QUANTIZED_OPS:
                no_bias = bool(node.attrs.get("no_bias", False))
                data_q = get_quantized(*node.inputs[0])
                w_q = get_quantized(*node.inputs[1], param=True)
                ins = [data_q[0], w_q[0]]
                if not no_bias and len(node.inputs) > 2:
                    b_q = get_quantized(*node.inputs[2], param=True)
                    ins.append(b_q[0])
                ins += [data_q[1], data_q[2], w_q[1], w_q[2]]
                if not no_bias and len(node.inputs) > 2:
                    ins += [b_q[1], b_q[2]]
                qnode = _mk(_QUANTIZED_OPS[opname], ins, node.attrs,
                            node.name + "_quantized")
                rq_attrs: Dict[str, Any] = {}
                rng = calib_info.get(node.name)
                if rng is not None:
                    rq_attrs["min_calib_range"] = float(rng[0])
                    rq_attrs["max_calib_range"] = float(rng[1])
                rq = _mk("_contrib_requantize",
                         [(qnode, 0), (qnode, 1), (qnode, 2)], rq_attrs,
                         node.name + "_requantize")
                qmap[fkey(node, 0)] = ((rq, 0), (rq, 1), (rq, 2))
            else:  # int8 passthrough (Pooling/Flatten/relu)
                d_q = get_quantized(*node.inputs[0])
                ins = [d_q[0], d_q[1], d_q[2]]
                if node.op.name == "Activation":
                    qnode = _mk("_contrib_quantized_act", ins, node.attrs,
                                node.name + "_quantized")
                else:
                    qnode = _mk(_PASSTHROUGH_OPS[node.op.name], ins,
                                node.attrs, node.name + "_quantized")
                qmap[fkey(node, 0)] = ((qnode, 0), (qnode, 1), (qnode, 2))
        else:
            new_inputs = [get_float(n, s) for (n, s) in node.inputs]
            nn = _Node(node.op, node.name, new_inputs, node.pos_attrs,
                       node.attrs, node.user_attrs)
            for i in range(node.num_outputs):
                fmap[fkey(node, i)] = (nn, i)

    heads = [get_float(n, s) for (n, s) in sym._outputs]
    return Symbol(heads)


def _quantize_params(qsym: Symbol, arg_params: Dict[str, Any]):
    """Quantize offline params (reference: ``_quantize_params``): for every
    ``<w>_quantize`` argument of the rewritten graph, emit symmetric-int8
    ``<w>_quantize`` plus ``_min``/``_max`` scalars; float params that are
    still referenced pass through."""
    from .. import nd
    quantized: Dict[str, Any] = {}
    argset = set(qsym.list_arguments())
    for name in argset:
        if name.endswith("_quantize"):
            base = name[:-len("_quantize")]
            w = arg_params[base]
            wn = w.asnumpy() if hasattr(w, "asnumpy") else np.asarray(w)
            r = max(float(np.max(np.abs(wn))), 1e-30)
            q = np.clip(np.round(wn * (127.0 / r)), -127, 127)
            quantized[name] = nd.array(q.astype(np.int8), dtype="int8")
            quantized[name + "_min"] = nd.array(np.float32(-r))
            quantized[name + "_max"] = nd.array(np.float32(r))
        elif name.endswith("_quantize_min") or name.endswith("_quantize_max"):
            continue
        elif name in arg_params:
            quantized[name] = arg_params[name]
    return quantized


# ---------------------------------------------------------------------------
# Calibration collectors
# ---------------------------------------------------------------------------

class CalibrationCollector:
    """Base collector (reference: ``CalibrationCollector``): observes every
    internal layer output of the fp32 graph during calibration forwards."""

    def collect(self, name: str, arr: np.ndarray):
        raise NotImplementedError

    def thresholds(self) -> Dict[str, Tuple[float, float]]:
        raise NotImplementedError


class LayerOutputMinMaxCollector(CalibrationCollector):
    """``calib_mode='naive'``: running min/max per layer output."""

    def __init__(self):
        self.min_max: Dict[str, Tuple[float, float]] = {}

    def collect(self, name, arr):
        mn, mx = float(np.min(arr)), float(np.max(arr))
        if name in self.min_max:
            omn, omx = self.min_max[name]
            mn, mx = min(mn, omn), max(mx, omx)
        self.min_max[name] = (mn, mx)

    def thresholds(self):
        return dict(self.min_max)


class LayerHistogramCollector(CalibrationCollector):
    """``calib_mode='entropy'``: 8001-bin histogram per layer output, then
    KL-optimal thresholds (reference: ``_LayerHistogramCollector`` +
    ``_get_optimal_threshold``)."""

    def __init__(self, num_bins: int = 8001,
                 num_quantized_bins: int = 255):
        self.num_bins = num_bins
        self.num_quantized_bins = num_quantized_bins
        self.hist: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def collect(self, name, arr):
        arr = np.asarray(arr, dtype=np.float64).ravel()
        max_abs = float(np.max(np.abs(arr))) if arr.size else 0.0
        if name in self.hist:
            hist, edges = self.hist[name]
            old_max = edges[-1]
            if max_abs <= old_max:
                h, _ = np.histogram(arr, bins=len(hist),
                                    range=(-old_max, old_max))
                self.hist[name] = (hist + h, edges)
                return
            # grow range, re-bin old histogram into new edges
            new_edges = np.linspace(-max_abs, max_abs, len(hist) + 1)
            centers = (edges[:-1] + edges[1:]) / 2
            grown, _ = np.histogram(centers, bins=new_edges, weights=hist)
            h, _ = np.histogram(arr, bins=new_edges)
            self.hist[name] = (grown + h, new_edges)
        else:
            max_abs = max(max_abs, 1e-12)
            h, edges = np.histogram(arr, bins=self.num_bins,
                                    range=(-max_abs, max_abs))
            self.hist[name] = (h, edges)

    def thresholds(self):
        items = list(self.hist.items())
        jobs = [(hist, edges, self.num_quantized_bins)
                for _, (hist, edges) in items]
        ts = _thresholds(jobs)
        return {name: (-t, t) for (name, _), t in zip(items, ts)}


def _smoothed_kl(p: np.ndarray, q: np.ndarray, eps: float = 1e-4) -> float:
    """KL(p||q) with the reference's smoothing of zero bins."""
    p = p.astype(np.float64)
    q = q.astype(np.float64)

    def smooth(d):
        is_zero = d == 0
        n_zero = int(is_zero.sum())
        n_nonzero = d.size - n_zero
        if n_nonzero == 0:
            return None
        e = eps * n_zero / n_nonzero
        d = d.copy()
        d[is_zero] = eps
        d[~is_zero] -= e
        return d

    p = smooth(p)
    q = smooth(q)
    if p is None or q is None:
        return float("inf")
    p /= p.sum()
    q /= q.sum()
    return float(np.sum(p * np.log(p / q)))


def _get_optimal_threshold(hist: np.ndarray, hist_edges: np.ndarray,
                           num_quantized_bins: int = 255) -> float:
    """KL-divergence threshold search (reference:
    ``_get_optimal_threshold``): for each candidate symmetric threshold,
    clip the distribution, quantize it to ``num_quantized_bins`` levels,
    and keep the threshold minimizing KL(reference_dist || quantized)."""
    num_bins = len(hist)
    assert num_bins % 2 == 1
    zero_idx = num_bins // 2
    half_q = num_quantized_bins // 2
    best_div = float("inf")
    best_threshold = float(hist_edges[-1])
    for i in range(half_q, zero_idx + 1):
        start, stop = zero_idx - i, zero_idx + i + 1
        threshold = float(hist_edges[stop])
        sliced = hist[start:stop].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:start].sum()     # fold outliers into edge bins
        p[-1] += hist[stop:].sum()
        is_nonzero = p != 0
        # quantize sliced into num_quantized_bins groups
        n = sliced.size
        idx = (np.arange(n) * num_quantized_bins // n)
        qbins = np.bincount(idx, weights=sliced,
                            minlength=num_quantized_bins)
        # expand back, spreading each group over its nonzero members
        counts = np.bincount(idx, weights=is_nonzero.astype(np.float64),
                             minlength=num_quantized_bins)
        with np.errstate(divide="ignore", invalid="ignore"):
            expanded = np.where(counts[idx] > 0,
                                qbins[idx] / np.maximum(counts[idx], 1), 0.0)
        q = np.where(is_nonzero, expanded, 0.0)
        div = _smoothed_kl(p, q)
        if div < best_div:
            best_div = div
            best_threshold = threshold
    return best_threshold


def _threshold_job(job):
    return _get_optimal_threshold(*job)


_PARALLEL_FROM = 8        # layers; fewer are searched in this process


def _thresholds(jobs, timeout=900):
    """``_get_optimal_threshold`` of each job, in up to 8 forked workers
    when there are many (the search is a Python loop, and forked workers
    run the same code on the same arrays); in this process otherwise, or
    where fork is not available."""
    workers = min(8, os.cpu_count() or 1, len(jobs))
    if len(jobs) < _PARALLEL_FROM or workers < 2 or \
            "fork" not in multiprocessing.get_all_start_methods():
        return [_threshold_job(j) for j in jobs]
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        return pool.map_async(_threshold_job, jobs, chunksize=1).get(
            timeout)


# ---------------------------------------------------------------------------
# Calibration drive + top-level API
# ---------------------------------------------------------------------------

def _iter_calib_batches(calib_data, data_names, num_calib_examples):
    """Yield dicts name→numpy for each calibration batch."""
    from .. import nd as _nd
    seen = 0
    if hasattr(calib_data, "reset") and hasattr(calib_data, "__iter__"):
        calib_data.reset()
        for batch in calib_data:
            datas = batch.data if hasattr(batch, "data") else [batch]
            feed = {n: (d.asnumpy() if hasattr(d, "asnumpy") else
                        np.asarray(d))
                    for n, d in zip(data_names, datas)}
            yield feed
            seen += next(iter(feed.values())).shape[0]
            if num_calib_examples and seen >= num_calib_examples:
                return
    else:
        arr = calib_data.asnumpy() if hasattr(calib_data, "asnumpy") \
            else np.asarray(calib_data)
        if num_calib_examples:
            arr = arr[:num_calib_examples]
        yield {data_names[0]: arr}


def _calib_heads(sym: Symbol, excluded_sym_names=(),
                 excluded_op_names=()):
    """The outputs whose thresholds the pass reads: each quantizable
    op's output and the producer of its data input."""
    heads, seen = [], set()

    def add(node, slot):
        if (id(node), slot) not in seen:
            seen.add((id(node), slot))
            heads.append((node, slot))

    for node in sym._nodes():
        if node.is_var or node.op.name not in _QUANTIZED_OPS or \
                node.name in excluded_sym_names or \
                node.op.name in excluded_op_names:
            continue
        add(*node.inputs[0])
        add(node, 0)
    return heads


def _collect_layer_outputs(sym: Symbol, arg_params, aux_params, ctx,
                           calib_data, data_names, collector,
                           num_calib_examples, excluded_sym_names=(),
                           excluded_op_names=()):
    """Run float forwards of the calibration graph (the outputs the pass
    reads, as heads), feeding each output to the collector."""
    from .. import nd as _nd
    internals = Symbol(_calib_heads(sym, excluded_sym_names,
                                    excluded_op_names))
    out_nodes = [n for (n, s) in internals._outputs]
    exe = None
    bound_bs = None
    for feed in _iter_calib_batches(calib_data, data_names,
                                    num_calib_examples):
        args = {k: _nd.array(v, ctx=ctx) for k, v in feed.items()}
        feed_bs = next(iter(args.values())).shape[0]
        if exe is not None and feed_bs != bound_bs:
            exe = None   # rebind: zero-filled labels are batch-sized
        if exe is None:
            bound_bs = feed_bs
            for k, v in arg_params.items():
                args[k] = v
            # zero-fill remaining args (e.g. SoftmaxOutput labels) —
            # inference-only calibration has no labels to feed
            missing = [a for a in internals.list_arguments()
                       if a not in args]
            if missing:
                try:
                    shapes, _, _ = internals.infer_shape_partial(
                        **{k: tuple(v.shape) for k, v in args.items()})
                except Exception as e:
                    shapes = None
                if shapes is None:
                    raise MXNetError(
                        "calibration: cannot infer shapes for unfed "
                        "arguments %s — feed them via calib_data or "
                        "exclude the consuming ops" % missing)
                try:
                    dtypes, _, _ = internals.infer_type(
                        **{k: str(v.dtype) for k, v in args.items()
                           if hasattr(v, "dtype")})
                except Exception:
                    dtypes = None
                if dtypes is None:   # infer_type's failure sentinel
                    dtypes = [None] * len(internals.list_arguments())
                for name, shp, dt in zip(internals.list_arguments(),
                                         shapes, dtypes):
                    if name in missing:
                        if shp is None:
                            raise MXNetError(
                                "calibration: shape of unfed argument "
                                "%r is unresolvable" % name)
                        args[name] = _nd.zeros(
                            shp, dtype=dt or "float32", ctx=ctx)
            exe = internals.bind(ctx=ctx, args=args, args_grad=None,
                                 grad_req="null",
                                 aux_states=dict(aux_params or {}))
            outs = exe.forward(is_train=False)
        else:
            outs = exe.forward(is_train=False, **args)
        for node, out in zip(out_nodes, outs):
            if node.is_var and node.name not in feed:
                continue  # params don't need activation calibration
            collector.collect(node.name, out.asnumpy())
    return collector.thresholds()


def quantize_graph(sym, arg_params, aux_params, excluded_sym_names=(),
                   excluded_op_names=(), calib_info=None,
                   quantized_dtype="int8"):
    """Graph-only quantization (reference: ``quantize_graph``) — no
    calibration drive; use when thresholds are already known."""
    offline = _offline_param_names(sym)
    qsym = quantize_symbol(sym, excluded_sym_names, excluded_op_names,
                           offline, quantized_dtype, calib_info)
    qarg = _quantize_params(qsym, arg_params)
    return qsym, qarg, dict(aux_params or {})


def calib_graph(qsym, arg_params, aux_params, collector,
                quantized_dtype="int8"):
    """Recompute a quantized graph with the collector's thresholds folded
    in (reference: ``calib_graph``)."""
    raise MXNetError("calib_graph requires the pre-rewrite symbol; call "
                     "quantize_model(calib_mode=...) instead")


def _offline_param_names(sym: Symbol) -> List[str]:
    """Weight/bias arguments of quantizable ops — quantized offline."""
    names = []
    for node in sym._nodes():
        if not node.is_var and node.op.name in _QUANTIZED_OPS:
            for (inp, _) in node.inputs[1:]:
                if inp.is_var:
                    names.append(inp.name)
    return names


def quantize_model(sym: Symbol, arg_params: Dict, aux_params: Dict,
                   data_names: Sequence[str] = ("data",), ctx=None,
                   excluded_sym_names: Sequence[str] = (),
                   excluded_op_names: Sequence[str] = (),
                   calib_mode: str = "entropy", calib_data=None,
                   num_calib_examples: Optional[int] = None,
                   quantized_dtype: str = "int8", logger=None):
    """Quantize an fp32 model to int8 (reference: ``quantize_model``).

    Returns ``(qsym, qarg_params, aux_params)``.  ``calib_mode``:
    ``'none'`` (runtime ranges), ``'naive'`` (min/max), ``'entropy'``
    (KL-optimal thresholds).
    """
    from .. import context as _context
    logger = logger or logging.getLogger(__name__)
    if ctx is None:
        ctx = _context.current_context()
    if isinstance(data_names, str):
        data_names = (data_names,)

    calib_info = None
    if calib_mode != "none":
        if calib_data is None:
            raise MXNetError("calib_mode=%r requires calib_data"
                             % calib_mode)
        if calib_mode == "naive":
            collector = LayerOutputMinMaxCollector()
        elif calib_mode == "entropy":
            collector = LayerHistogramCollector()
        else:
            raise MXNetError("calib_mode must be none/naive/entropy")
        logger.info("Collecting layer outputs for %s calibration",
                    calib_mode)
        calib_info = _collect_layer_outputs(
            sym, arg_params, aux_params, ctx, calib_data, list(data_names),
            collector, num_calib_examples, excluded_sym_names,
            excluded_op_names)

    return quantize_graph(sym, arg_params, aux_params, excluded_sym_names,
                          excluded_op_names, calib_info, quantized_dtype)
