"""Grouped SGD update: the CUDA kernel wrapper and its plain version.

Port of ``mxnet_tpu/kernels/fused_optimizer.py``.  ``csrc/fused_sgd.cu``
(:func:`fused_multi_sgd`) replaces both Pallas kernels of
``fused_multi_sgd``: ``_sgd_kernel`` (without momentum) and
``_sgd_mom_kernel`` (with).  Per element, MXNet's convention::

    g  = clip(grad * rescale_grad) + wd * w      (clip < 0: no clip)
    m' = momentum * m - lr * g;   w' = w + m'
    w' = w - lr * g                              (without momentum)

with one ``lr`` and ``wd`` per tensor and one launch for the whole
group.  Where the reference concatenates the group into a padded 1-D
buffer and splits it again, the kernel reads every tensor where it lies
through a small device table.  The table is a pure function of the
tensors' addresses and sizes and the rates, so it is kept for the last
few such keys (an in-place update of one group reuses it every step);
a new one is staged through pinned memory and copied without blocking
the host on the queued work.

The new weights come back as new tensors, or in the ``out`` tensors
when given (which may be the weights themselves: each element is read
and written by one thread); the momenta are updated in place and
returned.  The plain version :func:`fused_multi_sgd_reference`
is the per-element formula on each tensor's flat view, for CPU tensors;
a CUDA tensor launches the kernel or raises.  Both round after every
product and sum, as the port's per-tensor ``sgd_update`` /
``sgd_mom_update`` ops do, so all three agree bit for bit in f32 (up to
the sign of a zero where ``wd == 0``: the grouped versions always add
``wd * w``).  Each kernel counts its launches on the wrapper:
``fused_multi_sgd.sgd_launches`` (without momentum) and
``fused_multi_sgd.sgd_mom_launches`` (with).
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict

import numpy as np
import torch

from . import _build
from ._counters import register

__all__ = ["fused_multi_sgd", "fused_multi_sgd_reference"]

# one record per tensor, the layout of ``Entry`` in csrc/fused_sgd.cu
_ENTRY = np.dtype([("w", "<u8"), ("g", "<u8"), ("m", "<u8"), ("out", "<u8"),
                   ("n", "<i8"), ("chunk0", "<i8"), ("lr", "<f4"),
                   ("wd", "<f4"), ("vec", "<i4"), ("pad", "<i4")])
assert _ENTRY.itemsize == 64
# (device, stream, addresses, sizes, rates) -> (table, entries, chunks)
_TABLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_TABLES_KEPT = 8


def _check_rates(weights, lrs, wds):
    if len(lrs) != len(weights) or len(wds) != len(weights):
        raise ValueError("fused_multi_sgd: %d weights need %d lrs / %d wds"
                         % (len(weights), len(lrs), len(wds)))


def fused_multi_sgd_reference(weights, grads, moms=None, *, lrs, wds,
                              momentum=0.0, rescale_grad=1.0,
                              clip_gradient=-1.0, out=None):
    """Plain version of the kernel: returns (new weights, moms) with the
    momenta (when given) updated in place, or None for them; the new
    weights are written into ``out`` when given."""
    _check_rates(weights, lrs, wds)
    clip = clip_gradient is not None and clip_gradient >= 0
    outs = []
    for i, (w, g) in enumerate(zip(weights, grads)):
        wf = w.reshape(-1)
        gf = g.reshape(-1) * rescale_grad
        if clip:
            gf = gf.clamp(-clip_gradient, clip_gradient)
        gf = gf + wds[i] * wf
        if moms is None:
            new = wf - lrs[i] * gf
        else:
            mf = moms[i].view(-1)
            mf.copy_(momentum * mf - lrs[i] * gf)
            new = wf + mf
        if out is None:
            outs.append(new.view_as(w))
        else:
            outs.append(out[i].copy_(new.view_as(w)))
    return outs, moms


def _check(weights, grads, moms, out):
    dev = weights[0].device
    groups = (("weight", weights), ("grad", grads)) + (
        (("mom", moms),) if moms is not None else ()) + (
        (("out", out),) if out is not None else ())
    for name, ts in groups:
        if len(ts) != len(weights):
            raise ValueError("fused_multi_sgd: %d weights but %d %ss"
                             % (len(weights), len(ts), name))
        for t, w in zip(ts, weights):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != w.shape or not t.is_contiguous()):
                raise ValueError(
                    "fused_multi_sgd: every %s must be a contiguous float32 "
                    "tensor on %s shaped as its weight, got %s %s on %s"
                    % (name, dev, t.dtype, tuple(t.shape), t.device))


def _fn(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.load("fused_sgd"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _table(dev, keep, weights, grads, moms, outs, lrs, wds):
    """(device table, entries, total chunks) for the non-empty tensors
    ``keep``: from the cache, or built and copied to ``dev``."""
    ptrs = [(weights[i].data_ptr(), grads[i].data_ptr(),
             moms[i].data_ptr() if moms is not None else 0,
             outs[i].data_ptr()) for i in keep]
    n = [weights[i].numel() for i in keep]
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream,
           tuple(ptrs), tuple(n), tuple(float(lrs[i]) for i in keep),
           tuple(float(wds[i]) for i in keep))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit
    chunk = _fn("mxt_fused_sgd_chunk", [])()
    n = np.array(n, np.int64)
    ptrs = np.array(ptrs, np.uint64)
    chunks = -(-n // chunk)
    tab = np.zeros(len(keep), _ENTRY)
    tab["w"], tab["g"], tab["m"], tab["out"] = ptrs.T
    tab["n"] = n
    tab["chunk0"] = np.cumsum(chunks) - chunks
    tab["lr"] = key[4]
    tab["wd"] = key[5]
    tab["vec"] = (ptrs % 16 == 0).all(axis=1)
    table = torch.from_numpy(tab.view(np.uint8)).pin_memory().to(
        dev, non_blocking=True)
    _TABLES[key] = hit = (table, len(keep), int(chunks.sum()))
    if len(_TABLES) > _TABLES_KEPT:
        _TABLES.popitem(last=False)
    return hit


def fused_multi_sgd(weights, grads, moms=None, *, lrs, wds, momentum=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """One-launch grouped SGD (with momentum when ``moms`` is given) over
    lists of same-shaped weight, gradient and momentum tensors.

    Returns (new weights, moms): the weights as new tensors or, given
    ``out``, written into those (they may be ``weights``); the momenta
    updated in place (None without momentum).  CUDA tensors (contiguous
    float32, one device) launch ``csrc/fused_sgd.cu``; CPU tensors run
    :func:`fused_multi_sgd_reference`."""
    _check_rates(weights, lrs, wds)
    if not weights:
        return [], moms
    if weights[0].device.type == "cpu":
        return fused_multi_sgd_reference(
            weights, grads, moms, lrs=lrs, wds=wds, momentum=momentum,
            rescale_grad=rescale_grad, clip_gradient=clip_gradient, out=out)
    if weights[0].device.type != "cuda":
        raise ValueError("fused_multi_sgd: unsupported device %s"
                         % weights[0].device)
    _check(weights, grads, moms, out)
    dev = weights[0].device
    outs = [torch.empty_like(w) for w in weights] if out is None \
        else list(out)
    keep = [i for i, w in enumerate(weights) if w.numel() > 0]
    if not keep:
        return outs, moms
    table, count, first = _table(dev, keep, weights, grads, moms, outs,
                                 lrs, wds)
    clip = -1.0 if clip_gradient is None else float(clip_gradient)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn("mxt_fused_sgd",
              [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
               ctypes.c_void_p])(
        table.data_ptr(), count, first, int(moms is not None),
        float(rescale_grad), clip, float(momentum), stream)
    _build.check(err, "fused_multi_sgd")
    if moms is None:
        fused_multi_sgd.sgd_launches += 1
    else:
        fused_multi_sgd.sgd_mom_launches += 1
    return outs, moms


register(fused_multi_sgd, "sgd_launches", "sgd_mom_launches")
