"""The SGD family of optimizer-update ops.

Port of ``sgd_update``, ``sgd_mom_update``, ``multi_sgd_update``,
``multi_sgd_mom_update`` and the ``preloaded_multi_sgd_*`` ops of
``mxnet_tpu/ops/optimizer_ops.py``.  The caller passes ``out=weight`` to
update in place; momenta are mutated inputs (the ``mutate`` contract).

The grouped ops keep the reference's dispatch rule: the group goes to
the one-launch kernel (:func:`..kernels.fused_optimizer.fused_multi_sgd`)
when ``num_weights > 1``, every tensor is float32, the rates are host
numbers (:func:`_concrete_rates`) and ``MXNET_FUSED_OPTIMIZER`` (read at
each call) is ``1`` or unset; otherwise they loop the per-tensor ops.
Without ``out=`` they return new weights and leave the inputs alone;
only the momenta change.  With ``out=`` the kernel writes the new
weights straight into ``out`` (usually the weights themselves).  Every
product and sum rounds once, so the kernel and the loop agree bit for
bit in f32.
"""
from __future__ import annotations

import numbers
import os

import torch

from ..kernels.fused_optimizer import fused_multi_sgd
from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd:
        g = g + wd * weight
    return g


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * g


@register("sgd_mom_update", mutate=(2,))
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def _concrete_rates(lrs, wds):
    """True when the per-tensor rates are host numbers; array rates (the
    preloaded ops) stay on the per-tensor loop."""
    return all(isinstance(v, numbers.Number)
               for seq in (lrs, wds) for v in list(seq))


def _use_fused_group(tensors):
    """The grouped kernel computes in f32: only all-f32 groups take it,
    and only while ``MXNET_FUSED_OPTIMIZER`` is ``1`` (the default)."""
    if os.environ.get("MXNET_FUSED_OPTIMIZER", "1") != "1":
        return False
    return all(t.dtype == torch.float32 for t in tensors)


@register("multi_sgd_update", variadic=True, num_outputs=-1,
          writes_out=True)
def multi_sgd_update(data, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1, out=None, **kw):
    ws = [data[2 * i] for i in range(num_weights)]
    if num_weights > 1 and _use_fused_group(data) \
            and _concrete_rates(lrs, wds):
        gs = [data[2 * i + 1] for i in range(num_weights)]
        outs, _ = fused_multi_sgd(ws, gs, lrs=lrs, wds=wds,
                                  rescale_grad=rescale_grad,
                                  clip_gradient=clip_gradient, out=out)
        return tuple(outs)
    return tuple(sgd_update(ws[i], data[2 * i + 1], lr=lrs[i], wd=wds[i],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i in range(num_weights))


def _moms_mutated(attrs):
    return tuple(3 * i + 2 for i in range(attrs.get("num_weights", 1)))


@register("multi_sgd_mom_update", variadic=True, num_outputs=-1,
          mutate=_moms_mutated, writes_out=True)
def multi_sgd_mom_update(data, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1, out=None, **kw):
    ws = [data[3 * i] for i in range(num_weights)]
    gs = [data[3 * i + 1] for i in range(num_weights)]
    ms = [data[3 * i + 2] for i in range(num_weights)]
    if num_weights > 1 and _use_fused_group(data) \
            and _concrete_rates(lrs, wds):
        outs, moms = fused_multi_sgd(ws, gs, ms, lrs=lrs, wds=wds,
                                     momentum=momentum,
                                     rescale_grad=rescale_grad,
                                     clip_gradient=clip_gradient, out=out)
        return tuple(outs) + tuple(moms)
    pairs = [sgd_mom_update(ws[i], gs[i], ms[i], lr=lrs[i],
                            momentum=momentum, wd=wds[i],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
             for i in range(num_weights)]
    # the momenta come after the weights, written back by the mutate
    # contract
    return tuple(w for w, _ in pairs) + tuple(m for _, m in pairs)


@register("preloaded_multi_sgd_update", variadic=True, num_outputs=-1)
def preloaded_multi_sgd_update(data, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=1, **kw):
    """``multi_sgd_update`` with the lrs and wds as the last two input
    arrays; array rates always take the per-tensor loop."""
    return multi_sgd_update(data[:-2], lrs=data[-2], wds=data[-1],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient,
                            num_weights=num_weights)


@register("preloaded_multi_sgd_mom_update", variadic=True, num_outputs=-1,
          mutate=_moms_mutated)
def preloaded_multi_sgd_mom_update(data, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1, **kw):
    return multi_sgd_mom_update(data[:-2], lrs=data[-2], wds=data[-1],
                                momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient,
                                num_weights=num_weights)
