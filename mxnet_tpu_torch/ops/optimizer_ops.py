"""Optimizer-update ops.

Port of ``mxnet_tpu/ops/optimizer_ops.py``, name for name: the SGD,
NAG, Adam/AdamW, FTRL, RMSProp (plain and Alex Graves's centred form),
SignSGD/Signum and LAMB (two phases) updates, their ``mp_*``
multi-precision forms (a float32 master copy of a low-precision
weight), the grouped ``multi_*`` ops, ``multi_sum_sq``/``multi_lars``
(LARS's per-layer rates), ``reset_arrays`` and group AdaGrad.  The
caller passes ``out=weight`` to update in place; optimizer states
(momenta, moments, master weights) are mutated inputs (the ``mutate``
contract).  Every update keeps the reference's order of operations, so
against the reference's ops run unjitted the f32 results agree bit for
bit.

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
from .elemwise import sqrt
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


@register("mp_sgd_update", mutate=(2,))
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, **kw):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", mutate=(2, 3))
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True, **kw):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("nag_mom_update", mutate=(2,))
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@register("mp_nag_mom_update", mutate=(2, 3))
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom + g
    new_w32 = weight32 - lr * (g + momentum * new_mom)
    return new_w32.to(weight.dtype), new_mom, new_w32


def _clip(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _adam(weight, g, mean, var, lr, beta1, beta2, epsilon):
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * (g * g)
    new_w = weight - lr * new_mean / (sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("adam_update", mutate=(2, 3))
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, **kw):
    """Adam without bias correction (the optimizer folds it into
    ``lr``); ``wd`` is added to the gradient."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return _adam(weight, g, mean, var, lr, beta1, beta2, epsilon)


@register("mp_adam_update", mutate=(2, 3, 4))
def mp_adam_update(weight, grad, mean, var, weight32, lr=0.001, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_w32, new_mean, new_var = _adam(weight32, g, mean, var, lr, beta1,
                                       beta2, epsilon)
    return new_w32.to(weight.dtype), new_mean, new_var, new_w32


@register("adamw_update", mutate=(2, 3))
def adamw_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, eta=1.0, rescale_grad=1.0,
                 clip_gradient=-1.0, **kw):
    """Adam with decoupled weight decay, scaled by ``eta``."""
    g = _clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * (g * g)
    new_w = weight - eta * (lr * new_mean / (sqrt(new_var) + epsilon)
                            + wd * weight)
    return new_w, new_mean, new_var


@register("ftrl_update", mutate=(2, 3))
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _clip(grad, rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (sqrt(new_n) - sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        new_z.abs() <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("rmsprop_update", mutate=(2,))
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * (g * g)
    new_w = weight - lr * g / sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n


@register("rmspropalex_update", mutate=(2, 3, 4))
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, **kw):
    """Centred RMSProp (Graves 2013): running mean of the gradient
    ``g`` and of its square ``n``, and a momentum ``delta``."""
    gr = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * (gr * gr)
    new_g = gamma1 * g + (1 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / sqrt(
        new_n - new_g * new_g + epsilon)
    new_w = weight + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w, new_n, new_g, new_delta


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    g = _clip(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", mutate=(2,))
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **kw):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - (1 - momentum) * g
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("lamb_update_phase1", mutate=(2, 3))
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """LAMB phase 1: the moments (mutated) and the raw update
    ``m / (sqrt(v) + eps) + wd * w``, bias-corrected by step ``t``."""
    g = _clip(grad, rescale_grad, clip_gradient)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * (g * g)
    m, v = new_mean, new_var
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (sqrt(v) + epsilon) + wd * weight, new_mean, new_var


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0, **kw):
    """LAMB phase 2: ``w - lr * (r1 / r2) * update``, the trust ratio 1
    unless both norms are positive; ``r1`` clipped to the bounds."""
    r1_ = r1
    if lower_bound is not None and lower_bound >= 0:
        r1_ = torch.clamp(r1_, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1_ = torch.clamp(r1_, max=upper_bound)
    ratio = torch.where((r1_ > 0) & (r2 > 0), r1_ / r2,
                        torch.ones_like(r1_))
    return weight - lr * ratio * g_update


@register("mp_lamb_update_phase1", mutate=(2, 3))
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, **kw):
    return lamb_update_phase1(weight32, grad.float(), mean, var,
                              beta1=beta1, beta2=beta2, epsilon=epsilon,
                              t=t, bias_correction=bias_correction, wd=wd,
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)


@register("mp_lamb_update_phase2", mutate=(4,))
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, lr=0.01,
                          lower_bound=-1.0, upper_bound=-1.0, **kw):
    new32 = lamb_update_phase2(weight32, g_update, r1, r2, lr=lr,
                               lower_bound=lower_bound,
                               upper_bound=upper_bound)
    return new32.to(weight.dtype), new32


@register("multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0, **kw):
    """LARS rates ``lr * eta * |w| / (|g| * rescale + wd * |w| + eps)``
    per layer, ``lr`` unchanged unless both norms are positive."""
    w_norm = sqrt(weights_sum_sq)
    g_norm = sqrt(grads_sum_sq) * rescale_grad
    ratio = eta * w_norm / (g_norm + wds * w_norm + eps)
    return torch.where((w_norm > 0) & (g_norm > 0), lrs * ratio, lrs)


@register("multi_sum_sq", variadic=True, num_outputs=1, no_grad=True)
def multi_sum_sq(data, num_arrays=1, **kw):
    """Each array's sum of squares, in f32."""
    return torch.stack([(a.float() * a.float()).sum()
                        for a in data[:num_arrays]])


@register("reset_arrays", variadic=True, num_outputs=-1,
          mutate=lambda attrs: tuple(range(attrs.get("num_arrays", 1))),
          no_grad=True)
def reset_arrays(data, num_arrays=1, **kw):
    """Zero a group of arrays (mutated inputs; no outputs)."""
    return tuple(torch.zeros_like(a) for a in data[:num_arrays])


@register("multi_mp_sgd_update", variadic=True, num_outputs=-1,
          mutate=lambda attrs: tuple(
              3 * i + 2 for i in range(attrs.get("num_weights", 1))))
def multi_mp_sgd_update(data, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1, **kw):
    """Grouped ``mp_sgd_update`` over (weight, grad, weight32)
    triples."""
    pairs = [mp_sgd_update(data[3 * i], data[3 * i + 1], data[3 * i + 2],
                           lr=lrs[i], wd=wds[i], rescale_grad=rescale_grad,
                           clip_gradient=clip_gradient)
             for i in range(num_weights)]
    return tuple(w for w, _ in pairs) + tuple(m for _, m in pairs)


@register("multi_mp_sgd_mom_update", variadic=True, num_outputs=-1,
          mutate=lambda attrs: tuple(
              v for i in range(attrs.get("num_weights", 1))
              for v in (4 * i + 2, 4 * i + 3)))
def multi_mp_sgd_mom_update(data, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1, **kw):
    """Grouped ``mp_sgd_mom_update`` over (weight, grad, mom, weight32)
    quadruples."""
    res = [mp_sgd_mom_update(*data[4 * i:4 * i + 4], lr=lrs[i],
                             momentum=momentum, wd=wds[i],
                             rescale_grad=rescale_grad,
                             clip_gradient=clip_gradient)
           for i in range(num_weights)]
    return tuple(r[0] for r in res) + tuple(v for r in res for v in r[1:])


@register("_contrib_group_adagrad_update",
          aliases=("group_adagrad_update",), mutate=(2,))
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5, **kw):
    """AdaGrad with one history value per row: the mean square of the
    row's gradient."""
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if g.dim() > 1:
        h_new = history + (g * g).mean(dim=tuple(range(1, g.dim())),
                                        keepdim=True)
    else:
        h_new = history + g * g
    return weight - lr * g / (sqrt(h_new) + epsilon), h_new


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
