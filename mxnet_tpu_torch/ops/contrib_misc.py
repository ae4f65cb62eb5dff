"""Contrib operators: the interleaved attention matmuls of GluonNLP's
fused transformer, ``div_sqrt_dim``, ``masked_log_softmax``,
``quadratic``, ``gradientmultiplier``, ``allclose``, ``getnnz``,
``count_sketch`` and ``SyncBatchNorm``.

Port of ``mxnet_tpu/ops/contrib_misc.py``, name for name.
``SyncBatchNorm`` on one device is ``BatchNorm`` over the channel axis,
as the reference computes it there.
"""
from __future__ import annotations

import math

import torch

from .nn import batch_norm
from .registry import register


def _split_interleaved(qkv, heads, parts):
    """(L, B, H*parts*dh), interleaved per head -> ``parts`` tensors of
    (B*H, L, dh)."""
    L, B, D = qkv.shape
    dh = D // (heads * parts)
    x = qkv.reshape(L, B, heads, parts, dh)
    return tuple(x[:, :, :, p].permute(1, 2, 0, 3).reshape(B * heads, L, dh)
                 for p in range(parts))


def _merge_heads(ctx, heads):
    """(B*H, L, dh) -> (L, B, H*dh)."""
    BH, L, dh = ctx.shape
    return ctx.reshape(BH // heads, heads, L, dh).permute(2, 0, 1, 3) \
        .reshape(L, BH // heads, heads * dh)


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1, **kw):
    """Scores (B*H, L, L) of interleaved qkv, queries scaled by
    1/sqrt(dh)."""
    q, k, _ = _split_interleaved(queries_keys_values, int(heads), 3)
    scale = 1.0 / math.sqrt(q.shape[-1])
    return torch.einsum("nld,nmd->nlm", q * scale, k)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1, **kw):
    _, _, v = _split_interleaved(queries_keys_values, int(heads), 3)
    return _merge_heads(torch.einsum("nlm,nmd->nld", attention, v),
                        int(heads))


@register("_contrib_interleaved_matmul_encdec_qk")
def interleaved_matmul_encdec_qk(queries, keys_values, heads=1, **kw):
    heads = int(heads)
    Lq, B, D = queries.shape
    dh = D // heads
    q = queries.reshape(Lq, B, heads, dh).permute(1, 2, 0, 3) \
        .reshape(B * heads, Lq, dh)
    k, _ = _split_interleaved(keys_values, heads, 2)
    return torch.einsum("nld,nmd->nlm", q * (1.0 / math.sqrt(dh)), k)


@register("_contrib_interleaved_matmul_encdec_valatt")
def interleaved_matmul_encdec_valatt(keys_values, attention, heads=1,
                                     **kw):
    _, v = _split_interleaved(keys_values, int(heads), 2)
    return _merge_heads(torch.einsum("nlm,nmd->nld", attention, v),
                        int(heads))


@register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))
def div_sqrt_dim(data, **kw):
    return data / math.sqrt(data.shape[-1])


@register("masked_log_softmax")
def masked_log_softmax(data, mask, axis=-1, temperature=1.0, **kw):
    """log_softmax over the positions where ``mask`` is nonzero; the
    others give -inf."""
    keep = mask != 0
    low = torch.finfo(data.dtype).min
    x = torch.where(keep, data / temperature,
                    torch.full_like(data, low))
    out = torch.log_softmax(x, dim=axis)
    return torch.where(keep, out, torch.full_like(out, -math.inf))


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0, **kw):
    return a * data * data + b * data + c


class _GradMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scalar):
        ctx.scalar = scalar
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier", aliases=("gradientmultiplier",))
def gradientmultiplier(data, scalar=1.0, **kw):
    """Identity forward; the gradient times ``scalar`` backward."""
    return _GradMultiplier.apply(data, float(scalar))


@register("_contrib_allclose", aliases=("allclose",), no_grad=True)
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False, **kw):
    close = torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)
    return close.all().float()


@register("_contrib_getnnz", aliases=("getnnz",), no_grad=True)
def getnnz(data, axis=None, **kw):
    return torch.count_nonzero(data, dim=axis).to(torch.int32)


@register("_contrib_count_sketch", aliases=("count_sketch",),
          no_grad=True)
def count_sketch(data, h, s, out_dim=1, **kw):
    """``out[n, h[i]] += s[i] * data[n, i]``."""
    flat = data.reshape(-1, data.shape[-1])
    out = torch.zeros((flat.shape[0], int(out_dim)), dtype=data.dtype,
                      device=data.device)
    out.index_add_(1, h.to(torch.int32).long().reshape(-1),
                   flat * s.reshape(-1))
    return out.reshape(tuple(data.shape[:-1]) + (int(out_dim),))


@register("_contrib_SyncBatchNorm", aliases=("SyncBatchNorm",),
          mutate=(3, 4), training_aware=True)
def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    output_mean_var=False, ndev=1, key=None,
                    _training=False, **kw):
    """BatchNorm over the channel axis; ``ndev``/``key`` (the
    cross-device barrier) are accepted and unused on one device."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=1,
                      _training=_training)
