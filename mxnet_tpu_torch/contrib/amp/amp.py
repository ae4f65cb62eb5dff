"""Automatic mixed precision.

Port of ``mxnet_tpu/contrib/amp/amp.py``.  Casting runs as a hook on
the one op-invoke choke point (``ops.registry.invoke``), so it covers
eager ``nd``, a Gluon forward and ``DataParallelTrainer``'s step alike:
an op of ``lists.TARGET_DTYPE_OPS`` gets its float inputs in the target
dtype (bfloat16 by default), one of ``lists.FP32_OPS`` in float32, one
of ``lists.WIDEST_TYPE_CASTS`` in the widest float dtype among its
inputs; every other op is left alone.  The casts run inside the op's
grad-mode block, so autograd records them and gradients come back in
each input's own dtype.  ``init_trainer`` and ``scale_loss`` give a
Gluon ``Trainer`` the dynamic loss scaler float16 needs.
"""
from __future__ import annotations

import contextlib
import logging
import types

import numpy as np
import torch

from ...base import MXNetError, not_ported
from ...ops import registry as _registry
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "is_initialized", "disable", "init_trainer",
           "scale_loss", "convert_symbol", "convert_model"]

_state = {"initialized": False, "target_dtype": None}

_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def _is_float(t) -> bool:
    return torch.is_tensor(t) and t.dtype in _FLOAT_DTYPES


def _make_hook(target_dtype: str):
    """The cast hook for ``target_dtype`` (``"bfloat16"`` or
    ``"float16"``) over the lists as they stand now."""
    target = getattr(torch, target_dtype)
    f32 = torch.float32
    targets = set(lists.TARGET_DTYPE_OPS)
    fp32s = set(lists.FP32_OPS)
    widest = set(lists.WIDEST_TYPE_CASTS)

    def cast(arrays, dtype):
        return [a.to(dtype) if _is_float(a) and a.dtype != dtype else a
                for a in arrays]

    def hook(op, arrays):
        name = op.name
        if name in targets:
            return cast(arrays, target)
        if name in fp32s:
            return cast(arrays, f32)
        if name in widest:
            floats = [a.dtype for a in arrays if _is_float(a)]
            if not floats:
                return arrays
            w = f32 if f32 in floats else (
                target if target in floats else floats[0])
            return cast(arrays, w)
        return arrays

    return hook


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn on AMP for all later imperative and Gluon computation."""
    target_dtype = "bfloat16" if target_dtype == "bfloat16" \
        else str(np.dtype(target_dtype))
    if target_dtype not in ("float16", "bfloat16"):
        raise MXNetError("target_dtype must be float16 or bfloat16")
    if target_precision_ops:
        lists.TARGET_DTYPE_OPS.extend(target_precision_ops)
    if fp32_ops:
        lists.FP32_OPS.extend(fp32_ops)
    if target_precision_ops or fp32_ops:
        lists._rebuild_sets()
    _registry.set_cast_hook(_make_hook(target_dtype))
    _state["initialized"] = True
    _state["target_dtype"] = target_dtype
    logging.info("AMP initialized (target_dtype=%s)", target_dtype)


def is_initialized() -> bool:
    return _state["initialized"]


def disable():
    """Turn AMP off again."""
    _registry.set_cast_hook(None)
    _state["initialized"] = False


def init_trainer(trainer):
    """Attach a dynamic loss scaler to a Gluon ``Trainer`` and make its
    ``step`` skip the update (zeroing the gradients) when a gradient
    overflowed."""
    if not _state["initialized"]:
        raise MXNetError("call amp.init() before init_trainer()")
    scaler = LossScaler() if _state["target_dtype"] == "float16" \
        else LossScaler(init_scale=1.0, scale_factor=1.0)
    trainer._amp_loss_scaler = scaler
    trainer._amp_original_scale = trainer._scale
    original_step = trainer.step

    def step(self, batch_size, ignore_stale_grad=False):
        scaler = self._amp_loss_scaler
        if scaler.loss_scale != 1.0 or _state["target_dtype"] == "float16":
            overflow = scaler.has_overflow(self._params)
            scaler.update_scale(overflow)
            if overflow:
                logging.warning("AMP: gradient overflow, skipping update "
                                "(loss_scale=%g)", scaler.loss_scale)
                for p in self._params:
                    p.zero_grad()
                return
        original_step(batch_size, ignore_stale_grad)

    trainer.step = types.MethodType(step, trainer)
    return trainer


@contextlib.contextmanager
def scale_loss(loss, trainer):
    """``with amp.scale_loss(loss, trainer) as L: L.backward()``: the
    loss times the current scale, with the trainer set to divide the
    gradients back down in its ``step``."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        raise MXNetError("call amp.init_trainer(trainer) first")
    trainer._scale = trainer._amp_original_scale / scaler.loss_scale
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def convert_symbol(sym, target_dtype="bfloat16", target_precision_ops=None,
                   fp32_ops=None, cast_optional_params=False):
    raise not_ported("amp.convert_symbol (needs Symbol)",
                     "mxnet_tpu.contrib.amp.amp.convert_symbol")


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  **kwargs):
    raise not_ported("amp.convert_model (needs Symbol)",
                     "mxnet_tpu.contrib.amp.amp.convert_model")
