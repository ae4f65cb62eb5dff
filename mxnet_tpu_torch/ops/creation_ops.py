"""``_full``, the one creation op outside ``shape_ops`` (port of
``mxnet_tpu/ops/creation_ops.py``)."""
from __future__ import annotations

import torch

from .elemwise import _dtype
from .registry import creation_device, register


@register("_full", no_grad=True)
def _full(shape=None, value=0.0, dtype="float32", **kw):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, value, dtype=_dtype(dtype or "float32"),
                      device=creation_device())
