"""Convert a JAX parameter tree (as host arrays) into torch tensors.

The port never re-initialises the reference's weights: JAX's random
streams cannot be reproduced in torch, so parity tests (and anyone
moving a checkpoint) copy the JAX tree to host numpy arrays and hand
it to :func:`from_jax`.  Nothing here imports JAX:
any leaf with ``__array__`` is read through ``numpy.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["from_jax"]


def _leaf(x, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy:
        # reinterpret the same 16 bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax(tree, device=None):
    """Map a nested dict/list/tuple tree of arrays leaf for leaf onto
    torch tensors on ``device`` — including the ``{"q": int8, "s": f32}``
    leaves of ``quantize_decode_params`` — keeping the structure, the
    dtypes and the values bit for bit."""
    dev = resolve_device(device)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return _leaf(t, dev)

    return go(tree)
