"""Convert a JAX parameter tree (as host arrays) into torch tensors.

The port never re-initialises the reference's weights: JAX's random
streams cannot be reproduced in torch, so parity tests (and anyone
moving a checkpoint) copy the JAX tree to host numpy arrays and hand
it to :func:`from_jax`; :func:`to_numpy` maps a torch tree back to host
arrays (to compare trained parameters, for example).  :func:`tree_map`
and :func:`tree_leaves` walk such nested dict/list trees.  Nothing here
imports JAX: any leaf with ``__array__`` is read through
``numpy.asarray``.

For Gluon blocks, :func:`set_block_params` writes a ``{structural name:
array}`` dict (``features.0.weight``, as ``_collect_params_with_prefix``
names them in both packages) into a port ``Block``; the reference's
``save_parameters`` file also loads directly through the port's
``load_parameters``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["from_jax", "to_numpy", "tree_map", "tree_leaves",
           "set_block_params"]


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


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict/list/tuple tree,
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a nested dict/list/tuple tree, in the order
    :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def from_jax(tree, device=None):
    """Map a nested dict/list/tuple tree of arrays leaf for leaf onto
    torch tensors on ``device`` — including the ``{"q": int8, "s": f32}``
    leaves of ``quantize_decode_params`` — keeping the structure, the
    dtypes and the values bit for bit."""
    dev = resolve_device(device)
    return tree_map(lambda t: _leaf(t, dev), tree)


def to_numpy(tree):
    """The inverse of :func:`from_jax` for a tree of tensors: each leaf
    detached, copied to the host and returned as a numpy array of its
    dtype.  numpy has no bfloat16, so a bfloat16 leaf comes back as
    float32, which holds its value exactly."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def set_block_params(block, arrays, ctx=None):
    """Write ``arrays`` ({structural name: array}) into the parameters of
    the port ``Block`` ``block``, BatchNorm running statistics included.
    Raises ``ValueError`` on a name missing from either side or on a
    shape mismatch; a parameter not yet initialized (deferred) is created
    from its value on ``ctx`` (default: the current context)."""
    params = block._collect_params_with_prefix()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise ValueError("set_block_params: missing %s, extra %s"
                         % (missing[:8], extra[:8]))
    for name, p in params.items():
        value = np.asarray(arrays[name])
        known = p.shape is not None and all(d > 0 for d in p.shape)
        if known and tuple(p.shape) != value.shape:
            raise ValueError("set_block_params: %s has shape %s, the value "
                             "%s" % (name, tuple(p.shape), value.shape))
        if p._data is None:
            p._init_from_value(value, ctx=ctx)
        else:
            p.set_data(torch.from_numpy(np.array(value, copy=True)))
