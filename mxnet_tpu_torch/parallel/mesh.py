"""Device meshes.

Port of ``mxnet_tpu/parallel/mesh.py``: :func:`make_mesh`,
:func:`default_mesh`, :func:`serving_mesh`, :class:`mesh_scope`,
:func:`current_mesh` and :func:`live_axis`.  A :class:`Mesh` names the
axes of a numpy array of ``torch.device`` s, as ``jax.sharding.Mesh``
names an array of JAX devices.  With no devices given, a mesh takes the
visible CUDA devices and raises when there are none; the tests pass
``devices=[torch.device("cpu")]``.  A program over a mesh of more than
one device (``torch.distributed``) is not ported: its consumers raise
on one (:func:`check_one_device`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import MXNetError, not_ported

__all__ = ["Mesh", "make_mesh", "default_mesh", "serving_mesh",
           "current_mesh", "mesh_scope", "live_axis", "shard_map_compat",
           "check_one_device"]

_CURRENT = []


class Mesh:
    """``devices`` (a numpy array of ``torch.device``) with one name per
    axis: ``shape`` maps each name to its size, ``size`` is the device
    count."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise MXNetError("Mesh: %d axis names for a %d-D device array"
                             % (len(self.axis_names), devices.ndim))

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, list(self.devices.ravel()))


def _visible_devices():
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[dict] = None, devices=None) -> Mesh:
    """A :class:`Mesh`.  ``shape`` maps axis name -> size; the sizes must
    multiply to the device count, and one of them may be -1 ("the rest
    of the devices"): ``{"dp": -1}`` is every device on one axis."""
    if devices is None:
        devices = _visible_devices()
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if not shape:
        shape = {"dp": n}
    names = list(shape.keys())
    sizes = list(shape.values())
    n_auto = sizes.count(-1)
    if n_auto > 1:
        raise MXNetError("At most one mesh axis may be -1")
    if n_auto == 1:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if n % known:
            raise MXNetError("Mesh %s does not divide %d devices"
                             % (shape, n))
        sizes[sizes.index(-1)] = n // known
    total = 1
    for s in sizes:
        total *= s
    if total != n:
        raise MXNetError("Mesh %s needs %d devices but %d are visible"
                         % (dict(zip(names, sizes)), total, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def default_mesh() -> Mesh:
    """All devices on one ``dp`` axis."""
    return make_mesh()


def serving_mesh(tp=1, devices=None) -> Mesh:
    """One ``tp`` axis over the first ``tp`` devices."""
    if devices is None:
        devices = _visible_devices()
    if tp < 1:
        raise MXNetError("serving_mesh: tp must be >= 1, got %r" % (tp,))
    if tp > len(devices):
        raise MXNetError("serving_mesh: tp=%d needs %d devices but only "
                         "%d are visible" % (tp, tp, len(devices)))
    return make_mesh({"tp": tp}, devices=list(devices)[:tp])


class mesh_scope:
    """Context manager setting the current mesh."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _CURRENT.append(self.mesh)
        return self.mesh

    def __exit__(self, *a):
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1] if _CURRENT else None


def live_axis(mesh, name):
    """``name`` if the mesh has that axis and it partitions (size > 1),
    else None."""
    if mesh is None or name not in mesh.axis_names:
        return None
    return name if mesh.shape[name] > 1 else None


def check_one_device(mesh, what):
    """The mesh's one device; raises ``not_ported`` for a mesh of more
    than one (a program across devices is not ported)."""
    if mesh.size != 1:
        raise not_ported("%s over a mesh of %d devices %s"
                         % (what, mesh.size, mesh.shape),
                         "mxnet_tpu.parallel (GSPMD over a jax Mesh)")
    return mesh.devices.ravel()[0]


def shard_map_compat(fn, *, mesh, in_specs, out_specs, axis_names=None,
                     check_vma=True):
    raise not_ported("shard_map_compat", "mxnet_tpu.parallel.mesh."
                     "shard_map_compat")


def __getattr__(name):
    """The reference's other names here (the ZeRO-1 helpers
    ``zero1_sharding``, ``opt_state_shardings``,
    ``init_sharded_opt_state``) are not ported."""
    if name.startswith("__"):
        raise AttributeError(name)
    raise not_ported("parallel.mesh.%s" % name, "mxnet_tpu.parallel.mesh")
