"""Parallelism: device meshes and ``DataParallelTrainer``.

Port of ``mxnet_tpu/parallel/__init__.py`` for one device.  Ring and
Ulysses attention, the pipeline, MoE, sharded checkpoints and
``multihost`` are not ported; their names raise ``NotImplementedError``.
"""
from .mesh import (Mesh, make_mesh, default_mesh,  # noqa: F401
                   serving_mesh, current_mesh, mesh_scope, live_axis,
                   shard_map_compat)
from .data_parallel import DataParallelTrainer  # noqa: F401
from ..base import not_ported as _not_ported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("parallel.%s" % name, "mxnet_tpu.parallel")
