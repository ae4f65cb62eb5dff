"""Parallelism: device meshes, ``DataParallelTrainer``, the parameter
server and the job of several processes.

Port of ``mxnet_tpu/parallel/__init__.py`` for one device, with
``dist`` (the ``dist_*`` stores), ``compression`` (2-bit),
``multihost``, the sharded checkpoints (``checkpoint``, written with
``torch.distributed.checkpoint``) and the Mixture-of-Experts FFN
(``moe``).  Ring and Ulysses attention, the pipeline and expert
parallelism are not ported; their names raise ``NotImplementedError``.
"""
from .mesh import (Mesh, make_mesh, default_mesh,  # noqa: F401
                   serving_mesh, current_mesh, mesh_scope, live_axis,
                   shard_map_compat)
from .data_parallel import DataParallelTrainer  # noqa: F401
from .moe import init_moe_ffn, moe_ffn  # noqa: F401
from . import multihost  # noqa: F401
from .checkpoint import (save_sharded, restore_sharded,  # noqa: F401
                         latest_step)
from ..base import not_ported as _not_ported


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise _not_ported("parallel.%s" % name, "mxnet_tpu.parallel")
