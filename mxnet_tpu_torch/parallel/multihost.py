"""Joining a job of several processes.

Port of ``mxnet_tpu/parallel/multihost.py``: :func:`initialize` reads
the launcher's ``DMLC_*`` environment (``DMLC_PS_ROOT_URI`` and
``DMLC_PS_ROOT_PORT`` for the rendezvous, ``DMLC_NUM_WORKER`` for the
process count, ``DMLC_WORKER_ID`` for this process) or takes them as
arguments, and joins the job through ``torch.distributed``'s ``gloo``
backend, which moves CPU tensors (one card runs no NCCL job of several
processes; NCCL comes with the multi-device work).  One process, or no
rendezvous in the environment, is a job of one.  :func:`rank`,
:func:`num_hosts` and :func:`local_devices` read the job.

``global_mesh`` and ``host_staged_put`` build meshes and sharded arrays
over several devices; they come with the multi-device work
(``ROADMAP.md`` item 7b).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..base import MXNetError, not_ported

__all__ = ["initialize", "shutdown", "is_initialized", "rank",
           "num_hosts", "local_devices"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the job (the reference's worker start-up against
    ``DMLC_PS_ROOT_URI``).  ``coordinator_address`` is ``host:port``;
    process 0 serves the rendezvous there."""
    global _initialized
    if _initialized:
        return
    if coordinator_address is None and "DMLC_PS_ROOT_URI" in os.environ:
        coordinator_address = "%s:%s" % (
            os.environ["DMLC_PS_ROOT_URI"],
            os.environ.get("DMLC_PS_ROOT_PORT", "9000"))
        num_processes = num_processes or int(
            os.environ.get("DMLC_NUM_WORKER", "1"))
        process_id = process_id if process_id is not None else int(
            os.environ.get("DMLC_WORKER_ID", "0"))
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            raise MXNetError(
                "multihost.initialize(process_id=%r) without a "
                "coordinator_address/num_processes — the launcher "
                "likely failed to export DMLC_PS_ROOT_URI; refusing "
                "to run as a lone single-host process" % process_id)
        _initialized = True
        return
    if num_processes is None or (num_processes > 1
                                 and process_id is None):
        raise MXNetError(
            "multihost.initialize(coordinator_address=...) needs "
            "num_processes and process_id too (or set DMLC_NUM_WORKER/"
            "DMLC_WORKER_ID like the launcher does)")
    if num_processes > 1:
        import torch.distributed as dist
        try:
            dist.init_process_group(
                "gloo", init_method="tcp://%s" % coordinator_address,
                world_size=num_processes, rank=process_id)
        except (RuntimeError, ValueError) as e:
            raise MXNetError("multihost.initialize() failed: %s" % e)
    _initialized = True


def shutdown():
    global _initialized
    if not _initialized:
        return
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def _group():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's index in the job (the kvstore's ``rank``)."""
    import torch.distributed as dist
    return dist.get_rank() if _group() else 0


def num_hosts() -> int:
    """The job's process count (the kvstore's ``num_workers``)."""
    import torch.distributed as dist
    return dist.get_world_size() if _group() else 1


def local_devices():
    """This process's devices: its CUDA devices, else the host."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def __getattr__(name):
    if name in ("global_mesh", "host_staged_put"):
        raise not_ported("parallel.multihost.%s (ROADMAP.md item 7b)"
                         % name, "mxnet_tpu.parallel.multihost")
    raise AttributeError(name)
