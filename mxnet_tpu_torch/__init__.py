"""PyTorch/CUDA port of ``mxnet_tpu`` for NVIDIA Hopper (H100).

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module names (``models/gpt.py``, ``kernels/paged_attention.py``,
``serving/engine.py``, ...) so each counterpart is easy to find.  It
imports ``torch``, numpy and the standard library only.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise
instead of quietly dropping to the CPU (:func:`resolve_device`).  On a
CPU tensor every kernel wrapper runs its plain PyTorch version; on a
CUDA tensor it launches the hand-written kernel or raises.

The MXNet surface reads as in the reference, ``import mxnet_tpu_torch
as mx``: ``mx.nd``, ``mx.autograd``, ``mx.gluon``, ``mx.init`` /
``mx.initializer``, ``mx.optimizer``, ``mx.operator`` (CustomOp),
``mx.rtc`` (CUDA source compiled at run time), ``mx.runtime``,
``mx.library``, ``mx.contrib.amp``, ``mx.parallel``
(``DataParallelTrainer``), ``mx.cpu()`` and ``mx.gpu(i)``; the default
context is the card.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.

    ``None`` means the current CUDA device and raises when there is
    none; an explicit ``"cuda"``/``"cuda:N"`` raises when CUDA is not
    available; ``"cpu"`` is always allowed (the tests use it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mxnet_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("mxnet_tpu_torch: device=%r but CUDA is "
                               "not available" % (str(device),))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("mxnet_tpu_torch: unsupported device %r"
                         % (str(device),))
    return dev


from . import base  # noqa: E402
from .base import MXNetError  # noqa: E402,F401
from .context import Context, cpu, gpu, current_context  # noqa: E402,F401
from . import operator  # noqa: E402  (registers Custom before nd is filled)
from . import ndarray  # noqa: E402
from . import ndarray as nd  # noqa: E402
from . import autograd, initializer, optimizer, gluon  # noqa: E402
from . import initializer as init  # noqa: E402
from . import runtime, library, rtc  # noqa: E402
from . import contrib, parallel  # noqa: E402
