"""Run-time feature flags: ``mx.runtime.Features()``.

Port of ``mxnet_tpu/runtime.py`` (upstream ``python/mxnet/runtime.py``
over ``src/libinfo.cc``).  The flags describe this build, the PyTorch
and CUDA port: ``CUDA`` (a card is visible), ``CUDNN``, ``NVRTC`` (the
run-time compiler behind ``mx.rtc`` loads), ``NCCL``, ``TRITON``,
``BF16`` and so on.  ``TPU``, ``XLA`` and ``PALLAS`` are listed and
off.  Flags of parts the port does not have yet (``RECORDIO``,
``IMAGE_AUG``, ``DIST_KVSTORE``, ``AMP``, ``QUANTIZATION``) are off too.
Each flag is detected without building or compiling anything.
"""
from __future__ import annotations

import collections
import collections.abc
import importlib.util

import torch

__all__ = ["Feature", "Features", "feature_list"]

Feature = collections.namedtuple("Feature", ["name", "enabled"])
Feature.__doc__ = "A run-time feature flag (upstream ``LibFeature``)."


def _importable(name):
    return importlib.util.find_spec(name) is not None


def _nvrtc():
    from .kernels import _cuda_rt
    return _cuda_rt.nvrtc_available()


def _detect():
    import torch.distributed as dist
    checks = {
        "CPU": lambda: True,
        "CUDA": torch.cuda.is_available,
        "CUDNN": lambda: torch.backends.cudnn.is_available(),
        "NVRTC": _nvrtc,
        "NCCL": lambda: dist.is_available() and dist.is_nccl_available(),
        "TRITON": lambda: _importable("triton"),
        "TPU": lambda: False,
        "XLA": lambda: False,
        "PALLAS": lambda: False,
        "BF16": lambda: True,
        "INT64_TENSOR_SIZE": lambda: True,
        "ONNX": lambda: _importable("onnx"),
        "RECORDIO": lambda: False,
        "IMAGE_AUG": lambda: False,
        "DIST_KVSTORE": lambda: False,
        "AMP": lambda: False,
        "QUANTIZATION": lambda: False,
    }
    return {name: bool(fn()) for name, fn in checks.items()}


class Features(collections.abc.Mapping):
    """Mapping of feature name -> :class:`Feature` (upstream
    ``mx.runtime.Features()``).

    >>> mx.runtime.Features()["CPU"].enabled
    True
    >>> mx.runtime.Features().is_enabled("tpu")
    False
    """

    def __init__(self):
        self._feats = {n: Feature(n, e) for n, e in _detect().items()}

    def __getitem__(self, name):
        return self._feats[name]

    def __iter__(self):
        return iter(self._feats)

    def __len__(self):
        return len(self._feats)

    def __repr__(self):
        return "[%s]" % ", ".join(
            "%s %s" % ("✔" if f.enabled else "✖", f.name)
            for f in self._feats.values())

    def is_enabled(self, name: str) -> bool:
        """Whether the named feature is on (case-insensitive); an unknown
        name raises ``KeyError``, as upstream."""
        return self._feats[name.upper()].enabled


def feature_list():
    """List of :class:`Feature` (upstream ``mx.runtime.feature_list``)."""
    return list(Features().values())
