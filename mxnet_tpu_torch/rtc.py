"""Run-time compiled CUDA kernels: MXNet 1.x's ``CudaModule`` /
``CudaKernel``.

Port of ``mxnet_tpu/rtc.py``, whose ``PallasModule`` / ``PallasKernel``
compile user Pallas kernels and name upstream MXNet's ``CudaModule`` as
their counterpart.  On the card the faithful API is upstream's own
(``python/mxnet/rtc.py`` over ``src/common/rtc.cc``): CUDA C++ source
compiled at run time with NVRTC (``kernels/_cuda_rt.py``) and launched
on NDArrays.  Pallas source cannot run on the card, so ``PallasModule``
and ``PallasKernel`` raise :class:`~mxnet_tpu_torch.base.NotPorted`.

Example (upstream's docstring)::

    source = r'''
    extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
        int i = threadIdx.x + blockIdx.x * blockDim.x;
        y[i] += alpha * x[i];
    }
    '''
    module = mx.rtc.CudaModule(source)
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    # y is now all 3

A module compiles its source when it is created (once per process for
each source, options and exports) and loads it into a device's context
at its first launch there; a compile error raises ``MXNetError`` with
the NVRTC log, and so does a launch of a kernel the module lacks.
Kernels launch on PyTorch's current stream and do not synchronise.
Each :class:`CudaKernel` counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import re
import threading

import numpy as np
import torch

from .base import MXNetError, not_ported, numeric_types
from .kernels._counters import register

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "PallasKernel",
           "parse_signature"]

# upstream python/mxnet/rtc.py _DTYPE_CPP_TO_NP
DTYPE_CPP_TO_NP = {
    "float": np.float32,
    "double": np.float64,
    "__half": np.float16,
    "uint8_t": np.uint8,
    "int": np.int32,
    "int32_t": np.int32,
    "int8_t": np.int8,
    "char": np.int8,
    "int64_t": np.int64,
}

_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

_compiled = {}          # (source, options, exports) -> (cubin, lowered)
_compile_lock = threading.Lock()


def parse_signature(signature):
    """``[(is_ndarray, is_const, numpy dtype), ...]`` of a signature
    written as a comma-separated list of ``(const) type (*) (name)``:
    ``*`` marks an NDArray argument and ``const`` an input.  A malformed
    entry raises ``ValueError``, an unsupported type ``TypeError``."""
    args = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        match = _ARG.match(arg)
        if not match or match.group(2) == "const":
            raise ValueError(
                'Invalid function prototype "%s". Must be in the form of '
                '"(const) type (*) (name)"' % arg)
        const, ctype, star = match.group(1), match.group(2), match.group(3)
        if ctype not in DTYPE_CPP_TO_NP:
            raise TypeError(
                "Unsupported kernel argument type %s. Supported types are: "
                "%s." % (arg, ",".join(DTYPE_CPP_TO_NP)))
        args.append((bool(star), bool(const), np.dtype(DTYPE_CPP_TO_NP[ctype])))
    return args


class _Compiled:
    """One compiled source: its CUBIN, lowered names and, per device, the
    loaded module and its functions."""

    def __init__(self, cubin, lowered):
        self.cubin = cubin
        self.lowered = lowered
        self.modules = {}
        self.functions = {}
        self.shared = {}      # (device, name) -> dynamic shared bytes allowed
        self.lock = threading.Lock()

    def function(self, name, device):
        from .kernels import _cuda_rt
        key = (device, name)
        fn = self.functions.get(key)
        if fn is None:
            with self.lock:
                if device not in self.modules:
                    self.modules[device] = _cuda_rt.load_module(self.cubin,
                                                                device)
                fn = _cuda_rt.get_function(self.modules[device], name, device)
                self.functions[key] = fn
        return fn

    def allow_shared(self, fn, name, nbytes, device):
        from .kernels import _cuda_rt
        key = (device, name)
        if nbytes > 48 * 1024 and self.shared.get(key, 0) < nbytes:
            _cuda_rt.set_dynamic_shared(fn, nbytes, device)
            self.shared[key] = nbytes


class CudaModule:
    """CUDA C++ source compiled at run time with NVRTC for sm_90a
    (upstream ``mx.rtc.CudaModule``).

    ``options`` are extra NVRTC options (``-D...``, ``--use_fast_math``);
    ``exports`` name kernels that are not ``extern "C"`` (their C++ name
    expressions, e.g. ``"scale<float>"``), looked up by lowered name."""

    def __init__(self, source, options=(), exports=()):
        from .kernels import _cuda_rt
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._exports = tuple(exports)
        key = (source, tuple(options), self._exports)
        with _compile_lock:
            compiled = _compiled.get(key)
            if compiled is None:
                compiled = _Compiled(*_cuda_rt.compile_source(
                    source, options, self._exports))
                _compiled[key] = compiled
        self._compiled = compiled

    def get_kernel(self, name, signature):
        """The kernel ``name`` with its argument ``signature`` (see
        :func:`parse_signature`)."""
        lowered = self._compiled.lowered.get(name, name)
        return CudaKernel(self._compiled, name, parse_signature(signature),
                          lowered)


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule` (upstream
    ``mx.rtc.CudaKernel``)."""

    def __init__(self, compiled, name, signature, lowered=None):
        self._compiled = compiled
        self.name = name
        self._lowered = lowered or name
        self._signature = signature
        register(self, "launches")

    def _params(self, args, device):
        """The launch's argument values, checked against the signature,
        and a ctypes array of pointers to them."""
        if len(args) != len(self._signature):
            raise MXNetError("CudaKernel(%s) expects %d arguments but got %d"
                             % (self.name, len(self._signature), len(args)))
        from .ndarray.ndarray import NDArray
        values = []
        for i, (arg, (is_nd, _, dtype)) in enumerate(zip(args,
                                                         self._signature)):
            if is_nd:
                if not isinstance(arg, NDArray):
                    raise MXNetError(
                        "The %d-th argument of %s is expected to be an "
                        "NDArray but got %s" % (i, self.name, type(arg)))
                if arg.dtype != dtype:
                    raise MXNetError(
                        "The %d-th argument of %s is declared %s but the "
                        "NDArray holds %s" % (i, self.name, dtype, arg.dtype))
                t = arg._data
                if device is not None and (t.device.type != "cuda"
                                           or t.device.index != device):
                    raise MXNetError(
                        "The %d-th argument of %s lies on %s, not on the "
                        "launch's gpu(%d)" % (i, self.name, arg.context,
                                              device))
                if not t.is_contiguous():
                    raise MXNetError("The %d-th argument of %s is not "
                                     "contiguous" % (i, self.name))
                values.append(ctypes.c_void_p(t.data_ptr()))
            else:
                if isinstance(arg, bool) or not isinstance(
                        arg, numeric_types + (np.generic,)):
                    raise MXNetError(
                        "The %d-th argument of %s is expected to be a number "
                        "but got %s" % (i, self.name, type(arg)))
                values.append(np.array(arg, dtype=dtype))
        ptrs = (ctypes.c_void_p * max(len(values), 1))()
        for i, v in enumerate(values):
            ptrs[i] = (ctypes.addressof(v) if isinstance(v, ctypes.c_void_p)
                       else v.ctypes.data)
        return values, ptrs

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a gpu context) with ``args`` in the
        signature's order: NDArrays where it has pointers, numbers where
        it has values.  ``grid_dims`` and ``block_dims`` are 3-tuples;
        ``shared_mem`` is the dynamic shared memory in bytes."""
        if len(grid_dims) != 3 or len(block_dims) != 3:
            raise MXNetError("grid_dims and block_dims must be tuples of 3 "
                             "integers, got %r and %r"
                             % (grid_dims, block_dims))
        gpu = getattr(ctx, "device_type", None) == "gpu"
        # ``values`` owns the buffers ``ptrs`` points into; it lives to the
        # end of this call, after cuLaunchKernel has copied the arguments
        values, ptrs = self._params(args, ctx.device_id if gpu else None)
        if not gpu:
            raise MXNetError("CUDA kernel %s can only be launched on a gpu "
                             "context, not %s" % (self.name, ctx))
        from .kernels import _cuda_rt
        device = ctx.device_id
        fn = self._compiled.function(self._lowered, device)
        self._compiled.allow_shared(fn, self._lowered, int(shared_mem), device)
        stream = torch.cuda.current_stream(
            torch.device("cuda", device)).cuda_stream
        _cuda_rt.launch(fn, [int(d) for d in grid_dims],
                        [int(d) for d in block_dims], int(shared_mem),
                        stream, ptrs, device)
        self.launches += 1


class PallasModule:
    """Pallas kernels cannot run on the card: use :class:`CudaModule`."""

    def __init__(self, *args, **kwargs):
        raise not_ported("rtc.PallasModule (Pallas source)",
                         "mxnet_tpu.rtc.PallasModule; use rtc.CudaModule")


class PallasKernel:
    """Pallas kernels cannot run on the card: use :class:`CudaKernel`."""

    def __init__(self, *args, **kwargs):
        raise not_ported("rtc.PallasKernel (Pallas source)",
                         "mxnet_tpu.rtc.PallasKernel; use rtc.CudaKernel")
