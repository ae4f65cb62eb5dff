"""``ctypes`` bindings to NVRTC and the CUDA driver API, for ``mx.rtc``.

The reference has no counterpart module: there the run-time compiler is
Pallas.  Upstream MXNet's ``src/common/rtc.cc`` compiles user CUDA
source with NVRTC and launches it through the driver API; this module
does the same from Python:

* :func:`compile_source` runs ``nvrtcCreateProgram`` /
  ``nvrtcCompileProgram`` (``--gpu-architecture=sm_90a``, the toolkit's
  include directory, then the caller's options) and returns the CUBIN
  and the lowered names of the name expressions given
  (``nvrtcAddNameExpression`` / ``nvrtcGetLoweredName``); a failed
  compile raises ``MXNetError`` with the program log;
* :func:`load_module` loads a CUBIN into a device's primary context
  (the one PyTorch uses) and :func:`get_function` looks a kernel up;
* :func:`launch` sets the dynamic shared memory limit where a launch
  asks for more than 48 KB and calls ``cuLaunchKernel`` on the stream
  it is given (PyTorch's current one).

``libnvrtc`` is looked up under ``$CUDA_HOME/lib64``, then
``/usr/local/cuda/lib64``, then the ``nvidia/cuda_nvrtc/lib`` directory
of the installed CUDA wheels beside ``torch``, then the loader's path;
``libcuda.so.1`` comes from the driver, through the loader's path.
Either missing raises ``MXNetError``.  Nothing is loaded at import.
Every call makes the device's primary context current on the calling
thread first, so a launch from PyTorch's autograd thread works.
"""
from __future__ import annotations

import ctypes
import glob
import os
import threading

from ..base import MXNetError

__all__ = ["compile_source", "load_module", "get_function", "launch",
           "set_dynamic_shared", "cuda_home", "nvrtc_available"]

_lock = threading.Lock()
_nvrtc = None
_cuda = None
_contexts = {}        # device index -> CUcontext (primary, retained)

CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
CUDA_ERROR_NOT_FOUND = 500

_vp, _ci, _sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_cp = ctypes.c_char_p
_NVRTC_SIGS = {
    "nvrtcGetErrorString": ([_ci], _cp),
    "nvrtcCreateProgram": ([ctypes.POINTER(_vp), _cp, _cp, _ci,
                            ctypes.POINTER(_cp), ctypes.POINTER(_cp)], _ci),
    "nvrtcAddNameExpression": ([_vp, _cp], _ci),
    "nvrtcCompileProgram": ([_vp, _ci, ctypes.POINTER(_cp)], _ci),
    "nvrtcGetProgramLogSize": ([_vp, ctypes.POINTER(_sz)], _ci),
    "nvrtcGetProgramLog": ([_vp, _cp], _ci),
    "nvrtcGetCUBINSize": ([_vp, ctypes.POINTER(_sz)], _ci),
    "nvrtcGetCUBIN": ([_vp, _cp], _ci),
    "nvrtcGetLoweredName": ([_vp, _cp, ctypes.POINTER(_cp)], _ci),
    "nvrtcDestroyProgram": ([ctypes.POINTER(_vp)], _ci),
}
_CUDA_SIGS = {
    "cuInit": ([ctypes.c_uint], _ci),
    "cuGetErrorString": ([_ci, ctypes.POINTER(_cp)], _ci),
    "cuDeviceGet": ([ctypes.POINTER(_ci), _ci], _ci),
    "cuDevicePrimaryCtxRetain": ([ctypes.POINTER(_vp), _ci], _ci),
    "cuCtxSetCurrent": ([_vp], _ci),
    "cuModuleLoadData": ([ctypes.POINTER(_vp), _vp], _ci),
    "cuModuleGetFunction": ([ctypes.POINTER(_vp), _vp, _cp], _ci),
    "cuFuncSetAttribute": ([_vp, _ci, _ci], _ci),
    "cuLaunchKernel": ([_vp] + [ctypes.c_uint] * 7 + [_vp, _vp, _vp], _ci),
}


def cuda_home():
    """The CUDA toolkit's root: ``$CUDA_HOME`` or ``/usr/local/cuda``
    where it exists, else None."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isdir(cand):
            return cand
    return None


def _nvrtc_candidates():
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            yield from sorted(glob.glob(os.path.join(home, "lib64",
                                                     "libnvrtc.so*")))
    try:
        import nvidia.cuda_nvrtc as wheel   # the CUDA wheels beside torch
        for d in wheel.__path__:
            yield from sorted(glob.glob(os.path.join(d, "lib",
                                                     "libnvrtc.so*")))
    except ImportError:
        pass
    yield "libnvrtc.so"
    yield "libnvrtc.so.12"


def _bind(lib, sigs):
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def _load_nvrtc():
    """The bound NVRTC library, loaded on first use."""
    global _nvrtc
    if _nvrtc is None:
        tried = []
        for path in _nvrtc_candidates():
            try:
                _nvrtc = _bind(ctypes.CDLL(path), _NVRTC_SIGS)
                break
            except (OSError, AttributeError) as e:
                tried.append("%s (%s)" % (path, e))
        if _nvrtc is None:
            raise MXNetError("rtc: libnvrtc not found; tried %s"
                             % "; ".join(tried))
    return _nvrtc


def nvrtc_available():
    """Whether NVRTC loads (nothing is compiled)."""
    try:
        with _lock:
            _load_nvrtc()
        return True
    except MXNetError:
        return False


def _libs():
    """(nvrtc, cuda), loaded and bound on first use."""
    global _cuda
    with _lock:
        _load_nvrtc()
        if _cuda is None:
            try:
                cuda = _bind(ctypes.CDLL("libcuda.so.1"), _CUDA_SIGS)
            except OSError as e:
                raise MXNetError("rtc: the CUDA driver (libcuda.so.1) is not "
                                 "available: %s" % e)
            _check_cu(cuda, cuda.cuInit(0), "cuInit")
            _cuda = cuda
    return _nvrtc, _cuda


def _check_nvrtc(nvrtc, res, what):
    if res != 0:
        raise MXNetError("rtc: %s failed: %s" % (
            what, nvrtc.nvrtcGetErrorString(res).decode()))


def _check_cu(cuda, res, what):
    if res != 0:
        msg = _cp()
        cuda.cuGetErrorString(res, ctypes.byref(msg))
        raise MXNetError("rtc: %s failed with CUDA error %d: %s" % (
            what, res, msg.value.decode() if msg.value else "unknown"))


def _strings(items):
    return (_cp * len(items))(*[s.encode() for s in items])


def compile_source(source, options=(), names=()):
    """Compile CUDA C++ ``source`` for sm_90a with NVRTC: (CUBIN bytes,
    {name expression: lowered name} for ``names``).  A failed compile
    raises ``MXNetError`` carrying the program log."""
    nvrtc, _ = _libs()
    prog = _vp()
    _check_nvrtc(nvrtc, nvrtc.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"rtc_source.cu", 0, None, None),
        "nvrtcCreateProgram")
    try:
        for n in names:
            _check_nvrtc(nvrtc, nvrtc.nvrtcAddNameExpression(prog, n.encode()),
                         "nvrtcAddNameExpression(%r)" % n)
        opts = ["--gpu-architecture=sm_90a"]
        home = cuda_home()
        if home and os.path.isdir(os.path.join(home, "include")):
            opts.append("-I" + os.path.join(home, "include"))
        opts += list(options)
        res = nvrtc.nvrtcCompileProgram(prog, len(opts), _strings(opts))
        size = _sz()
        nvrtc.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(max(size.value, 1))
        nvrtc.nvrtcGetProgramLog(prog, log)
        if res != 0:
            raise MXNetError("rtc: NVRTC compilation failed (%s):\n%s" % (
                nvrtc.nvrtcGetErrorString(res).decode(),
                log.value.decode(errors="replace")))
        _check_nvrtc(nvrtc, nvrtc.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(nvrtc, nvrtc.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        lowered = {}
        for n in names:
            out = _cp()
            _check_nvrtc(nvrtc, nvrtc.nvrtcGetLoweredName(
                prog, n.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%r)" % n)
            lowered[n] = out.value.decode()
        return cubin.raw, lowered
    finally:
        nvrtc.nvrtcDestroyProgram(ctypes.byref(prog))


def _make_current(device):
    """Make ``device``'s primary context (PyTorch's) current on this
    thread; returns the driver library."""
    _, cuda = _libs()
    ctx = _contexts.get(device)
    if ctx is None:
        with _lock:
            ctx = _contexts.get(device)
            if ctx is None:
                dev = _ci()
                _check_cu(cuda, cuda.cuDeviceGet(ctypes.byref(dev), device),
                          "cuDeviceGet")
                ctx = _vp()
                _check_cu(cuda, cuda.cuDevicePrimaryCtxRetain(
                    ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
                _contexts[device] = ctx
    _check_cu(cuda, cuda.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return cuda


def load_module(cubin, device):
    """A CUmodule of ``cubin`` in ``device``'s primary context."""
    cuda = _make_current(device)
    mod = _vp()
    buf = ctypes.create_string_buffer(cubin, len(cubin))
    _check_cu(cuda, cuda.cuModuleLoadData(ctypes.byref(mod), buf),
              "cuModuleLoadData")
    return mod


def get_function(module, name, device):
    """The CUfunction ``name`` (a lowered name for C++ kernels) of
    ``module``; raises ``MXNetError`` when the module has none."""
    cuda = _make_current(device)
    fn = _vp()
    res = cuda.cuModuleGetFunction(ctypes.byref(fn), module, name.encode())
    if res == CUDA_ERROR_NOT_FOUND:
        raise MXNetError(
            "rtc: cannot find CUDA kernel %r; declare it extern \"C\" or "
            "name it in the module's exports" % name)
    _check_cu(cuda, res, "cuModuleGetFunction(%r)" % name)
    return fn


def set_dynamic_shared(function, nbytes, device):
    """Allow ``function`` up to ``nbytes`` of dynamic shared memory."""
    cuda = _make_current(device)
    _check_cu(cuda, cuda.cuFuncSetAttribute(
        function, CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, nbytes),
        "cuFuncSetAttribute(max dynamic shared memory = %d)" % nbytes)


def launch(function, grid, block, shared_mem, stream, params, device):
    """``cuLaunchKernel`` with ``params`` (a ctypes array of pointers to
    each argument's value) on ``stream`` (a ``cudaStream_t`` as an int)."""
    cuda = _make_current(device)
    _check_cu(cuda, cuda.cuLaunchKernel(
        function, grid[0], grid[1], grid[2], block[0], block[1], block[2],
        shared_mem, stream, params, None), "cuLaunchKernel")
