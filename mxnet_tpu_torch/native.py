"""ctypes bridge to the port's native runtime (``native_src/``).

Port of ``mxnet_tpu/native.py``.  The C++ sources under
``mxnet_tpu_torch/native_src/`` are the port's own copy of the
reference's ``native/src`` (RecordIO, the threaded JPEG/PNG decode and
augment pipeline, the dependency engine, pooled host storage, shm
segments, and their flat C ABI ``c_api.h``).  At first use ``g++``
builds them into ``kernels/_build/libmxnet_tpu_native-<hash>.so`` (the
hash covers the sources and the flags, so an edited source builds anew;
the build writes a temporary file and renames it, so processes that
build at once do not clash) and ``ctypes`` loads the library with the
reference's prototype table.

``available()`` is False when the library cannot be built (no ``g++``,
or no libjpeg/libpng headers), and callers take their pure-Python paths,
as in the reference.  Everything here runs on the host.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as _np

from .base import MXNetError

__all__ = ["available", "lib", "check_call", "RecordIOReader",
           "RecordIOWriter", "ImageRecordLoader", "imdecode",
           "decode_profile", "decode_profile_stats",
           "decode_profile_reset", "NativeEngine", "engine_stats",
           "Shm", "storage_stats", "features"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "native_src")
_OUT = os.path.join(_HERE, "kernels", "_build")
SOURCES = ("image_loader.cc", "engine.cc", "storage.cc", "c_api.cc")
HEADERS = ("c_api.h", "engine.h", "image_loader.h", "recordio.h",
           "storage.h")
FLAGS = ("-O3", "-std=c++14", "-fPIC", "-shared", "-pthread")
LIBS = ("-ljpeg", "-lpng", "-lrt")

_lib = None
_load_failed = False
_build_log = ""
_lock = threading.Lock()

_EngineFn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int)
_EngineDeleter = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_P = ctypes.POINTER

# Complete ctypes prototype table for the C ABI — one entry per function
# in native_src/c_api.h, applied to the loaded library in _load() (the
# reference's table, entry for entry).  Explicit argtypes/restype
# everywhere closes the 64-bit handle/size truncation class (a bare
# Python int passed where a pointer or size_t is expected silently
# truncates to c_int without them).
#
# Representation choices:
#   * `const char**` record out-params bind as POINTER(c_void_p) —
#     records are binary, c_char_p would NUL-truncate on read;
#   * `const uint8_t*` image buffers bind as c_char_p so Python bytes
#     pass without copying.
_PROTOTYPES = {
    # ----- error handling / libinfo
    "MXGetLastError": (ctypes.c_char_p, []),
    "MXLibInfoFeatures": (ctypes.c_char_p, []),
    # ----- RecordIO
    "MXRecordIOReaderCreate": (
        ctypes.c_int, [ctypes.c_char_p, _P(ctypes.c_void_p)]),
    "MXRecordIOReaderFree": (ctypes.c_int, [ctypes.c_void_p]),
    "MXRecordIOReaderReadRecord": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_void_p),
                       _P(ctypes.c_size_t)]),
    "MXRecordIOReaderSeek": (
        ctypes.c_int, [ctypes.c_void_p, ctypes.c_uint64]),
    "MXRecordIOReaderTell": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_uint64)]),
    "MXRecordIOWriterCreate": (
        ctypes.c_int, [ctypes.c_char_p, _P(ctypes.c_void_p)]),
    "MXRecordIOWriterFree": (ctypes.c_int, [ctypes.c_void_p]),
    "MXRecordIOWriterWriteRecord": (
        ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p,
                       ctypes.c_size_t]),
    "MXRecordIOWriterTell": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_uint64)]),
    # ----- threaded image pipeline
    "MXImageRecordLoaderCreate": (
        ctypes.c_int,
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P(ctypes.c_float),
         _P(ctypes.c_float), ctypes.c_float, ctypes.c_int, ctypes.c_int,
         _P(ctypes.c_void_p)]),
    "MXImageRecordLoaderCreateEx": (
        ctypes.c_int,
        [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P(ctypes.c_float),
         _P(ctypes.c_float), ctypes.c_float, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _P(ctypes.c_void_p)]),
    "MXImageRecordLoaderNext": (
        ctypes.c_int, [ctypes.c_void_p, _P(_P(ctypes.c_float)),
                       _P(_P(ctypes.c_float)), _P(ctypes.c_int),
                       _P(ctypes.c_int)]),
    "MXImageRecordLoaderReset": (ctypes.c_int, [ctypes.c_void_p]),
    "MXImageRecordLoaderNumSamples": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_int64)]),
    "MXImageRecordLoaderFree": (ctypes.c_int, [ctypes.c_void_p]),
    # ----- standalone image decode
    "MXImageDecode": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                       _P(ctypes.c_int), _P(ctypes.c_int),
                       _P(ctypes.c_int), _P(ctypes.c_uint8),
                       ctypes.c_size_t]),
    "MXImageDecodeAlloc": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                       _P(ctypes.c_int), _P(ctypes.c_int),
                       _P(ctypes.c_int), _P(_P(ctypes.c_uint8))]),
    "MXBufferFree": (ctypes.c_int, [ctypes.c_void_p]),
    "MXImageDecodeProfile": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, _P(ctypes.c_double)]),
    "MXImageDecodeProfileStats": (
        ctypes.c_int, [_P(ctypes.c_uint64), _P(ctypes.c_uint64),
                       _P(ctypes.c_uint64), _P(ctypes.c_uint64)]),
    "MXImageDecodeProfileReset": (ctypes.c_int, []),
    # ----- dependency engine
    "MXEngineInit": (ctypes.c_int, [ctypes.c_int, ctypes.c_int]),
    "MXEngineNewVar": (ctypes.c_int, [_P(ctypes.c_void_p)]),
    "MXEngineDeleteVar": (ctypes.c_int, [ctypes.c_void_p]),
    "MXEnginePushAsync": (
        ctypes.c_int, [_EngineFn, ctypes.c_void_p, _EngineDeleter,
                       _P(ctypes.c_void_p), ctypes.c_int,
                       _P(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
                       ctypes.c_char_p]),
    "MXEngineWaitForVar": (ctypes.c_int, [ctypes.c_void_p]),
    "MXEngineWaitForAll": (ctypes.c_int, []),
    "MXEngineVarVersion": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_uint64)]),
    "MXEngineStats": (
        ctypes.c_int, [_P(ctypes.c_uint64), _P(ctypes.c_uint64),
                       _P(ctypes.c_uint64), _P(ctypes.c_uint64),
                       _P(ctypes.c_uint64), _P(ctypes.c_uint64)]),
    # ----- pooled host storage
    "MXStorageAlloc": (
        ctypes.c_int, [ctypes.c_size_t, _P(ctypes.c_void_p)]),
    "MXStorageFree": (ctypes.c_int, [ctypes.c_void_p]),
    "MXStorageReleaseAll": (ctypes.c_int, []),
    "MXStorageStats": (
        ctypes.c_int, [_P(ctypes.c_uint64), _P(ctypes.c_uint64),
                       _P(ctypes.c_uint64)]),
    # ----- shm segments
    "MXShmCreate": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t,
                       _P(ctypes.c_void_p)]),
    "MXShmAttach": (
        ctypes.c_int, [ctypes.c_char_p, _P(ctypes.c_void_p)]),
    "MXShmData": (
        ctypes.c_int, [ctypes.c_void_p, _P(ctypes.c_void_p),
                       _P(ctypes.c_size_t)]),
    "MXShmUnlink": (ctypes.c_int, [ctypes.c_void_p]),
    "MXShmFree": (ctypes.c_int, [ctypes.c_void_p]),
}


def _apply_prototypes(lib_handle):
    """Set argtypes/restype from _PROTOTYPES on every bound symbol;
    returns the names the library does not export."""
    missing = []
    for name, (restype, argtypes) in _PROTOTYPES.items():
        try:
            fn = getattr(lib_handle, name)
        except AttributeError:
            missing.append(name)
            continue
        fn.restype = restype
        fn.argtypes = argtypes
    return missing


def library_path():
    """Where the library is (or will be) built: its name hashes the
    sources, the headers and the flags."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(_OUT, "libmxnet_tpu_native-%s.so"
                        % h.hexdigest()[:16])


def build_log():
    """``g++``'s output of the last failed build in this process ("" if
    none failed)."""
    return _build_log


def _build():
    """The library's path, built with ``g++`` unless it exists; None
    when the build fails (its output kept for :func:`build_log`)."""
    global _build_log
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_OUT, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    cmd = ["g++", *FLAGS, "-o", tmp,
           *[os.path.join(_SRC_DIR, s) for s in SOURCES], *LIBS]
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_log = str(e)
        return None
    if out.returncode != 0:
        _build_log = out.stdout.decode(errors="replace")
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _load_failed, _build_log
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _build()
        try:
            lib_handle = None if so is None else ctypes.CDLL(so)
        except OSError as e:            # built elsewhere, or its libraries
            os.remove(so)               # are missing: build here once
            so = _build()
            try:
                lib_handle = None if so is None else ctypes.CDLL(so)
            except OSError as e2:
                _build_log = "%s; after a rebuild: %s" % (e, e2)
                lib_handle = None
        if lib_handle is None:
            _load_failed = True
            return None
        missing = _apply_prototypes(lib_handle)
        if missing:
            raise MXNetError("native library %s lacks %s"
                             % (so, ", ".join(missing)))
        _lib = lib_handle
    return _lib


def available() -> bool:
    return _load() is not None


def lib():
    l = _load()
    if l is None:
        raise MXNetError("native library unavailable (g++ with libjpeg and "
                         "libpng headers builds it): %s" % _build_log)
    return l


def check_call(ret: int):
    """Raise the thread-local native error on nonzero return (reference:
    ``base.check_call``)."""
    if ret != 0:
        raise MXNetError(lib().MXGetLastError().decode("utf-8"))


def features():
    """Native feature list (reference: ``mx.runtime.Features()`` backing
    ``src/libinfo.cc``)."""
    if not available():
        return []
    return lib().MXLibInfoFeatures().decode("utf-8").split(",")


# ---------------------------------------------------------------- RecordIO --
class RecordIOReader:
    """Native sequential RecordIO reader (drop-in for the hot path of
    ``recordio.MXRecordIO`` reads)."""

    def __init__(self, path):
        self.handle = ctypes.c_void_p()
        check_call(lib().MXRecordIOReaderCreate(
            path.encode(), ctypes.byref(self.handle)))

    def read(self):
        out = ctypes.c_void_p()
        size = ctypes.c_size_t()
        check_call(lib().MXRecordIOReaderReadRecord(
            self.handle, ctypes.byref(out), ctypes.byref(size)))
        if not out:          # NULL pointer → EOF
            return None
        return ctypes.string_at(out, size.value)

    def seek(self, offset):
        check_call(lib().MXRecordIOReaderSeek(
            self.handle, ctypes.c_uint64(offset)))

    def tell(self):
        out = ctypes.c_uint64()
        check_call(lib().MXRecordIOReaderTell(self.handle, ctypes.byref(out)))
        return out.value

    def close(self):
        if self.handle:
            lib().MXRecordIOReaderFree(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RecordIOWriter:
    def __init__(self, path):
        self.handle = ctypes.c_void_p()
        check_call(lib().MXRecordIOWriterCreate(
            path.encode(), ctypes.byref(self.handle)))

    def write(self, buf):
        buf = bytes(buf)
        check_call(lib().MXRecordIOWriterWriteRecord(
            self.handle, buf, ctypes.c_size_t(len(buf))))

    def tell(self):
        out = ctypes.c_uint64()
        check_call(lib().MXRecordIOWriterTell(self.handle, ctypes.byref(out)))
        return out.value

    def close(self):
        if self.handle:
            lib().MXRecordIOWriterFree(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------- image pipeline --
class ImageRecordLoader:
    """Threaded native decode+augment pipeline over a ``.rec``/``.idx`` pair
    (reference: ``ImageRecordIOParser2`` — SURVEY.md §3.5)."""

    def __init__(self, rec_path, idx_path, batch_size, data_shape,
                 num_threads=4, shuffle=False, seed=0, part_index=0,
                 num_parts=1, rand_crop=False, rand_mirror=False,
                 resize=0, label_width=1, mean=None, std=None, scale=1.0,
                 layout="NCHW", round_batch=True, dct_scale=True):
        c, h, w = data_shape
        self._shape = (batch_size, c, h, w) if layout == "NCHW" \
            else (batch_size, h, w, c)
        self._label_shape = (batch_size, label_width) if label_width > 1 \
            else (batch_size,)
        self.batch_size = batch_size
        mean_arr = (ctypes.c_float * 3)(*(mean or (0.0, 0.0, 0.0)))
        std_arr = (ctypes.c_float * 3)(*(std or (1.0, 1.0, 1.0)))
        self.handle = ctypes.c_void_p()
        check_call(lib().MXImageRecordLoaderCreateEx(
            rec_path.encode(), idx_path.encode(), batch_size, h, w, c,
            num_threads, int(shuffle), ctypes.c_uint64(seed), part_index,
            num_parts, int(rand_crop), int(rand_mirror), int(resize),
            label_width, mean_arr, std_arr, ctypes.c_float(scale),
            int(layout == "NHWC"), int(round_batch), int(dct_scale),
            ctypes.byref(self.handle)))

    @property
    def num_samples(self):
        out = ctypes.c_int64()
        check_call(lib().MXImageRecordLoaderNumSamples(
            self.handle, ctypes.byref(out)))
        return out.value

    def next(self):
        """Returns ``(data, label, pad)`` numpy views (valid until the next
        call) or None at epoch end."""
        data = ctypes.POINTER(ctypes.c_float)()
        label = ctypes.POINTER(ctypes.c_float)()
        pad = ctypes.c_int()
        bs = ctypes.c_int()
        check_call(lib().MXImageRecordLoaderNext(
            self.handle, ctypes.byref(data), ctypes.byref(label),
            ctypes.byref(pad), ctypes.byref(bs)))
        if bs.value == 0:
            return None
        n = 1
        for d in self._shape:
            n *= d
        data_np = _np.ctypeslib.as_array(data, shape=(n,)).reshape(self._shape)
        ln = 1
        for d in self._label_shape:
            ln *= d
        label_np = _np.ctypeslib.as_array(label, shape=(ln,)).reshape(
            self._label_shape)
        return data_np, label_np, pad.value

    def reset(self):
        check_call(lib().MXImageRecordLoaderReset(self.handle))

    def close(self):
        if self.handle:
            lib().MXImageRecordLoaderFree(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def imdecode(buf):
    """Native JPEG/PNG decode → HWC uint8 numpy array (reference:
    ``mx.image.imdecode`` backed by OpenCV; here libjpeg/libpng).
    Single decode pass via MXImageDecodeAlloc."""
    buf = bytes(buf)
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    check_call(lib().MXImageDecodeAlloc(
        buf, len(buf), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
        ctypes.byref(ptr)))
    try:
        n = h.value * w.value * c.value
        out = _np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
            (h.value, w.value, c.value)).copy()
    finally:
        lib().MXBufferFree(ptr)
    return out


def decode_profile(buf, reps=20, min_short=0):
    """Per-stage JPEG decode timing: returns
    {"huffman_ms", "ycbcr_ms", "rgb_ms", "scaled_ms"} — mean ms over
    ``reps``.  IDCT cost ~= ycbcr - huffman; colorspace conversion
    ~= rgb - ycbcr; ``scaled_ms`` is the full RGB path with the
    min_short-guarded DCT-domain downscale (== rgb_ms when the guard
    disallows scaling)."""
    buf = bytes(buf)
    out = (ctypes.c_double * 4)()
    check_call(lib().MXImageDecodeProfile(
        buf, ctypes.c_size_t(len(buf)), int(reps), int(min_short), out))
    return {"huffman_ms": out[0], "ycbcr_ms": out[1],
            "rgb_ms": out[2], "scaled_ms": out[3]}


def decode_profile_stats():
    """Cumulative decode counters across ``imdecode`` and the threaded
    loader workers: successful jpeg/png decodes, decodes where the
    DCT-domain downscale engaged, and failures.  Resettable via
    ``decode_profile_reset``, for per-interval rates."""
    j = ctypes.c_uint64()
    p = ctypes.c_uint64()
    d = ctypes.c_uint64()
    e = ctypes.c_uint64()
    check_call(lib().MXImageDecodeProfileStats(
        ctypes.byref(j), ctypes.byref(p), ctypes.byref(d),
        ctypes.byref(e)))
    return {"jpeg": j.value, "png": p.value, "dct_scaled": d.value,
            "errors": e.value}


def decode_profile_reset():
    check_call(lib().MXImageDecodeProfileReset())


# ------------------------------------------------------------------ engine --
_engine_initialized = False


class NativeEngine:
    """Binding to the C++ threaded dependency engine (reference semantics:
    ``Engine::PushAsync`` with const/mutate var sets, versioned vars,
    deferred exceptions — SURVEY.md §2.1 "Engine").

    The underlying engine is process-global (like ``Engine::Get()``).  With
    default arguments, constructing a binding attaches to the existing
    engine; passing an explicit ``engine_type``/``num_workers`` RESETS the
    process engine (draining outstanding ops first) — the reference
    equivalent of restarting with a different ``MXNET_ENGINE_TYPE``.
    """

    def __init__(self, engine_type=None, num_workers=0):
        global _engine_initialized
        if engine_type is not None or num_workers or not _engine_initialized:
            check_call(lib().MXEngineInit(
                1 if engine_type == "naive" else 0, num_workers))
            _engine_initialized = True
        self._callbacks = []  # keep ctypes thunks alive until completion
        self._cb_lock = threading.Lock()

    def new_var(self):
        out = ctypes.c_void_p()
        check_call(lib().MXEngineNewVar(ctypes.byref(out)))
        return out

    def delete_var(self, var):
        check_call(lib().MXEngineDeleteVar(var))

    def push(self, fn, const_vars=(), mutate_vars=(), priority=0, name="op"):
        """Push a Python callable; exceptions raised by ``fn`` become
        deferred engine errors surfacing at wait_* (async exception
        semantics of the reference)."""
        holder = {}

        def _thunk(_param, err_buf, err_len):
            try:
                fn()
                return 0
            except Exception as e:  # deferred: stored on mutate vars
                msg = ("%s: %s" % (type(e).__name__, e)).encode()[:err_len - 1]
                ctypes.memmove(err_buf, msg + b"\x00", len(msg) + 1)
                return -1
            finally:
                with self._cb_lock:
                    self._callbacks.remove(holder["cb"])

        cb = _EngineFn(_thunk)
        holder["cb"] = cb
        with self._cb_lock:
            self._callbacks.append(cb)
        n_c, n_m = len(const_vars), len(mutate_vars)
        c_arr = (ctypes.c_void_p * max(n_c, 1))(*const_vars)
        m_arr = (ctypes.c_void_p * max(n_m, 1))(*mutate_vars)
        check_call(lib().MXEnginePushAsync(
            cb, None, ctypes.cast(None, _EngineDeleter), c_arr, n_c,
            m_arr, n_m, priority, name.encode()))

    def wait_for_var(self, var):
        check_call(lib().MXEngineWaitForVar(var))

    def wait_for_all(self):
        check_call(lib().MXEngineWaitForAll())

    def var_version(self, var):
        out = ctypes.c_uint64()
        check_call(lib().MXEngineVarVersion(var, ctypes.byref(out)))
        return out.value

    def stats(self):
        return engine_stats()


def engine_stats():
    """Dependency-engine telemetry: ops dispatched/executed,
    worker condition-variable wakeups that found work, instantaneous
    ready-queue depth, in-flight op count, and worker-thread count
    (0 under NaiveEngine).  Counters are process-lifetime monotonic."""
    vals = [ctypes.c_uint64() for _ in range(6)]
    check_call(lib().MXEngineStats(*[ctypes.byref(v) for v in vals]))
    keys = ("ops_dispatched", "ops_executed", "worker_wakeups",
            "queue_depth", "outstanding", "workers")
    return dict(zip(keys, (v.value for v in vals)))


# ----------------------------------------------------------------- storage --
def storage_alloc(size):
    out = ctypes.c_void_p()
    check_call(lib().MXStorageAlloc(ctypes.c_size_t(size), ctypes.byref(out)))
    return out


def storage_free(ptr):
    check_call(lib().MXStorageFree(ptr))


def storage_release_all():
    check_call(lib().MXStorageReleaseAll())


def storage_stats():
    a = ctypes.c_uint64()
    p = ctypes.c_uint64()
    n = ctypes.c_uint64()
    check_call(lib().MXStorageStats(ctypes.byref(a), ctypes.byref(p),
                                    ctypes.byref(n)))
    return {"allocated": a.value, "pooled": p.value, "num_allocs": n.value}


# --------------------------------------------------------------------- shm --
class Shm:
    """Named shm segment (reference: ``cpu_shared_storage_manager.h`` —
    DataLoader workers pass batches through these without pickling)."""

    def __init__(self, name, size=0, create=False):
        self.handle = ctypes.c_void_p()
        if create:
            check_call(lib().MXShmCreate(name.encode(),
                                         ctypes.c_size_t(size),
                                         ctypes.byref(self.handle)))
        else:
            check_call(lib().MXShmAttach(name.encode(),
                                         ctypes.byref(self.handle)))
        self.name = name

    def asarray(self, shape, dtype=_np.float32):
        ptr = ctypes.c_void_p()
        size = ctypes.c_size_t()
        check_call(lib().MXShmData(self.handle, ctypes.byref(ptr),
                                   ctypes.byref(size)))
        n = int(_np.prod(shape))
        buf = (ctypes.c_char * size.value).from_address(ptr.value)
        # anchor the mapping: the view must keep this Shm alive, or the
        # segment unmaps under a live array when the handle is collected
        buf._shm_owner = self
        arr = _np.frombuffer(buf, dtype=dtype, count=n).reshape(shape)
        return arr

    def unlink(self):
        check_call(lib().MXShmUnlink(self.handle))

    def close(self):
        if self.handle:
            lib().MXShmFree(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
