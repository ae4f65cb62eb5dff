"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``kernels/_build/`` (listed
in ``.gitignore``), then loaded with ``ctypes``.  No PyTorch header is
included, so a build takes seconds rather than minutes.  Libraries are
named by a hash of their source and flags, so an edited source builds
anew.  :func:`load` builds one source if needed; each source has its
own lock, so loads of different sources from several threads run their
``nvcc`` at once, and a file lock per library keeps several processes
from building the same one at once.  The hash covers every header of ``csrc/`` that a
source includes (``#include "x.cuh"``, followed transitively), so an
edited header builds anew too.  ``nvcc`` runs with ``-Xptxas -v``, and
its report (registers, spills and shared memory per kernel) is kept
beside the library (:func:`library_path`, :func:`ptxas_report`).

Nothing here runs at import: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading

__all__ = ["load", "source_hash", "library_path", "ptxas_report",
           "SOURCES"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(_HERE, "_build")

SOURCES = ("flash_fwd", "flash_bwd", "paged_attention", "fused_sgd",
           "fused_conv", "nms", "image_aug", "jpeg_color", "nvjpeg_codec")

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# libraries a source links beyond the CUDA runtime (nvJPEG: the codec of
# the CUDA toolkit)
LINK = {"nvjpeg_codec": ("-lnvjpeg",)}

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

_libs = {}
_locks = {name: threading.Lock() for name in SOURCES}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("mxnet_tpu_torch: nvcc not found (set "
                           "CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_dirs():
    """Directories holding the CUDA toolkit's libraries, for ``-L`` and
    the run path of a source that links one of them (``LINK``)."""
    out = []
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if not root:
            continue
        for sub in ("lib64", os.path.join("targets", "x86_64-linux", "lib")):
            d = os.path.join(root, sub)
            if os.path.isdir(d) and d not in out:
                out.append(d)
    return out


def _link_flags(name):
    libs = LINK.get(name, ())
    if not libs:
        return ()
    flags = []
    for d in _lib_dirs():
        flags += ["-L" + d, "-Xlinker", "-rpath=" + d]
    return tuple(flags) + libs


def source_hash(src):
    """Hex digest of the source file ``src``, of every header it
    includes with quotes that lies beside the including file (followed
    transitively, each read once) and of the nvcc flags."""
    name = os.path.splitext(os.path.basename(src))[0]
    h = hashlib.sha256(" ".join(FLAGS + LINK.get(name, ())).encode())
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(os.path.basename(path).encode() + b"\0" + text)
        for inc in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), inc.decode())
            if os.path.exists(dep):
                todo.append(dep)
    return h.hexdigest()


def library_path(name):
    """Where the library for ``csrc/<name>.cu`` is (or will be) built;
    ``ptxas -v``'s report of its build lies beside it, with ``.ptxas``
    in place of ``.so``."""
    src = os.path.join(_CSRC, name + ".cu")
    return os.path.join(_OUT, "%s-%s.so" % (name, source_hash(src)[:16]))


def _compile(name):
    """Path of the library for ``csrc/<name>.cu``, built unless it
    exists.  A file lock beside the library makes a second process
    that needs it at the same time (a serving cluster's workers) wait
    for the first one's build instead of building it again."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(_OUT, exist_ok=True)
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        return _nvcc_build(name, so)


def _nvcc_build(name, so):
    tmp = "%s.%d.tmp" % (so, os.getpid())
    out = subprocess.run([_nvcc(), *FLAGS, "-o", tmp,
                          os.path.join(_CSRC, name + ".cu"),
                          *_link_flags(name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log = out.stdout.decode(errors="replace")
    if out.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, log))
    with open(so[:-3] + ".ptxas", "w") as f:
        f.write(log)
    os.replace(tmp, so)
    return so


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(log):
    """{kernel (mangled name): {"registers", "spill_stores",
    "spill_loads", "stack", "static_smem"}} from ``ptxas -v``'s output
    (dynamic shared memory is set at launch and not in the report)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"static_smem": 0})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            if s:
                cur["static_smem"] = int(s.group(1))
    return out


def load(name):
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks[name]:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_compile(name))
        return _libs[name]


def check(err, what):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("%s: CUDA launch failed with error %d"
                           % (what, err))
