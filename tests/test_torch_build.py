"""``mxnet_tpu_torch.kernels._build``: the library cache key.  It needs
no ``nvcc``: only the hash that names a built library is checked, so an
edited source or an edited header it includes builds anew."""
import os

from mxnet_tpu_torch.kernels import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_hash_follows_included_headers(tmp_path):
    src = os.path.join(tmp_path, "k.cu")
    _write(os.path.join(tmp_path, "a.cuh"), '#include "b.cuh"\nint a;\n')
    _write(os.path.join(tmp_path, "b.cuh"), "int b = 1;\n")
    _write(os.path.join(tmp_path, "unused.cuh"), "int u;\n")
    _write(src, '#include <cuda_runtime.h>\n#include "a.cuh"\n'
                '#include "missing.h"\nint k;\n')
    first = _build.source_hash(src)
    assert first == _build.source_hash(src)
    _write(os.path.join(tmp_path, "unused.cuh"), "int u2;\n")
    assert _build.source_hash(src) == first        # not included
    _write(os.path.join(tmp_path, "b.cuh"), "int b = 2;\n")
    second = _build.source_hash(src)               # included through a.cuh
    assert second != first
    _write(os.path.join(tmp_path, "a.cuh"), '#include "b.cuh"\nint a2;\n')
    assert _build.source_hash(src) not in (first, second)


def test_every_source_hashes_with_its_header():
    """The repository's own sources: the flash sources include the
    shared header, and every source named in SOURCES exists."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(csrc, name + ".cu")), name
    for name in ("flash_fwd", "flash_bwd"):
        with open(os.path.join(csrc, name + ".cu")) as f:
            assert '#include "flash_common.cuh"' in f.read(), name
    hashes = {_build.source_hash(os.path.join(csrc, n + ".cu"))
              for n in _build.SOURCES}
    assert len(hashes) == len(_build.SOURCES)
