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


def test_ptxas_report_reads_registers_spills_and_smem():
    """``ptxas -v``'s report, as nvcc prints it for two kernels, read
    into registers, spills and static shared memory per kernel."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aPf' for 'sm_90a'
ptxas info    : Function properties for _Z1aPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 360 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1bPf' for 'sm_90a'
ptxas info    : Function properties for _Z1bPf
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 33024 bytes smem, 360 bytes cmem[0]
"""
    rep = _build.ptxas_report(log)
    assert rep == {
        "_Z1aPf": {"registers": 168, "spill_stores": 0, "spill_loads": 0,
                   "stack": 0, "static_smem": 0},
        "_Z1bPf": {"registers": 255, "spill_stores": 12, "spill_loads": 16,
                   "stack": 8, "static_smem": 33024}}
    assert _build.library_path("flash_fwd").endswith(".so")
