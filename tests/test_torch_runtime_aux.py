"""``mx.runtime`` and ``mx.library`` of ``mxnet_tpu_torch``: twins of
``tests/test_runtime_aux.py:19-58`` on the port's own flags and op
registry, beside the reference's."""
import os

import numpy as np
import pytest


def test_runtime_features():
    import mxnet_tpu_torch as mx
    import torch
    feats = mx.runtime.Features()
    assert feats["CPU"].enabled
    assert feats.is_enabled("cpu")
    assert feats.is_enabled("CUDA") == torch.cuda.is_available()
    for off in ("TPU", "XLA", "PALLAS"):
        assert not feats.is_enabled(off)
    with pytest.raises(KeyError):
        feats.is_enabled("NO_SUCH_FEATURE")
    names = {f.name for f in mx.runtime.feature_list()}
    assert {"CPU", "CUDA", "CUDNN", "NVRTC", "NCCL", "BF16", "RECORDIO",
            "TPU", "XLA", "PALLAS", "DIST_KVSTORE"} <= names
    assert "✔" in repr(feats) and "✖" in repr(feats)
    assert len(feats) == len(names)


def test_runtime_features_share_the_reference_api():
    """Both packages answer the same calls: ``Features()[name]``,
    ``is_enabled`` (case-insensitive, ``KeyError`` on unknown names) and
    ``feature_list``; the port's flags describe its own build."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    for pkg in (jmx, mx):
        feats = pkg.runtime.Features()
        assert feats.is_enabled("cpu") and feats["CPU"].enabled
        with pytest.raises(KeyError):
            feats.is_enabled("NO_SUCH_FEATURE")
        assert [f.name for f in pkg.runtime.feature_list()] == list(feats)
    assert jmx.runtime.Features().is_enabled("XLA")
    assert not mx.runtime.Features().is_enabled("XLA")


def test_library_load_python_ext(tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    ext = tmp_path / "my_torch_ext.py"
    ext.write_text(
        "from mxnet_tpu_torch.ops import registry\n"
        "@registry.register('test_torch_ext_double')\n"
        "def _double(x):\n"
        "    return x * 2\n")
    mod = mx.library.load(str(ext), verbose=False)
    assert registry.op_exists("test_torch_ext_double")
    assert str(ext) in mx.library.loaded_libs()
    assert mx.library.load(str(ext)) is mod          # cached
    x = mx.nd.array(np.arange(4, dtype=np.float32), ctx=mx.cpu())
    y = registry.invoke(registry.get_op("test_torch_ext_double"), [x])
    np.testing.assert_array_equal(y.asnumpy(), np.arange(4) * 2)


def test_library_load_module_name():
    import mxnet_tpu_torch as mx
    assert mx.library.load("json", verbose=False) is __import__("json")
    with pytest.raises(mx.MXNetError, match="cannot import"):
        mx.library.load("no_such_module_for_sure", verbose=False)


def test_library_load_missing():
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    for pkg in (jmx, mx):
        with pytest.raises(pkg.MXNetError):
            pkg.library.load("/no/such/ext.py")
        with pytest.raises(pkg.MXNetError):
            pkg.library.load("/no/such/lib.so")


def test_library_load_broken_python_ext(tmp_path):
    import mxnet_tpu_torch as mx
    ext = tmp_path / "broken_torch_ext.py"
    ext.write_text("raise RuntimeError('boom')\n")
    with pytest.raises(mx.MXNetError, match="boom"):
        mx.library.load(str(ext), verbose=False)
    assert str(ext) not in mx.library.loaded_libs()


def test_library_load_native_without_hook(tmp_path):
    """A shared object that exports no ``MXTPULibInit`` is refused, in
    both packages (the C math library serves as one)."""
    import ctypes.util
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    name = ctypes.util.find_library("m")
    found = [os.path.join(d, name) for d in (
        "/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64",
        "/usr/lib64", "/lib/aarch64-linux-gnu", "/usr/lib/aarch64-linux-gnu")
        if name and os.path.exists(os.path.join(d, name))]
    if not found:
        pytest.skip("no C math library found")
    so = tmp_path / "libm_copy.so"
    so.symlink_to(os.path.realpath(found[0]))
    for pkg in (jmx, mx):
        with pytest.raises(pkg.MXNetError, match="MXTPULibInit"):
            pkg.library.load(str(so), verbose=False)
