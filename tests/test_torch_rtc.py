"""``mx.rtc`` of ``mxnet_tpu_torch``: MXNet 1.x's ``CudaModule`` /
``CudaKernel`` (CUDA source compiled at run time with NVRTC), which
takes the place of the reference's ``PallasModule``.

On the CPU: the signature parser (upstream's types table, ``ValueError``
and ``TypeError``), the checks ``launch`` makes before it touches a
device, a launch on a CPU context (``MXNetError``, as upstream) and
``PallasModule`` raising ``NotPorted``.  On the card (``cuda``):
upstream's ``axpy`` example and a CUDA twin of the reference's
``test_rtc_pallas_kernel`` (``tests/test_runtime_aux.py:65``) on the
same input with the same expected values, bit for bit."""
import numpy as np
import pytest

from _torch_port import cuda_device  # noqa: F401  (fixture)

AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
"""


@pytest.mark.parametrize("ctype,npt", [
    ("float", np.float32), ("double", np.float64), ("__half", np.float16),
    ("uint8_t", np.uint8), ("int", np.int32), ("int32_t", np.int32),
    ("int8_t", np.int8), ("char", np.int8), ("int64_t", np.int64)])
def test_parse_signature_types(ctype, npt):
    from mxnet_tpu_torch import rtc
    sig = rtc.parse_signature("const %s *x, %s * y, %s alpha, %s" % (
        ctype, ctype, ctype, ctype))
    assert sig == [(True, True, np.dtype(npt)), (True, False, np.dtype(npt)),
                   (False, False, np.dtype(npt)), (False, False, np.dtype(npt))]


def test_parse_signature_spacing_and_names():
    from mxnet_tpu_torch import rtc
    assert rtc.parse_signature("const  float*x,\n  float  *  y,float a") == [
        (True, True, np.dtype(np.float32)), (True, False, np.dtype(np.float32)),
        (False, False, np.dtype(np.float32))]


@pytest.mark.parametrize("sig", ["const *x", "float x y", "const", "float **x",
                                 "float *x,", "float x[3]"])
def test_parse_signature_malformed(sig):
    from mxnet_tpu_torch import rtc
    with pytest.raises(ValueError, match="Invalid function prototype"):
        rtc.parse_signature(sig)


@pytest.mark.parametrize("sig", ["long *x", "float *x, bfloat16 y",
                                 "unsigned x", "const size_t n"])
def test_parse_signature_unsupported_type(sig):
    from mxnet_tpu_torch import rtc
    with pytest.raises(TypeError, match="Unsupported kernel argument type"):
        rtc.parse_signature(sig)


def _axpy_kernel():
    """A CudaKernel for the axpy signature with no compiled module: the
    CPU can reach every check ``launch`` makes before a device."""
    from mxnet_tpu_torch import rtc
    return rtc.CudaKernel(None, "axpy", rtc.parse_signature(
        "const float *x, float *y, float alpha"))


def _ones(mx, n=10, dtype="float32"):
    return mx.nd.ones((n,), ctx=mx.cpu(), dtype=dtype)


@pytest.mark.parametrize("args,match", [
    (lambda mx: [_ones(mx), _ones(mx)], "expects 3 arguments but got 2"),
    (lambda mx: [_ones(mx), _ones(mx), 3.0, 1], "expects 3 arguments"),
    (lambda mx: [1.0, _ones(mx), 3.0], "0-th argument .* NDArray"),
    (lambda mx: [_ones(mx), _ones(mx), _ones(mx)], "2-th argument .* number"),
    (lambda mx: [_ones(mx), _ones(mx), "3"], "2-th argument .* number"),
    (lambda mx: [_ones(mx, dtype="float64"), _ones(mx), 3.0],
     "0-th argument .* declared float32"),
    (lambda mx: [_ones(mx), _ones(mx, dtype="int32"), 3.0],
     "1-th argument .* declared float32"),
])
def test_launch_checks_arguments(args, match):
    import mxnet_tpu_torch as mx
    with pytest.raises(mx.MXNetError, match=match):
        _axpy_kernel().launch(args(mx), mx.cpu(), (1, 1, 1), (10, 1, 1))


@pytest.mark.parametrize("grid,block", [((1, 1), (10, 1, 1)),
                                        ((1, 1, 1), (10,))])
def test_launch_checks_dims(grid, block):
    import mxnet_tpu_torch as mx
    with pytest.raises(mx.MXNetError, match="tuples of 3"):
        _axpy_kernel().launch([_ones(mx), _ones(mx), 3.0], mx.cpu(), grid,
                              block)


def test_launch_on_cpu_context_raises():
    import mxnet_tpu_torch as mx
    k = _axpy_kernel()
    with pytest.raises(mx.MXNetError, match="gpu context"):
        k.launch([_ones(mx), _ones(mx), 3.0], mx.cpu(), (1, 1, 1), (10, 1, 1))
    assert k.launches == 0


def test_pallas_module_not_ported():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import NotPorted
    with pytest.raises(NotPorted, match="CudaModule"):
        mx.rtc.PallasModule("def scale2(x_ref, o_ref): pass",
                            exports=["scale2"])
    with pytest.raises(NotPorted):
        mx.rtc.PallasKernel(None, "scale2")


def test_rtc_is_exposed():
    import mxnet_tpu_torch as mx
    assert mx.rtc.CudaModule and mx.rtc.CudaKernel
    assert mx.rtc.DTYPE_CPP_TO_NP["__half"] is np.float16


@pytest.mark.cuda
def test_cuda_axpy_upstream_example(cuda_device):  # noqa: F811
    """Upstream's docstring example: y == 3 everywhere."""
    import mxnet_tpu_torch as mx
    module = mx.rtc.CudaModule(AXPY)
    func = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    func.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    assert (y.asnumpy() == 3.0).all()
    assert func.launches == 1


@pytest.mark.cuda
def test_cuda_scale2_twin_of_reference(cuda_device):  # noqa: F811
    """The reference's ``test_rtc_pallas_kernel`` in CUDA: ``scale2`` on
    arange(8) as (2, 4) gives x * 2; an unknown kernel and a compile
    error raise ``MXNetError`` (the latter with the NVRTC log)."""
    import mxnet_tpu_torch as mx
    mod = mx.rtc.CudaModule(r"""
template <typename T>
__global__ void scale2(const T *x, T *o, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) o[i] = x[i] * T(2);
}
""", exports=["scale2<float>"])
    k = mod.get_kernel("scale2<float>", "const float *x, float *o, int n")
    x = mx.nd.array(np.arange(8, dtype="float32").reshape(2, 4),
                    ctx=mx.gpu(0))
    y = mx.nd.zeros((2, 4), ctx=mx.gpu(0))
    k.launch([x, y, 8], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    np.testing.assert_array_equal(y.asnumpy(), x.asnumpy() * 2)
    with pytest.raises(mx.MXNetError, match="cannot find CUDA kernel"):
        mod.get_kernel("nope", "const float *x").launch(
            [x], mx.gpu(0), (1, 1, 1), (1, 1, 1))
    with pytest.raises(mx.MXNetError, match="error"):
        mx.rtc.CudaModule("this is ( not cuda")
