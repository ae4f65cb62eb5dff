"""Testing toolkit: the correctness oracles MXNet's tests are built on.

Port of ``mxnet_tpu/test_utils.py``:

* ``assert_almost_equal``: dtype-aware tolerance compare.
* ``check_numeric_gradient``: central finite differences against
  autograd, in torch float64 (the reference needs
  ``jax.experimental.enable_x64`` for that; the port has float64).
* ``check_consistency``: the same computation on a list of contexts and
  dtypes, forward and input gradients cross-compared.  Its default
  contexts are ``[cpu()]`` plus ``gpu(0)`` when a card is present (the
  reference's are ``[cpu()]`` plus ``tpu()``).
* ``check_symbolic_forward`` / ``check_symbolic_backward``: a bound
  Symbol executor against NumPy expectations.

Arrays are made on the current context (the card unless a
``with mx.cpu():`` scope is open), as every creation of the port is.
"""
from __future__ import annotations

import numpy as np

from .context import Context, cpu, current_context, gpu, num_gpus
from . import ndarray as nd
from .ndarray import NDArray
from . import autograd


# Per-dtype default tolerances (reference: test_utils.py's dtype maps).
_DTYPE_RTOL = {
    np.dtype(np.float16): 1e-2,
    np.dtype(np.float32): 1e-4,
    np.dtype(np.float64): 1e-6,
    "bfloat16": 3e-2,
}
_DTYPE_ATOL = {
    np.dtype(np.float16): 1e-2,
    np.dtype(np.float32): 1e-5,
    np.dtype(np.float64): 1e-8,
    "bfloat16": 3e-2,
}


def default_context() -> Context:
    """Context that tests run on (reference: test_utils.default_context)."""
    return current_context()


def _as_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _tol_for(a, b, rtol, atol):
    if rtol is not None and atol is not None:
        return rtol, atol
    dts = []
    for x in (a, b):
        name = str(x.dtype)
        dts.append("bfloat16" if name == "bfloat16" else np.dtype(x.dtype))
    r = max(_DTYPE_RTOL.get(d, 1e-5) for d in dts)
    t = max(_DTYPE_ATOL.get(d, 1e-8) for d in dts)
    return (rtol if rtol is not None else r,
            atol if atol is not None else t)


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _as_numpy(a), _as_numpy(b)
    rtol, atol = _tol_for(a, b, rtol, atol)
    return np.allclose(a.astype(np.float64) if a.dtype != object else a,
                       b.astype(np.float64) if b.dtype != object else b,
                       rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    an, bn = _as_numpy(a), _as_numpy(b)
    rtol, atol = _tol_for(an, bn, rtol, atol)
    if an.shape != bn.shape:
        raise AssertionError("shape mismatch %s=%s vs %s=%s"
                             % (names[0], an.shape, names[1], bn.shape))
    af = an.astype(np.float64)
    bf = bn.astype(np.float64)
    if np.allclose(af, bf, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    err = np.abs(af - bf)
    denom = np.abs(bf) + atol / max(rtol, 1e-300)
    rel = err / np.maximum(denom, 1e-300)
    idx = np.unravel_index(np.argmax(rel), rel.shape)
    raise AssertionError(
        "Arrays not almost equal (rtol=%g atol=%g): max |%s-%s|=%g, "
        "max rel err %g at %s (%r vs %r)"
        % (rtol, atol, names[0], names[1], err.max(), rel.max(), idx,
           af[idx], bf[idx]))


def same(a, b) -> bool:
    return np.array_equal(_as_numpy(a), _as_numpy(b))


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, dtype=np.float32, ctx=None, scale=1.0):
    data = np.random.uniform(-scale, scale, size=shape).astype(dtype)
    return nd.array(data, ctx=ctx)


def random_arrays(*shapes, dtype=np.float32):
    arrays = [np.random.randn(*s).astype(dtype) if s else
              np.array(np.random.randn(), dtype=dtype) for s in shapes]
    if len(arrays) == 1:
        return arrays[0]
    return arrays


# ---------------------------------------------------------------------------
# Numeric-gradient oracle
# ---------------------------------------------------------------------------

def numeric_grad(f, inputs, eps=1e-4):
    """Central-difference gradients of scalar-valued ``f(*numpy_arrays)``."""
    grads = []
    for i, x in enumerate(inputs):
        g = np.zeros_like(x, dtype=np.float64)
        flat = x.reshape(-1)
        gflat = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(f(*inputs))
            flat[j] = orig - eps
            fm = float(f(*inputs))
            flat[j] = orig
            gflat[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(fn, inputs, eps=1e-4, rtol=1e-2, atol=1e-4,
                           dtype=np.float64):
    """Compare autograd gradients of ``fn`` against central finite
    differences.

    ``fn`` maps NDArrays to a single NDArray; its sum is the scalar
    objective.  ``inputs`` are numpy arrays; both the autograd pass and
    the finite differences run in ``dtype`` (float64 by default, in
    torch's own float64)."""
    np_inputs = [np.asarray(x, dtype=dtype) for x in inputs]

    nd_inputs = [nd.array(x, dtype=dtype) for x in np_inputs]
    for a in nd_inputs:
        a.attach_grad()
    with autograd.record():
        out = fn(*nd_inputs)
        loss = out.sum() if hasattr(out, "sum") else sum(o.sum() for o in out)
    loss.backward()
    ad_grads = [a.grad.asnumpy() for a in nd_inputs]

    def scalar_f(*xs):
        outs = fn(*[nd.array(x, dtype=dtype) for x in xs])
        if isinstance(outs, (tuple, list)):
            return sum(float(o.sum().asnumpy()) for o in outs)
        return float(outs.sum().asnumpy())

    num_grads = numeric_grad(scalar_f, [x.copy() for x in np_inputs], eps=eps)

    for i, (ag, ng) in enumerate(zip(ad_grads, num_grads)):
        assert_almost_equal(ag, ng, rtol=rtol, atol=atol,
                            names=("autograd[%d]" % i, "numeric[%d]" % i))
    return ad_grads, num_grads


# ---------------------------------------------------------------------------
# Cross-context consistency oracle (cpu vs the card)
# ---------------------------------------------------------------------------

def check_consistency(fn, inputs, ctx_list=None, dtypes=None, grad=True,
                      rtol=None, atol=None):
    """Run ``fn`` on every context (and dtype) and cross-compare forward
    outputs and input gradients (MXNet's second-backend oracle).

    Parameters
    ----------
    fn : callable(NDArray...) -> NDArray.
    inputs : list of numpy arrays.
    ctx_list : contexts to compare (default: [cpu()] + gpu(0) when a card
        is present).
    dtypes : dtype per run (default float32 for each ctx).
    """
    if ctx_list is None:
        ctx_list = [cpu()]
        if num_gpus() > 0:
            ctx_list.append(gpu(0))
    if dtypes is None:
        dtypes = [np.float32] * len(ctx_list)

    runs = []
    for ctx, dt in zip(ctx_list, dtypes):
        # integer/bool inputs (indices, masks) keep their own dtype —
        # casting them to the comparison float dtype would feed ops
        # garbage indices; only float inputs follow the dtype matrix
        nd_in = []
        is_float = []
        for x in inputs:
            xa = x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)
            f = np.issubdtype(xa.dtype, np.floating)
            is_float.append(f)
            nd_in.append(nd.array(xa, dtype=dt if f else xa.dtype,
                                  ctx=ctx))
        if grad:
            for a, f in zip(nd_in, is_float):
                if f:                      # grads only flow to floats
                    a.attach_grad()
            with autograd.record():
                out = fn(*nd_in)
            out.backward(nd.ones_like(out))
            runs.append((dt, out.asnumpy(),
                         [a.grad.asnumpy() if f else None
                          for a, f in zip(nd_in, is_float)]))
        else:
            out = fn(*nd_in)
            runs.append((dt, out.asnumpy(), None))

    ref_dt, ref_out, ref_grads = runs[0]
    for (dt, out, grads), ctx in list(zip(runs, ctx_list))[1:]:
        r, t = _tol_for(np.asarray(out, dtype=None), ref_out, rtol, atol)
        assert_almost_equal(out, ref_out, rtol=r, atol=t,
                            names=("fwd@%s" % ctx, "fwd@%s" % ctx_list[0]))
        if grad:
            for i, (g, rg) in enumerate(zip(grads, ref_grads)):
                if g is None or rg is None:
                    continue
                assert_almost_equal(
                    g, rg, rtol=r, atol=t,
                    names=("grad%d@%s" % (i, ctx),
                           "grad%d@%s" % (i, ctx_list[0])))
    return runs


# ---------------------------------------------------------------------------
# Symbolic oracles (Symbol/Module API)
# ---------------------------------------------------------------------------

def check_symbolic_forward(sym, inputs, expected, rtol=1e-4, atol=1e-5,
                           ctx=None, aux_states=None):
    """Bind ``sym`` with ``inputs`` (list of numpy arrays, in argument
    order) and compare outputs against ``expected`` numpy arrays."""
    args = {k: nd.array(np.asarray(v))
            for k, v in zip(sym.list_arguments(), inputs)}
    exe = sym._bind(ctx or default_context(), args,
                    aux_states=aux_states)
    outs = exe.forward(is_train=False)
    if not isinstance(expected, (list, tuple)):
        expected = [expected]
    for i, (o, e) in enumerate(zip(outs, expected)):
        assert_almost_equal(o, e, rtol=rtol, atol=atol,
                            names=("out%d" % i, "expected%d" % i))
    return outs


def check_symbolic_backward(sym, inputs, out_grads, expected_grads,
                            rtol=1e-4, atol=1e-5, ctx=None):
    """Bind ``sym``, run forward+backward with ``out_grads`` and compare the
    argument gradients against ``expected_grads``."""
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()
    args = {k: nd.array(np.asarray(v))
            for k, v in zip(arg_names, inputs)}
    grad_arrays = {k: nd.zeros_like(v) for k, v in args.items()}
    exe = sym._bind(ctx, args, args_grad=grad_arrays, grad_req="write")
    exe.forward(is_train=True)
    exe.backward([nd.array(np.asarray(g)) for g in (
        out_grads if isinstance(out_grads, (list, tuple)) else [out_grads])])
    if isinstance(expected_grads, dict):
        items = expected_grads.items()
    else:
        items = zip(arg_names, expected_grads)
    for k, e in items:
        assert_almost_equal(grad_arrays[k], e, rtol=rtol, atol=atol,
                            names=("grad[%s]" % k, "expected[%s]" % k))
    return grad_arrays
