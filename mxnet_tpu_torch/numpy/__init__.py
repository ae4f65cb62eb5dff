"""``mx.np``: the NumPy-compatible array API.

Port of ``mxnet_tpu/numpy/__init__.py``.  ``mx.np.ndarray`` is an
``NDArray`` subclass over the same torch tensor, autograd tape, op
registry and hybridize, so classic and numpy arrays mix freely and
Gluon blocks take either.  The NumPy semantics that differ from classic
MXNet (reshape codes, axis tuples, comparison dtypes) live in the
``_np_*`` registry ops (``_np_ops.py``).  Arrays follow the reference's
dtypes, which are jnp's without x64: a Python or numpy int64 source
becomes int32 and a float64 one float32 unless a dtype is given; an
explicit ``dtype="float64"`` keeps float64 here (the reference gives
float32).  Creation goes to ``ctx`` (or ``device``), else the current
context: the card unless a ``with mx.cpu():`` scope is open.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..base import MXNetError  # noqa: F401  (the reference binds it here)
from ..context import current_context
from ..ndarray.ndarray import NDArray, _torch_dtype
from ..ops.registry import get_op, invoke
from . import _np_ops  # registers the _np_* ops
from . import random  # noqa: F401
from . import linalg  # noqa: F401

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
euler_gamma = _onp.euler_gamma

float16 = _onp.float16
float32 = _onp.float32
float64 = _onp.float64
int8 = _onp.int8
int16 = _onp.int16
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_


class ndarray(NDArray):
    """NumPy-semantics array over the NDArray substrate (tensor, tape,
    registry).  Converts with classic NDArray without a copy through
    ``as_np_ndarray``/``as_nd_ndarray``."""

    __slots__ = ()

    def __repr__(self):
        return repr(self.asnumpy())

    def as_nd_ndarray(self):
        out = NDArray(self._data)
        out._ctx = self._ctx
        out._grad, out._grad_req = self._grad, self._grad_req
        return out

    # numpy-flavored methods -------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return reshape(self, shape)

    def transpose(self, *axes):
        if len(axes) == 0:
            axes = None
        elif len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes)

    @property
    def T(self):
        return transpose(self)

    def sum(self, axis=None, keepdims=False, dtype=None):
        return sum(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        return mean(self, axis=axis, keepdims=keepdims, dtype=dtype)

    def max(self, axis=None, keepdims=False):
        return max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return prod(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, keepdims=False, ddof=0):
        return std(self, axis=axis, keepdims=keepdims, ddof=ddof)

    def var(self, axis=None, keepdims=False, ddof=0):
        return var(self, axis=axis, keepdims=keepdims, ddof=ddof)

    def argmax(self, axis=None):
        return argmax(self, axis=axis)

    def argmin(self, axis=None):
        return argmin(self, axis=axis)

    def all(self, axis=None, keepdims=False):
        return all(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return any(self, axis=axis, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return cumsum(self, axis=axis, dtype=dtype)

    def clip(self, a_min=None, a_max=None):
        return clip(self, a_min, a_max)

    def round(self, decimals=0):
        return round(self, decimals=decimals)

    def squeeze(self, axis=None):
        return squeeze(self, axis=axis)

    def flatten(self):
        return ravel(self)

    def ravel(self):
        return ravel(self)

    def repeat(self, repeats, axis=None):
        return repeat(self, repeats, axis=axis)

    def take(self, indices, axis=None, mode="clip"):
        return take(self, indices, axis=axis, mode=mode)

    def dot(self, other):
        return dot(self, other)

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        out = super().astype(dtype, copy=copy)
        return _as_np(out)

    def copy(self):
        return _as_np(super().copy())


def _as_np(res):
    """Rebrand an invoke result as np ndarray(s) without breaking tape
    identity (same object, class swap — both classes share __slots__)."""
    if isinstance(res, NDArray):
        res.__class__ = ndarray
        return res
    if isinstance(res, (tuple, list)):
        return tuple(_as_np(r) for r in res)
    return res


def _to_input(x):
    if isinstance(x, NDArray):
        return x
    if isinstance(x, (int, float, bool, complex)):
        return x
    return array(x)


def _apply(op_name, *inputs, pos_attrs=(), **attrs):
    ins = [_to_input(i) for i in inputs]
    return _as_np(invoke(get_op(op_name), ins, tuple(pos_attrs), attrs))


def _apply_variadic(op_name, seq, **attrs):
    ins = [_to_input(i) for i in seq]
    return _as_np(invoke(get_op(op_name), ins, (), attrs))


# ------------------------------------------------------------------ creation

def _canon(arr):
    """jnp's dtypes without x64: int64 becomes int32, float64 float32."""
    if arr.dtype == _onp.float64:
        return arr.astype(_onp.float32)
    if arr.dtype == _onp.int64:
        return arr.astype(_onp.int32)
    return arr


def _ctx_of(ctx, device):
    return ctx or device or current_context()


def array(object, dtype=None, ctx=None, device=None):
    if isinstance(object, NDArray):
        data = object._data
        if dtype is not None:
            data = data.to(_torch_dtype(dtype))
        return ndarray(data)
    arr = _onp.asarray(object, dtype=dtype)
    if dtype is None:
        arr = _canon(arr)
    c = _ctx_of(ctx, device)
    return ndarray(torch.from_numpy(_onp.array(arr, copy=True)), c)


def _creation(fn):
    def wrapper(*args, ctx=None, device=None, dtype=None, **kw):
        c = _ctx_of(ctx, device)
        if dtype is None and fn.__name__ not in ("arange",):
            dtype = "float32"
        out = fn(c.torch_device, *args, dtype=dtype, **kw)
        return ndarray(out, c)
    wrapper.__name__ = fn.__name__
    return wrapper


def _dt(dtype):
    return None if dtype is None else _torch_dtype(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@_creation
def zeros(dev, shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=dev)


@_creation
def ones(dev, shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=dev)


@_creation
def full(dev, shape, fill_value, dtype=None):
    return torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                      device=dev)


@_creation
def empty(dev, shape, dtype=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)


@_creation
def arange(dev, start, stop=None, step=1, dtype=None):
    vals = _canon(_onp.arange(start, stop, step)) if dtype is None else \
        _onp.arange(start, stop, step, dtype=dtype)
    return torch.from_numpy(_onp.ascontiguousarray(vals)).to(dev)


def _linspace(start, stop, num, endpoint):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=torch.float64)
    return torch.linspace(start, stop, num + 1, dtype=torch.float64)[:num]


@_creation
def linspace(dev, start, stop, num=50, endpoint=True, dtype=None):
    return _linspace(start, stop, num, endpoint).to(dev, _dt(dtype))


@_creation
def logspace(dev, start, stop, num=50, endpoint=True, base=10.0,
             dtype=None):
    out = torch.pow(float(base), _linspace(start, stop, num, endpoint))
    return out.to(dev, _dt(dtype))


@_creation
def eye(dev, N, M=None, k=0, dtype=None):
    M = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return (j - i == k).to(_dt(dtype))


@_creation
def identity(dev, n, dtype=None):
    return torch.eye(n, dtype=_dt(dtype), device=dev)


@_creation
def tri(dev, N, M=None, k=0, dtype=None):
    M = N if M is None else M
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return (j <= i + k).to(_dt(dtype))


def zeros_like(a, dtype=None):
    return zeros(a.shape, dtype=dtype or a.dtype)


def ones_like(a, dtype=None):
    return ones(a.shape, dtype=dtype or a.dtype)


def full_like(a, fill_value, dtype=None):
    return full(a.shape, fill_value, dtype=dtype or a.dtype)


def empty_like(a, dtype=None):
    return empty(a.shape, dtype=dtype or a.dtype)


def copy(a):
    return array(a).copy() if not isinstance(a, NDArray) else _as_np(a.copy())


def asarray(a, dtype=None):
    if isinstance(a, ndarray) and dtype is None:
        return a
    return array(a, dtype=dtype)


def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype)


def meshgrid(*xi, indexing="xy"):
    return _apply_variadic("_np_meshgrid", xi, indexing=indexing)


# --------------------------------------------------------- elementwise unary

def _unary_fn(np_name, op_name):
    def fn(x, out=None, **kw):
        r = _apply(op_name, x)
        if out is not None:
            if isinstance(r, tuple):
                for o, v in zip(out, r):
                    o[...] = v
            else:
                out[...] = r
            return out
        return r
    fn.__name__ = np_name
    return fn


_UNARY = {
    "negative": "negative", "absolute": "abs", "abs": "abs", "sign": "sign",
    "square": "square", "sqrt": "sqrt", "cbrt": "cbrt", "exp": "exp",
    "expm1": "expm1", "log": "log", "log2": "log2", "log10": "log10",
    "log1p": "log1p", "reciprocal": "reciprocal", "sin": "sin", "cos": "cos",
    "tan": "tan", "arcsin": "arcsin", "arccos": "arccos", "arctan": "arctan",
    "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "arcsinh": "arcsinh",
    "arccosh": "arccosh", "arctanh": "arctanh", "floor": "floor",
    "ceil": "ceil", "trunc": "trunc", "rint": "rint", "fix": "fix",
    "isnan": "isnan", "isinf": "isinf", "isfinite": "isfinite",
    "logical_not": "logical_not", "relu": "relu", "sigmoid": "sigmoid",
}

for _nm, _op in _UNARY.items():
    globals()[_nm] = _unary_fn(_nm, _op)


# -------------------------------------------------------- elementwise binary

def _binary_fn(np_name, op_name):
    def fn(a, b, out=None, **kw):
        r = _apply(op_name, a, b)
        if out is not None:
            if isinstance(r, tuple):
                for o, v in zip(out, r):
                    o[...] = v
            else:
                out[...] = r
            return out
        return r
    fn.__name__ = np_name
    return fn


_BINARY = {
    "add": "broadcast_add", "subtract": "broadcast_sub",
    "multiply": "broadcast_mul", "divide": "broadcast_div",
    "true_divide": "broadcast_div", "power": "broadcast_power",
    "mod": "broadcast_mod", "remainder": "broadcast_mod",
    "maximum": "broadcast_maximum", "minimum": "broadcast_minimum",
    "equal": "broadcast_equal", "not_equal": "broadcast_not_equal",
    "greater": "broadcast_greater", "less": "broadcast_lesser",
    "greater_equal": "broadcast_greater_equal",
    "less_equal": "broadcast_lesser_equal",
    "logical_and": "broadcast_logical_and",
    "logical_or": "broadcast_logical_or",
    "logical_xor": "broadcast_logical_xor",
    "floor_divide": "_np_floor_divide", "fmod": "_np_fmod",
    "arctan2": "_np_arctan2", "hypot": "_np_hypot",
    "copysign": "_np_copysign", "logaddexp": "_np_logaddexp",
    "heaviside": "_np_heaviside", "bitwise_and": "_np_bitwise_and",
    "bitwise_or": "_np_bitwise_or", "bitwise_xor": "_np_bitwise_xor",
    "left_shift": "_np_left_shift", "right_shift": "_np_right_shift",
}

for _nm, _op in _BINARY.items():
    globals()[_nm] = _binary_fn(_nm, _op)


# --------------------------------------------------------------- reductions

def sum(a, axis=None, keepdims=False, dtype=None, out=None):
    return _apply("_np_sum", a, axis=axis, keepdims=keepdims, dtype=dtype)


def mean(a, axis=None, keepdims=False, dtype=None, out=None):
    return _apply("_np_mean", a, axis=axis, keepdims=keepdims, dtype=dtype)


def prod(a, axis=None, keepdims=False, dtype=None):
    return _apply("_np_prod", a, axis=axis, keepdims=keepdims, dtype=dtype)


def max(a, axis=None, keepdims=False):
    return _apply("_np_max", a, axis=axis, keepdims=keepdims)


def min(a, axis=None, keepdims=False):
    return _apply("_np_min", a, axis=axis, keepdims=keepdims)


amax = max
amin = min


def std(a, axis=None, keepdims=False, ddof=0):
    return _apply("_np_std", a, axis=axis, keepdims=keepdims, ddof=ddof)


def var(a, axis=None, keepdims=False, ddof=0):
    return _apply("_np_var", a, axis=axis, keepdims=keepdims, ddof=ddof)


def median(a, axis=None, keepdims=False):
    return _apply("_np_median", a, axis=axis, keepdims=keepdims)


def average(a, axis=None, weights=None):
    if weights is None:
        return _apply("_np_average", a, axis=axis)
    return _apply("_np_average", a, weights, axis=axis)


def nanmean(a, axis=None, keepdims=False):
    return _apply("_np_nanmean", a, axis=axis, keepdims=keepdims)


def all(a, axis=None, keepdims=False):
    return _apply("_np_all", a, axis=axis, keepdims=keepdims)


def any(a, axis=None, keepdims=False):
    return _apply("_np_any", a, axis=axis, keepdims=keepdims)


def cumsum(a, axis=None, dtype=None):
    return _apply("_np_cumsum", a, axis=axis, dtype=dtype)


def cumprod(a, axis=None, dtype=None):
    return _apply("_np_cumprod", a, axis=axis, dtype=dtype)


def ptp(a, axis=None, keepdims=False):
    return _apply("_np_ptp", a, axis=axis, keepdims=keepdims)


def argmax(a, axis=None):
    return _apply("argmax", a, axis=axis)


def argmin(a, axis=None):
    return _apply("argmin", a, axis=axis)


# ------------------------------------------------------------- manipulation

def reshape(a, newshape, order="C"):
    return _apply("_np_reshape", a, newshape=tuple(newshape)
                  if isinstance(newshape, (tuple, list)) else newshape,
                  order=order)


def transpose(a, axes=None):
    return _apply("_np_transpose", a,
                  axes=tuple(axes) if axes is not None else None)


def concatenate(seq, axis=0):
    return _apply_variadic("_np_concatenate", seq, axis=axis)


def stack(seq, axis=0):
    return _apply_variadic("_np_stack", seq, axis=axis)


def vstack(seq):
    seq = [atleast_2d(s) for s in seq]
    return concatenate(seq, axis=0)


def hstack(seq):
    seq = [asarray(s) for s in seq]
    if seq and seq[0].ndim == 1:
        return concatenate(seq, axis=0)
    return concatenate(seq, axis=1)


def dstack(seq):
    seq = [atleast_3d(s) for s in seq]
    return concatenate(seq, axis=2)


def atleast_1d(a):
    a = asarray(a)
    return a if a.ndim >= 1 else reshape(a, (1,))


def atleast_2d(a):
    a = asarray(a)
    if a.ndim >= 2:
        return a
    if a.ndim == 1:
        return reshape(a, (1,) + a.shape)
    return reshape(a, (1, 1))


def atleast_3d(a):
    a = asarray(a)
    if a.ndim >= 3:
        return a
    if a.ndim == 2:
        return reshape(a, a.shape + (1,))
    if a.ndim == 1:
        return reshape(a, (1,) + a.shape + (1,))
    return reshape(a, (1, 1, 1))


def split(a, indices_or_sections, axis=0):
    res = _apply("_np_split", a, indices_or_sections=indices_or_sections,
                 axis=axis)
    return list(res) if isinstance(res, tuple) else [res]


def array_split(a, n, axis=0):
    sizes = a.shape[axis]
    # the builtin (this module's ``divmod`` is ``mx.np.divmod``, which
    # the reference calls here and fails on)
    base, extra = sizes // n, sizes % n
    points, acc = [], 0
    for i in range(n - 1):
        acc += base + (1 if i < extra else 0)
        points.append(acc)
    return split(a, points, axis=axis)


def hsplit(a, n):
    return split(a, n, axis=1 if asarray(a).ndim > 1 else 0)


def vsplit(a, n):
    return split(a, n, axis=0)


def expand_dims(a, axis):
    return _apply("_np_expand_dims", a, axis=axis)


def squeeze(a, axis=None):
    return _apply("_np_squeeze", a, axis=axis)


def swapaxes(a, axis1, axis2):
    return _apply("_np_swapaxes", a, axis1=axis1, axis2=axis2)


def moveaxis(a, source, destination):
    return _apply("_np_moveaxis", a, source=source, destination=destination)


def rollaxis(a, axis, start=0):
    return _apply("_np_rollaxis", a, axis=axis, start=start)


def roll(a, shift, axis=None):
    return _apply("_np_roll", a, shift=shift, axis=axis)


def rot90(a, k=1, axes=(0, 1)):
    return _apply("_np_rot90", a, k=k, axes=axes)


def flip(a, axis=None):
    return _apply("_np_flip", a, axis=axis)


def fliplr(a):
    return flip(a, 1)


def flipud(a):
    return flip(a, 0)


def ravel(a):
    return _apply("_np_flatten", a)


def tile(a, reps):
    return _apply("_np_tile", a, reps=reps)


def repeat(a, repeats, axis=None):
    return _apply("_np_repeat", a, repeats=repeats, axis=axis)


def broadcast_to(a, shape):
    return _apply("_np_broadcast_to", a, shape=tuple(shape))


def pad(a, pad_width, mode="constant", constant_values=0):
    return _apply("_np_pad", a, pad_width=pad_width, mode=mode,
                  constant_values=constant_values)


def tril(a, k=0):
    return _apply("_np_tril", a, k=k)


def triu(a, k=0):
    return _apply("_np_triu", a, k=k)


def diag(a, k=0):
    return _apply("_np_diag", a, k=k)


def diagonal(a, offset=0, axis1=0, axis2=1):
    return _apply("_np_diagonal", a, offset=offset, axis1=axis1, axis2=axis2)


def trace(a, offset=0, axis1=0, axis2=1):
    return _apply("_np_trace", a, offset=offset, axis1=axis1, axis2=axis2)


# ------------------------------------------------------------- linear algebra

def dot(a, b):
    return _apply("dot", a, b)


def matmul(a, b):
    return _apply("_np_matmul", a, b)


def tensordot(a, b, axes=2):
    return _apply("_np_tensordot", a, b, axes=axes)


def einsum(subscripts, *operands):
    return _apply_variadic("_np_einsum", operands, subscripts=subscripts)


def outer(a, b):
    return _apply("_np_outer", a, b)


def inner(a, b):
    return _apply("_np_inner", a, b)


def kron(a, b):
    return _apply("_np_kron", a, b)


def vdot(a, b):
    return _apply("_np_vdot", a, b)


def cross(a, b, axis=-1):
    return _apply("_np_cross", a, b, axis=axis)


# ------------------------------------------------------------ search / logic

def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    return _apply("_np_where", condition, x, y)


def nonzero(a):
    return _apply("_np_nonzero", a)


def unique(a):
    return _apply("_np_unique", a)


def bincount(a, minlength=0):
    return _apply("_np_bincount", a, minlength=minlength)


def searchsorted(a, v, side="left"):
    return _apply("_np_searchsorted", a, v, side=side)


def clip(a, a_min=None, a_max=None):
    return _apply("_np_clip", a, a_min=a_min, a_max=a_max)


def round(a, decimals=0):
    return _apply("_np_round", a, decimals=decimals)


around = round


def nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    return _apply("_np_nan_to_num", a, nan=nan, posinf=posinf, neginf=neginf)


def take(a, indices, axis=None, mode="clip"):
    return _apply("_np_take", a, indices, axis=axis, mode=mode)


def take_along_axis(a, indices, axis):
    return _apply("_np_take_along_axis", a, indices, axis=axis)


def sort(a, axis=-1):
    return _apply("_np_sort", a, axis=axis)


def argsort(a, axis=-1):
    return _apply("_np_argsort", a, axis=axis)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _apply("_np_isclose", a, b, rtol=rtol, atol=atol,
                  equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return bool(_apply("_np_allclose", a, b, rtol=rtol, atol=atol,
                       equal_nan=equal_nan).asnumpy())


def array_equal(a, b):
    return bool(_apply("_np_array_equal", a, b).asnumpy())


def interp(x, xp, fp):
    return _apply("_np_interp", x, xp, fp)


def gradient(f, axis=None):
    return _apply("_np_gradient", f, axis=axis)


def maximum_(a, b):
    return maximum(a, b)  # noqa: F821


def abs_(a):
    return absolute(a)  # noqa: F821


def may_share_memory(a, b):
    return False


def shape(a):
    return asarray(a).shape


def ndim(a):
    return asarray(a).ndim


def size(a):
    return asarray(a).size


def _scalarize_q(q):
    # q may be scalar, list, or (nd)array (numpy semantics); attrs skip
    # the NDArray unwrap, so convert array-likes here
    if hasattr(q, "asnumpy"):
        return q.asnumpy()
    return q


def percentile(a, q, axis=None, keepdims=False):
    return _apply("_np_percentile", a, q=_scalarize_q(q), axis=axis,
                  keepdims=keepdims)


def quantile(a, q, axis=None, keepdims=False):
    return _apply("_np_quantile", a, q=_scalarize_q(q), axis=axis,
                  keepdims=keepdims)


def cov(m, rowvar=True, bias=False, ddof=None):
    return _apply("_np_cov", m, rowvar=rowvar, bias=bias, ddof=ddof)


def histogram(a, bins=10, range=None):
    return _apply("_np_histogram", a, bins=bins, range=range)


def broadcast_arrays(*args):
    ts = [_to_input(a) for a in args]
    outs = torch.broadcast_tensors(*[a._data if isinstance(a, NDArray)
                                     else torch.tensor(a) for a in ts])
    return [ndarray(o) for o in outs]


def column_stack(tup):
    return _apply("_np_column_stack", *tup)


def digitize(x, bins, right=False):
    return _apply("_np_digitize", x, bins, right=right)


def diff(a, n=1, axis=-1):
    return _apply("_np_diff", a, n=n, axis=axis)


def trapz(y, dx=1.0, axis=-1):
    return _apply("_np_trapz", y, dx=dx, axis=axis)


def ediff1d(ary):
    return _apply("_np_ediff1d", ary)


# ------------------------------------------------------- generated long-tail

def _gen_np_fn(np_name, n_array_args=1):
    op_name = "_np_" + np_name

    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        arrays = args[:n_array_args]
        rest = args[n_array_args:]
        if rest:
            r = _apply(op_name, *arrays, pos_attrs=tuple(rest),
                       **kwargs)
        else:
            r = _apply(op_name, *arrays, **kwargs)
        if out is not None:
            if isinstance(r, tuple):
                for o, v in zip(out, r):
                    o[...] = v
            else:
                out[...] = r
            return out
        return r
    fn.__name__ = np_name
    return fn


for _nm in ["real", "imag", "conj", "angle", "sinc", "i0", "deg2rad",
            "rad2deg", "positive", "fliplr", "flipud", "unwrap",
            "nanmax", "nanmin", "nanstd", "nanvar", "ptp", "signbit",
            "nanargmax", "nanargmin", "count_nonzero", "argwhere",
            "flatnonzero", "vander", "frexp", "modf", "spacing"]:
    if _nm not in globals():
        globals()[_nm] = _gen_np_fn(_nm, 1)

for _nm in ["fmax", "fmin", "float_power", "ldexp", "logaddexp2",
            "nextafter", "gcd", "lcm", "isin", "in1d", "convolve",
            "correlate", "polyval", "divmod"]:
    if _nm not in globals():
        globals()[_nm] = _gen_np_fn(_nm, 2)


def _gen_creation_fn(np_name):
    op_name = "_np_" + np_name

    def fn(*args, **kwargs):
        return _apply(op_name, pos_attrs=tuple(args), **kwargs)
    fn.__name__ = np_name
    return fn


for _nm in ["bartlett", "blackman", "hamming", "hanning", "kaiser",
            "tri", "indices"]:
    if _nm not in globals():
        globals()[_nm] = _gen_creation_fn(_nm)
