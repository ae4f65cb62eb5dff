"""NDArray: MXNet's mutable array over one ``torch.Tensor``.

Port of ``mxnet_tpu/ndarray/ndarray.py`` (creation, host copies,
context moves, the Python operators and comparisons through the op
registry, in-place ``+=``/``-=``/``*=``/``/=``, the reference's method
mirrors of ops, indexing and slice assignment, ``attach_grad`` /
``grad`` / ``backward``, and ``save`` / ``load`` in the ``MXTP0001``
container).  The reference swaps an immutable buffer on every mutation;
here a mutation writes into the tensor in place (:meth:`NDArray._set_data`
copies under ``torch.no_grad``), so a variable stays the same torch leaf
across optimizer updates.  PyTorch's stream is the engine: ops return
at once and ``asnumpy`` synchronises.
"""
from __future__ import annotations

import struct
import weakref

import numpy as np
import torch

from ..base import MXNetError, numeric_types
from ..context import Context, cpu

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "stack", "from_numpy", "save", "load", "waitall"]

# set by profiler.py while memory profiling runs: called with every
# tensor an NDArray takes (the reference's chunk-buffer hook)
_MEM_HOOK = None

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.float16: np.float16, torch.int64: np.int64,
          torch.int32: np.int32, torch.int8: np.int8, torch.uint8: np.uint8,
          torch.bool: np.bool_}


class _BFloat16Dtype:
    """``NDArray.dtype`` of a bfloat16 array.  numpy has no bfloat16 (the
    reference's comes from JAX's ``ml_dtypes``), so this stands in for
    it: its ``str`` and ``name`` are ``'bfloat16'``, it equals
    ``'bfloat16'`` and ``torch.bfloat16``, and every dtype argument of
    the port takes it."""

    name = "bfloat16"
    itemsize = 2

    def __str__(self):
        return "bfloat16"

    def __repr__(self):
        return "dtype(bfloat16)"

    def __eq__(self, other):
        if isinstance(other, _BFloat16Dtype):
            return True
        if isinstance(other, torch.dtype):
            return other == torch.bfloat16
        return isinstance(other, str) and other == "bfloat16"

    def __hash__(self):
        return hash("bfloat16")


_BF16 = _BFloat16Dtype()


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":        # numpy has none of its own
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class NDArray:
    """Multi-dimensional array with MXNet's mutation semantics."""

    # ``_reach``: a variable (any grad_req) is upstream of this array on
    # the autograd tape; set by ``_mark_variable`` and by ``invoke`` under
    # ``record()``, left unset otherwise
    __slots__ = ("_data", "_ctx", "_version", "_grad", "_grad_req", "_hook",
                 "_reach", "__weakref__")

    def __init__(self, data, ctx: Context = None):
        """An array over ``data``: a tensor (taken as it is), an NDArray
        (its tensor) or anything numpy reads (copied, float64 made
        float32 as :func:`array` does); ``ctx`` moves it there."""
        if isinstance(data, NDArray):
            ctx = data._ctx if ctx is None else ctx
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = array(data, ctx=ctx)._data
        if ctx is not None:
            data = _place(data, ctx)
        self._data = data
        self._ctx = _host_ctx(ctx)
        self._version = 0
        self._grad = None
        self._grad_req = "null"
        self._hook = None
        if _MEM_HOOK is not None:
            _MEM_HOOK(data)

    def _set_data(self, new):
        """Write ``new`` into this array: in place when shape, dtype and
        device match (a variable always), else by taking the tensor."""
        if new is self._data:
            return
        self._version += 1
        d = self._data
        if (new.shape == d.shape and new.dtype == d.dtype
                and new.device == d.device):
            with torch.no_grad():
                d.copy_(new)
        elif d.requires_grad:
            raise MXNetError("cannot change the shape, dtype or device of a "
                             "variable (attach_grad) in place")
        else:
            self._data = new.detach()
            if _MEM_HOOK is not None:
                _MEM_HOOK(self._data)

    def _mark_variable(self, grad, req):
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        self._data = self._data.detach().requires_grad_(req != "null")
        self._grad, self._grad_req = grad, req
        self._reach = True
        if req != "null":
            from ..autograd import _deliver
            ref = weakref.ref(self)
            self._hook = self._data.register_post_accumulate_grad_hook(
                lambda t: _deliver(t, ref))

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (the torch dtype where numpy has none)."""
        dt = self._data.dtype
        if dt in _NP_OF:
            return np.dtype(_NP_OF[dt])
        return _BF16 if dt == torch.bfloat16 else dt

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        """The context the array was made on: ``cpu(i)`` contexts share
        the host's one torch device, so the array carries its own and an
        op's output takes it from its first such input."""
        c = self._ctx
        if c is not None and self._data.device.type == "cpu":
            return c
        return Context.of(self._data.device)

    ctx = context

    @property
    def grad(self):
        return self._grad

    @property
    def version(self) -> int:
        """How many times this array was written to in place."""
        return self._version

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    # -- sync and host copies ----------------------------------------------
    def wait_to_read(self):
        """Wait until the value is computed (reference
        ``Engine::WaitForVar``); a deferred device error surfaces here."""
        from ..engine import Engine
        Engine.wait_for_var(self._data)
        return self

    def asnumpy(self) -> np.ndarray:
        """A host copy; bfloat16 (which numpy lacks) comes back as
        float32, which holds it exactly."""
        t = self._data.detach().to("cpu", copy=True)   # never a view
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("Ambiguous truth value of multi-element NDArray")

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(d) for d in self.shape),
            self.context)

    # -- context moves -----------------------------------------------------
    def as_in_context(self, ctx: Context) -> "NDArray":
        return self if ctx == self.context else self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True), other)
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device))
            return other
        raise MXNetError("copyto target must be Context or NDArray")

    def copy(self) -> "NDArray":
        return _tagged(NDArray(self._data.detach().clone()), self._ctx)

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        """A copy in ``dtype`` (this array when ``copy=False`` and the
        dtype already matches)."""
        if not copy and _torch_dtype(dtype) == self._data.dtype:
            return self
        return _tagged(NDArray(self._data.detach().to(_torch_dtype(dtype),
                                                      copy=True)), self._ctx)

    def detach(self) -> "NDArray":
        return _tagged(NDArray(self._data.detach()), self._ctx)

    def tostype(self, stype):
        """A copy in storage ``stype`` (``default``, ``row_sparse`` or
        ``csr``); always a new array, as in the reference."""
        if stype == "default":
            return self.copy()
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def todense(self):
        return self.copy()

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and make this a variable.  The
        buffer is dense whatever ``stype`` says, as in the reference: a
        ``row_sparse`` gradient is made from it where an optimizer
        update reads it (``gluon.Trainer``)."""
        from .. import autograd
        autograd.mark_variables([self], [_tagged(NDArray(torch.zeros_like(
            self._data.detach())), self._ctx)], [grad_req])

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- operators through the registry -----------------------------------
    def _binop(self, other, op_name, scalar_op):
        from ..ops.registry import get_op, invoke
        if isinstance(other, NDArray):
            return invoke(get_op(op_name), [self, other])
        if isinstance(other, numeric_types + (bool, np.generic)):
            return invoke(get_op(scalar_op), [self],
                          attrs={"scalar": float(other)})
        return NotImplemented

    def _unop(self, op_name):
        from ..ops.registry import get_op, invoke
        return invoke(get_op(op_name), [self])

    def __add__(self, other):
        return self._binop(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binop(other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return self._binop(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binop(other, "broadcast_div", "_rdiv_scalar")

    def __floordiv__(self, other):
        return self._binop(other, "_broadcast_floordiv", "_floordiv_scalar")

    def __mod__(self, other):
        return self._binop(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binop(other, "broadcast_mod", "_rmod_scalar")

    def __pow__(self, other):
        return self._binop(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binop(other, "broadcast_power", "_rpower_scalar")

    def __matmul__(self, other):
        from ..ops.registry import get_op, invoke
        return invoke(get_op("_npi_matmul"), [self, other])

    def __neg__(self):
        return self._unop("negative")

    def __abs__(self):
        return self._unop("abs")

    # comparisons give an array of 0/1 in this array's dtype; an array
    # hashes by identity, as in the reference
    def __eq__(self, other):
        if other is None:
            return False
        return self._binop(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
        return self._binop(other, "broadcast_not_equal",
                           "_not_equal_scalar")

    def __gt__(self, other):
        return self._binop(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace(self, other, op_name, scalar_op):
        """``self op= other``: the result written into this array, refused
        on a variable while recording."""
        from .. import autograd
        if autograd.is_recording() and self._data.requires_grad:
            raise MXNetError("Inplace update on a recorded array is not "
                             "allowed under autograd.record()")
        res = self._binop(other, op_name, scalar_op)
        if res is NotImplemented:
            return res
        self._set_data(res._data)
        return self

    def __iadd__(self, other):
        return self._inplace(other, "broadcast_add", "_plus_scalar")

    def __isub__(self, other):
        return self._inplace(other, "broadcast_sub", "_minus_scalar")

    def __imul__(self, other):
        return self._inplace(other, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, other):
        return self._inplace(other, "broadcast_div", "_div_scalar")

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, key):
        """Basic slicing (ints, slices, ``None``, ``...``) and integer or
        boolean NDArray indices; the result is a new array, recorded
        like any op (reference ``NDArray.__getitem__``)."""
        from ..ops.registry import OpDef, invoke
        arrays = _index_arrays(key)

        def impl(data, *idx):
            out = data[_rebuild_index(key, idx)]
            return out.clone() if out._base is not None else out

        return invoke(OpDef("_getitem", impl), [self] + arrays)

    def __setitem__(self, key, value):
        """Write ``value`` (an NDArray or a number, broadcast) into the
        indexed part in place; refused on a recorded array while
        recording (reference ``NDArray.__setitem__``)."""
        from .. import autograd
        if autograd.is_recording() and self._data.requires_grad:
            raise MXNetError("Slice-assign on a recorded array is not "
                             "allowed under autograd.record()")
        k = _rebuild_index(key, [a._data for a in _index_arrays(key)])
        v = value._data if isinstance(value, NDArray) else value
        with torch.no_grad():
            self._data[k] = v
        self._version += 1

    def _op(self, op_name, **attrs):
        from ..ops.registry import get_op, invoke
        return invoke(get_op(op_name), [self], attrs=attrs)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self._op("reshape", shape=shape)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=axes if axes else None)

    def flatten(self):
        return self._op("Flatten")

    def flip(self, axis):
        return self._op("flip", axis=axis)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)


def _index_arrays(key):
    """The NDArrays of an index key, in order."""
    if isinstance(key, NDArray):
        return [key]
    if isinstance(key, tuple):
        return [k for k in key if isinstance(k, NDArray)]
    return []


def _rebuild_index(key, tensors):
    """``key`` with its NDArrays replaced by ``tensors`` (integer
    indices as int64, boolean masks kept)."""
    it = iter(tensors)

    def one(k):
        if not isinstance(k, NDArray):
            return k
        t = next(it)
        return t if t.dtype == torch.bool else t.long()

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


# NDArray methods that mirror registered ops (reference _METHOD_OPS),
# installed by ndarray/__init__.py
_METHOD_OPS = (
    "sum", "mean", "max", "min", "prod", "argmax", "argmin", "abs", "exp",
    "log", "sqrt", "square", "clip", "round", "floor", "ceil", "sign",
    "relu", "sigmoid", "tanh", "softmax", "log_softmax", "norm", "sort",
    "argsort", "topk", "one_hot", "take", "pick", "dot", "split",
    "slice_axis", "slice_like", "swapaxes", "repeat", "pad", "nansum",
    "nanprod", "cumsum", "diag", "zeros_like", "ones_like",
)


def _install_methods():
    from ..ops import registry as _r

    def make(opname):
        def method(self, *args, **kwargs):
            extra = [a for a in args if isinstance(a, NDArray)]
            pos = tuple(a for a in args if not isinstance(a, NDArray))
            return _r.invoke(_r.get_op(opname), [self] + extra,
                             pos_attrs=pos, attrs=kwargs)
        method.__name__ = opname
        return method

    for opname in _METHOD_OPS:
        if not hasattr(NDArray, opname) and _r.op_exists(opname):
            setattr(NDArray, opname, make(opname))


def waitall():
    """Wait for all device work (reference ``mx.nd.waitall``)."""
    from ..engine import Engine
    Engine.get().wait_for_all()


# ---------------------------------------------------------------------------
# creation (reference mx.nd.array/zeros/ones)
# ---------------------------------------------------------------------------
def _device(ctx):
    """``ctx``'s device, else the creation device: the innermost
    ``registry.device_scope`` (inside a ``hybrid_forward``, the first
    input's device), else the current context's."""
    if ctx is not None:
        return ctx.torch_device
    from ..ops.registry import creation_device
    return creation_device()


def _host_ctx(ctx):
    """``ctx`` where the tensor's device does not name it (``cpu(i)``,
    ``i > 0``), else None."""
    if ctx is not None and ctx.device_id and ctx.device_type == "cpu":
        return ctx
    return None


def _tagged(arr, ctx):
    """``arr`` marked as made on ``ctx`` (see :attr:`NDArray.context`)."""
    arr._ctx = _host_ctx(ctx)
    return arr


def _lead_ctx(inputs):
    """The context an op's outputs take from its inputs: that of the
    first input made on a ``cpu(i)``, ``i > 0``, else None."""
    for a in inputs:
        if isinstance(a, NDArray) and a._ctx is not None:
            return a._ctx
    return None


def _place(t, ctx):
    """``t`` on ``ctx``'s device, page-locked for ``cpu_pinned``."""
    t = t.to(ctx.torch_device)
    if ctx.device_type == "cpu_pinned" and not t.is_pinned():
        t = t.pin_memory()
    return t


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An array on ``ctx`` (default: the current context) holding a copy
    of ``source_array``; float64 sources become float32 unless
    ``dtype`` says otherwise, as in the reference."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    a = np.asarray(source_array, dtype=dtype)
    if a.dtype == np.float64 and dtype is None:
        a = a.astype(np.float32)
    return NDArray(torch.from_numpy(np.array(a, copy=True))
                   .to(_device(ctx)), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=_torch_dtype(
        dtype or "float32"), device=_device(ctx)), ctx)


def ones(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=_torch_dtype(
        dtype or "float32"), device=_device(ctx)), ctx)


def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=_torch_dtype(
        dtype or "float32"), device=_device(ctx)), ctx)


def empty(shape, ctx=None, dtype="float32") -> NDArray:
    """Zeros, as in the reference."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def from_numpy(np_array, zero_copy=False) -> NDArray:
    """A copy of ``np_array`` on the current context."""
    return array(np_array)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    """numpy's ``arange`` in ``dtype``, each value ``repeat`` times."""
    from ..ops.registry import get_op, invoke
    return invoke(get_op("_arange"), [], attrs={
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype}, ctx=ctx)


def concat(*arrays, dim=1) -> NDArray:
    from ..ops.registry import get_op, invoke
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return invoke(get_op("Concat"), list(arrays), attrs={"dim": dim})


def stack(*arrays, axis=0) -> NDArray:
    from ..ops.registry import get_op, invoke
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return invoke(get_op("stack"), list(arrays), attrs={"axis": axis})


# ---------------------------------------------------------------------------
# save / load: the reference's ``.params`` container ("MXTP0001"), kept
# byte for byte so a file written by either package loads in the other:
# magic, u64 count, then per entry u32 name length + utf-8 name, u32
# dtype-string length + numpy dtype string, u32 ndim + i64 dims, u64
# payload length + C-order bytes.
# ---------------------------------------------------------------------------
_PARAMS_MAGIC = b"MXTP0001"


def save(fname: str, data):
    """Write an NDArray, a list of them or a name -> NDArray dict."""
    if isinstance(data, NDArray):
        data = [("", data)]
    if isinstance(data, dict):
        data = list(data.items())
    elif isinstance(data, (list, tuple)) and not (
            data and isinstance(data[0], tuple)):
        data = [("", d) for d in data]
    with open(fname, "wb") as f:
        f.write(_PARAMS_MAGIC)
        f.write(struct.pack("<Q", len(data)))
        for name, arr in data:
            nb = name.encode("utf-8")
            a = arr.asnumpy() if isinstance(arr, NDArray) else np.asarray(arr)
            dt = a.dtype.str.encode()
            f.write(struct.pack("<I", len(nb)) + nb)
            f.write(struct.pack("<I", len(dt)) + dt)
            f.write(struct.pack("<I", a.ndim))
            for d in a.shape:
                f.write(struct.pack("<q", d))
            payload = np.ascontiguousarray(a).tobytes()
            f.write(struct.pack("<Q", len(payload)) + payload)


def load(fname: str):
    """Read a file written by :func:`save` (or by the reference's
    ``nd.save``) into CPU arrays: a dict when entries are named, else a
    list."""
    with open(fname, "rb") as f:
        magic = f.read(8)
        if magic != _PARAMS_MAGIC:
            raise MXNetError("Invalid parameter file %s (bad magic %r)"
                             % (fname, magic))
        (count,) = struct.unpack("<Q", f.read(8))
        entries = []
        for _ in range(count):
            (nlen,) = struct.unpack("<I", f.read(4))
            name = f.read(nlen).decode("utf-8")
            (dlen,) = struct.unpack("<I", f.read(4))
            dt = np.dtype(f.read(dlen).decode())
            (ndim,) = struct.unpack("<I", f.read(4))
            shape = tuple(struct.unpack("<q", f.read(8))[0]
                          for _ in range(ndim))
            (plen,) = struct.unpack("<Q", f.read(8))
            a = np.frombuffer(f.read(plen), dtype=dt).reshape(shape)
            entries.append((name, array(a, ctx=cpu(), dtype=dt)))
    if any(name for name, _ in entries):
        return dict(entries)
    return [arr for _, arr in entries]
