"""NDArray: MXNet's mutable array over one ``torch.Tensor``.

Port of ``mxnet_tpu/ndarray/ndarray.py`` (creation, host copies,
context moves, arithmetic through the op registry, indexing and slice
assignment, ``attach_grad`` /
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
from ..context import Context, cpu, current_context

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load"]

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.float16: np.float16, torch.int64: np.int64,
          torch.int32: np.int32, torch.int8: np.int8, torch.uint8: np.uint8,
          torch.bool: np.bool_}


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class NDArray:
    """Multi-dimensional array with MXNet's mutation semantics."""

    __slots__ = ("_data", "_grad", "_grad_req", "_hook", "__weakref__")

    def __init__(self, data: torch.Tensor):
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._hook = None

    def _set_data(self, new):
        """Write ``new`` into this array: in place when shape, dtype and
        device match (a variable always), else by taking the tensor."""
        if new is self._data:
            return
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

    def _mark_variable(self, grad, req):
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        self._data = self._data.detach().requires_grad_(req != "null")
        self._grad, self._grad_req = grad, req
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
        return np.dtype(_NP_OF[dt]) if dt in _NP_OF else dt

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.of(self._data.device)

    ctx = context

    @property
    def grad(self):
        return self._grad

    # -- host copies -------------------------------------------------------
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

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device))
            return other
        raise MXNetError("copyto target must be Context or NDArray")

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach().clone())

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Allocate a zero gradient buffer and make this a variable."""
        from .. import autograd
        autograd.mark_variables([self], [NDArray(torch.zeros_like(
            self._data.detach()))], [grad_req])

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

    def __neg__(self):
        from ..ops.registry import get_op, invoke
        return invoke(get_op("negative"), [self])

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

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        from ..ops.registry import get_op, invoke
        return invoke(get_op("reshape"), [self], attrs={"shape": shape})


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


# NDArray methods that mirror registered ops (reference _METHOD_OPS); the
# ones the port has are installed by ndarray/__init__.py
_METHOD_OPS = ("sum", "mean", "pick", "softmax", "log_softmax")


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


# ---------------------------------------------------------------------------
# creation (reference mx.nd.array/zeros/ones)
# ---------------------------------------------------------------------------
def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device


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
                   .to(_device(ctx)))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=_torch_dtype(
        dtype or "float32"), device=_device(ctx)))


def ones(shape, ctx=None, dtype="float32", **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=_torch_dtype(
        dtype or "float32"), device=_device(ctx)))


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
