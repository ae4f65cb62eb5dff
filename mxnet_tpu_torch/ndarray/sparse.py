"""Sparse NDArray storage types: ``row_sparse`` and ``csr``.

Port of ``mxnet_tpu/ndarray/sparse.py``.  A sparse array keeps its
compact value block in ``_data`` (a tensor on its device) and its index
tensors in ``_aux``, beside the logical dense shape.  The sparse-friendly
ops run on the value block with index ops: ``dot(csr, dense)`` gathers
rows (``index_select``) and sums products by row (``index_add_``),
``retain`` and the row-sparse merges gather and sum by row id, and the
lazy optimizer updates read and write only the gradient's rows
(``index_select`` / ``index_copy_``).  Elementwise math on mixed storage
falls back to dense with one warning per op name, MXNet's storage-type
fallback.

Structure is found on the host, as in the reference: a ``row_sparse``
cast reduces a row mask on the device and reads it back once
(:func:`_host`), and ``dot(csr.T, dense)`` takes the unique column ids
on the host.  Row ids are sorted ``int32``, as the reference stores
them.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context
from .ndarray import NDArray, _device, _torch_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "csr_matrix", "row_sparse_array", "array", "empty", "zeros",
           "cast_storage", "retain", "dot", "add_n", "elemwise_add",
           "elemwise_sub", "elemwise_mul", "sgd_update", "sgd_mom_update",
           "adam_update"]

_warned_fallback = set()


def _fallback_warn(opname):
    if opname not in _warned_fallback:
        _warned_fallback.add(opname)
        warnings.warn(
            "sparse %s executes as a dense fallback (reference behavior: "
            "stype fallback when no FComputeEx is registered)" % opname,
            stacklevel=3)


def _host(t) -> np.ndarray:
    """A device tensor read back to the host: every structure read of
    this module goes through here (one synchronisation each)."""
    return t.detach().cpu().numpy()


def _ids(a, device):
    """Index array ``a`` (numpy) as an int64 tensor on ``device`` (for
    ``index_select``/``index_add_``)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def _i32(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)


class BaseSparseNDArray(NDArray):
    """Common base of :class:`CSRNDArray` and :class:`RowSparseNDArray`:
    ``_data`` the compact value block, ``_aux`` the index tensors (on
    the same device), ``_sparse_shape`` the logical dense shape."""

    __slots__ = ("_aux", "_sparse_shape")

    def __init__(self, values, aux, shape, ctx=None):
        super().__init__(values, ctx=ctx)
        dev = self._data.device
        self._aux = {k: v.to(dev) for k, v in aux.items()}
        self._sparse_shape = tuple(int(d) for d in shape)

    # -- the dense NDArray surface, overridden -----------------------------
    @property
    def shape(self):
        return self._sparse_shape

    @property
    def size(self) -> int:
        return int(np.prod(self._sparse_shape))

    @property
    def ndim(self) -> int:
        return len(self._sparse_shape)

    @property
    def data(self) -> NDArray:
        """The compact value block."""
        return NDArray(self._data)

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"])

    def asnumpy(self):
        return NDArray(self._to_dense()).asnumpy()

    def wait_to_read(self):
        NDArray(self._data).wait_to_read()
        return self

    def todense(self) -> NDArray:
        return NDArray(self._to_dense())

    to_dense = todense

    def tostype(self, stype):
        return cast_storage(self, stype)

    def astype(self, dtype, copy: bool = True):
        """The same storage with its values in ``dtype``."""
        if not copy and _torch_dtype(dtype) == self._data.dtype:
            return self
        return self.__class__(self._data.detach().to(_torch_dtype(dtype)),
                              {k: v.clone() for k, v in self._aux.items()},
                              self._sparse_shape)

    def copy(self):
        return self.__class__(self._data.detach().clone(),
                              {k: v.clone() for k, v in self._aux.items()},
                              self._sparse_shape)

    def copyto(self, other):
        if isinstance(other, Context):
            return self.__class__(self._data.detach().clone(),
                                  {k: v.clone()
                                   for k, v in self._aux.items()},
                                  self._sparse_shape, ctx=other)
        if isinstance(other, BaseSparseNDArray):
            other._set_data(self._data.detach().to(other._data.device))
            other._aux = {k: v.to(other._data.device)
                          for k, v in self._aux.items()}
            other._sparse_shape = self._sparse_shape
            return other
        if isinstance(other, NDArray):
            other._set_data(self._to_dense().to(other._data.device))
            return other
        raise MXNetError("copyto: unsupported target %r" % (other,))

    def _dense(self) -> NDArray:
        return NDArray(self._to_dense())

    # -- arithmetic: sparse where the stypes allow, else dense ------------
    def _fb(self, opname, fn, *others):
        _fallback_warn(opname)
        args = [o._dense() if isinstance(o, BaseSparseNDArray) else o
                for o in others]
        return fn(self._dense(), *args)

    def __add__(self, other):
        if isinstance(other, BaseSparseNDArray) and other.stype == self.stype:
            return elemwise_add(self, other)
        return self._fb("add", lambda a, b: a + b, other)

    def __sub__(self, other):
        if isinstance(other, BaseSparseNDArray) and other.stype == self.stype:
            return elemwise_sub(self, other)
        return self._fb("sub", lambda a, b: a - b, other)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self.__class__(self._data * other, dict(self._aux),
                                  self._sparse_shape)
        if isinstance(other, BaseSparseNDArray) and other.stype == self.stype:
            return elemwise_mul(self, other)
        return self._fb("mul", lambda a, b: a * b, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, (int, float)):
            return self.__class__(self._data / other, dict(self._aux),
                                  self._sparse_shape)
        return self._fb("div", lambda a, b: a / b, other)

    def __repr__(self):
        return "\n<%s %s @%s>" % (
            type(self).__name__,
            "x".join(str(d) for d in self._sparse_shape), self.context)

    def check_format(self, full_check=True):
        raise NotImplementedError


class RowSparseNDArray(BaseSparseNDArray):
    """``row_sparse``: a subset of rows stored densely.

    ``indices``: sorted unique int32 row ids, shape ``(nnz_rows,)``;
    ``data``: shape ``(nnz_rows,) + shape[1:]``.  The storage type of
    sparse gradients (Embedding ``sparse_grad``)."""

    @property
    def stype(self):
        return "row_sparse"

    def _to_dense(self):
        d = self._data.detach()
        dense = torch.zeros(self._sparse_shape, dtype=d.dtype,
                            device=d.device)
        if d.shape[0]:
            dense.index_copy_(0, self._aux["indices"].long(), d)
        return dense

    def retain(self, row_ids):
        return retain(self, row_ids)

    def check_format(self, full_check=True):
        idx = _host(self._aux["indices"])
        if idx.ndim != 1:
            raise MXNetError("row_sparse indices must be 1-D")
        if idx.size and ((idx[1:] <= idx[:-1]).any() or idx[0] < 0
                         or idx[-1] >= self._sparse_shape[0]):
            raise MXNetError("row_sparse indices must be sorted, unique and "
                             "within [0, num_rows)")
        if tuple(self._data.shape) != (idx.size,) + self._sparse_shape[1:]:
            raise MXNetError("row_sparse data shape mismatch")

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._dense()[key]
        raise MXNetError("row_sparse only supports integer row indexing")


class CSRNDArray(BaseSparseNDArray):
    """``csr``: compressed sparse row, 2-D only.

    ``data``: nnz values; ``indices``: nnz int32 column ids; ``indptr``:
    the int32 row pointer of length ``num_rows + 1``."""

    @property
    def stype(self):
        return "csr"

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._aux["indptr"])

    def _to_dense(self):
        d = self._data.detach()
        dense = torch.zeros(self._sparse_shape, dtype=d.dtype,
                            device=d.device)
        nnz = d.shape[0]
        if nnz == 0:
            return dense
        rows = _csr_row_of_nnz(self._aux["indptr"], nnz)
        dense[rows, self._aux["indices"].long()] = d
        return dense

    def asscipy(self):
        import scipy.sparse as sps
        return sps.csr_matrix(
            (_host(self._data), _host(self._aux["indices"]),
             _host(self._aux["indptr"])), shape=self._sparse_shape)

    def check_format(self, full_check=True):
        indptr = _host(self._aux["indptr"])
        idx = _host(self._aux["indices"])
        if len(self._sparse_shape) != 2:
            raise MXNetError("csr must be 2-D")
        if indptr.shape != (self._sparse_shape[0] + 1,):
            raise MXNetError("csr indptr length must be num_rows+1")
        if indptr[0] != 0 or indptr[-1] != idx.size or \
                (indptr[1:] < indptr[:-1]).any():
            raise MXNetError("csr indptr must be monotone from 0 to nnz")
        if idx.size and (idx.min() < 0 or idx.max() >= self._sparse_shape[1]):
            raise MXNetError("csr indices out of range")

    def __getitem__(self, key):
        if isinstance(key, int):
            key = slice(key, key + 1)
        if isinstance(key, slice):
            start, stop, step = key.indices(self._sparse_shape[0])
            if step != 1:
                raise MXNetError("csr slicing requires step 1")
            indptr = _host(self._aux["indptr"])
            lo, hi = int(indptr[start]), int(indptr[stop])
            new_indptr = _i32(indptr[start:stop + 1] - indptr[start],
                              self._data.device)
            return CSRNDArray(self._data[lo:hi],
                              {"indices": self._aux["indices"][lo:hi],
                               "indptr": new_indptr},
                              (stop - start, self._sparse_shape[1]))
        raise MXNetError("csr supports int/slice row indexing only")


def _csr_row_of_nnz(indptr, nnz):
    """The row id of each stored entry (int64, on the device):
    ``searchsorted`` over the row pointer."""
    return torch.searchsorted(
        indptr.long(), torch.arange(nnz, device=indptr.device),
        right=True) - 1


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _as_tensor(x, dtype=None, ctx=None):
    """``x`` (an NDArray, a tensor or anything numpy reads) as a tensor:
    an array stays on its device unless ``ctx`` is given, host data goes
    to ``ctx`` or the current context; ``dtype`` as numpy names it."""
    if isinstance(x, NDArray):
        t = x._data.detach()
    elif isinstance(x, torch.Tensor):
        t = x.detach()
    else:
        a = np.asarray(x)
        if dtype is None and a.dtype == np.float64:
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, copy=True)).to(_device(ctx))
    if ctx is not None:
        t = t.to(ctx.torch_device)
    if dtype is not None:
        t = t.to(_torch_dtype(dtype))
    return t


def _np_of(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return _host(x)
    return np.asarray(x)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`RowSparseNDArray` from ``(data, indices)``, a dense
    source or another row_sparse array; indices are sorted, with their
    rows."""
    if isinstance(arg1, RowSparseNDArray):
        return arg1.copy()
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 and not \
            np.isscalar(arg1[0]):
        data = _as_tensor(arg1[0], dtype, ctx)
        indices = _np_of(arg1[1]).astype(np.int64)
        if not (indices[:-1] < indices[1:]).all():
            order = np.argsort(indices, kind="stable")
            indices = indices[order]
            data = data.index_select(0, _ids(order, data.device))
        if shape is None:
            nrows = int(indices[-1]) + 1 if indices.size else 0
            shape = (nrows,) + tuple(data.shape[1:])
        return RowSparseNDArray(data, {"indices": _i32(indices, data.device)},
                                shape)
    return cast_storage(NDArray(_as_tensor(arg1, dtype, ctx)), "row_sparse")


def _from_scipy(m, ctx, dtype):
    dev = _device(ctx)
    data = np.asarray(m.data)
    if dtype is None and data.dtype == np.float64:
        data = data.astype(np.float32)
    return CSRNDArray(_as_tensor(data, dtype, ctx),
                      {"indices": _i32(m.indices, dev),
                       "indptr": _i32(m.indptr, dev)}, m.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`CSRNDArray` from ``(data, indices, indptr)``, a dense 2-D
    source, a scipy.sparse matrix or ``(data, (row, col))``."""
    import scipy.sparse as sps
    if sps.issparse(arg1):
        return _from_scipy(arg1.tocsr(), ctx, dtype)
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = arg1
        data = _as_tensor(data, dtype, ctx)
        indptr = _as_tensor(indptr, None, ctx).to(torch.int32)
        indices = _as_tensor(indices, None, ctx).to(torch.int32)
        if shape is None:
            ncols = int(_host(indices).max()) + 1 if indices.numel() else 0
            shape = (int(indptr.shape[0]) - 1, ncols)
        return CSRNDArray(data, {"indices": indices, "indptr": indptr},
                          shape)
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 and \
            isinstance(arg1[1], (tuple, list)):
        data, (row, col) = arg1
        m = sps.csr_matrix((_np_of(data), (_np_of(row), _np_of(col))),
                           shape=shape)
        return _from_scipy(m, ctx, dtype)
    return cast_storage(NDArray(_as_tensor(arg1, dtype, ctx)), "csr")


def array(source_array, ctx=None, dtype=None):
    """Sparse-aware ``array``: scipy matrices become csr, sparse
    NDArrays are copied."""
    import scipy.sparse as sps
    if isinstance(source_array, BaseSparseNDArray):
        return source_array.copy()
    if sps.issparse(source_array):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise MXNetError("sparse.array expects a sparse source; use nd.array "
                     "for dense")


def zeros(stype, shape, ctx=None, dtype=None):
    dtype = _torch_dtype(dtype or "float32")
    if isinstance(shape, int):
        shape = (shape,)
    dev = _device(ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + tuple(shape[1:]), dtype=dtype, device=dev),
            {"indices": torch.zeros((0,), dtype=torch.int32, device=dev)},
            shape)
    if stype == "csr":
        return CSRNDArray(
            torch.zeros((0,), dtype=dtype, device=dev),
            {"indices": torch.zeros((0,), dtype=torch.int32, device=dev),
             "indptr": torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                   device=dev)}, shape)
    if stype == "default":
        return NDArray(torch.zeros(tuple(shape), dtype=dtype, device=dev))
    raise MXNetError("unknown stype %r" % (stype,))


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# storage casts (reference: the cast_storage op)
# ---------------------------------------------------------------------------
def cast_storage(arr, stype):
    """``arr`` in storage ``stype``, on its device.  Dense to
    ``row_sparse`` keeps the rows with a nonzero element: the row mask
    is reduced on the device and read back once; the gather stays on
    the device."""
    cur = arr.stype
    if cur == stype:
        return arr.copy() if isinstance(arr, BaseSparseNDArray) else arr
    if stype == "default":
        return arr.todense()
    if cur != "default":
        return cast_storage(arr.todense(), stype)
    d = arr._data.detach()
    if stype == "row_sparse":
        mask = (d != 0).reshape(d.shape[0], -1).any(1) if d.dim() > 1 \
            else d != 0
        nz = np.nonzero(_host(mask))[0]
        return RowSparseNDArray(d.index_select(0, _ids(nz, d.device)),
                                {"indices": _i32(nz, d.device)},
                                tuple(d.shape))
    if stype == "csr":
        if d.dim() != 2:
            raise MXNetError("csr requires 2-D")
        import scipy.sparse as sps
        return csr_matrix(sps.csr_matrix(arr.asnumpy()), ctx=arr.context,
                          dtype=d.dtype)
    raise MXNetError("unknown stype %r" % (stype,))


# ---------------------------------------------------------------------------
# sparse ops
# ---------------------------------------------------------------------------
def retain(rsp, indices):
    """The rows of ``rsp`` whose ids are in ``indices`` (reference
    ``_retain``, the kvstore's row_sparse_pull primitive)."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    want = np.unique(_np_of(indices).astype(np.int64))
    have = _host(rsp._aux["indices"]).astype(np.int64)
    pos = np.nonzero(np.isin(have, want))[0]
    dev = rsp._data.device
    return RowSparseNDArray(rsp._data.index_select(0, _ids(pos, dev)),
                            {"indices": _i32(have[pos], dev)}, rsp.shape)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse matrix product.

    * ``dot(csr, dense)`` is dense: the rows of ``rhs`` at the column
      ids, times the values, summed by row id (``index_add_``).
    * ``dot(csr.T, dense)`` is row_sparse over the csr's column ids:
      products summed by column id; the column ids come to the host
      once (``np.unique``).

    Any other pairing falls back to a dense matmul with a warning.  On
    the card ``index_add_`` sums with atomics, so two calls may differ
    in the last bits; on the CPU it sums in index order."""
    if isinstance(lhs, CSRNDArray) and not isinstance(rhs, BaseSparseNDArray):
        if transpose_b:
            raise MXNetError("dot(csr, dense, transpose_b=True) unsupported")
        rd = rhs._data.detach() if isinstance(rhs, NDArray) \
            else _as_tensor(rhs, ctx=lhs.context)
        vec_rhs = rd.dim() == 1
        if vec_rhs:
            rd = rd[:, None]
        vals = lhs._data.detach()
        cols = lhs._aux["indices"].long()
        nnz = vals.shape[0]
        nrows, ncols = lhs.shape
        tail = () if vec_rhs else tuple(rd.shape[1:])
        if nnz == 0:
            if transpose_a:
                return zeros("row_sparse", (ncols,) + tail,
                             ctx=lhs.context, dtype=vals.dtype)
            return NDArray(torch.zeros((nrows,) + tail, dtype=vals.dtype,
                                       device=vals.device))
        rows = _csr_row_of_nnz(lhs._aux["indptr"], nnz)
        if not transpose_a:
            prod = vals[:, None] * rd.index_select(0, cols)
            out = torch.zeros((nrows,) + tuple(prod.shape[1:]),
                              dtype=prod.dtype, device=prod.device)
            out.index_add_(0, rows, prod)
            return NDArray(out[:, 0] if vec_rhs else out)
        prod = vals[:, None] * rd.index_select(0, rows)
        out = torch.zeros((ncols,) + tuple(prod.shape[1:]),
                          dtype=prod.dtype, device=prod.device)
        out.index_add_(0, cols, prod)
        nz_cols = np.unique(_host(cols))
        data = out.index_select(0, _ids(nz_cols, out.device))
        if vec_rhs:
            data = data[:, 0]
        return RowSparseNDArray(data, {"indices": _i32(nz_cols, out.device)},
                                (ncols,) + tail)
    _fallback_warn("dot")
    ld = lhs._dense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rd = rhs._dense() if isinstance(rhs, BaseSparseNDArray) else rhs
    a = ld._data.T if transpose_a else ld._data
    b = rd._data.T if transpose_b else rd._data
    return NDArray(torch.matmul(a, b))


def _merge_rowsparse(arrs):
    """Union of row_sparse arrays: the row ids merged on the host
    (``np.unique``), the values summed by merged row (``index_add_``)."""
    shape = arrs[0].shape
    all_idx = np.concatenate([_host(a._aux["indices"]) for a in arrs])
    if all_idx.size == 0:
        return zeros("row_sparse", shape, ctx=arrs[0].context,
                     dtype=arrs[0]._data.dtype)
    uniq, inverse = np.unique(all_idx, return_inverse=True)
    vals = torch.cat([a._data for a in arrs], dim=0)
    merged = torch.zeros((uniq.size,) + tuple(vals.shape[1:]),
                         dtype=vals.dtype, device=vals.device)
    merged.index_add_(0, _ids(inverse, vals.device), vals)
    return RowSparseNDArray(merged, {"indices": _i32(uniq, vals.device)},
                            shape)


def add_n(*arrs):
    """Sum of arrays; all row_sparse stays row_sparse (the sparse
    gradient aggregation path)."""
    arrs = list(arrs[0]) if len(arrs) == 1 and \
        isinstance(arrs[0], (list, tuple)) else list(arrs)
    if all(isinstance(a, RowSparseNDArray) for a in arrs):
        return _merge_rowsparse(arrs)
    _fallback_warn("add_n")
    out = None
    for a in arrs:
        d = a._to_dense() if isinstance(a, BaseSparseNDArray) else a._data
        out = d if out is None else out + d
    return NDArray(out)


def _dense_data(a):
    return a._to_dense() if isinstance(a, BaseSparseNDArray) else a._data


def elemwise_add(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        return _merge_rowsparse([lhs, rhs])
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return csr_matrix(lhs.asscipy() + rhs.asscipy(), ctx=lhs.context)
    _fallback_warn("elemwise_add")
    return NDArray(_dense_data(lhs) + _dense_data(rhs))


def elemwise_sub(lhs, rhs):
    if isinstance(lhs, RowSparseNDArray) and isinstance(rhs, RowSparseNDArray):
        return _merge_rowsparse([lhs, rhs * -1.0])
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return csr_matrix(lhs.asscipy() - rhs.asscipy(), ctx=lhs.context)
    _fallback_warn("elemwise_sub")
    return NDArray(_dense_data(lhs) - _dense_data(rhs))


def elemwise_mul(lhs, rhs):
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, CSRNDArray):
        return csr_matrix(lhs.asscipy().multiply(rhs.asscipy()).tocsr(),
                          ctx=lhs.context)
    _fallback_warn("elemwise_mul")
    return NDArray(_dense_data(lhs) * _dense_data(rhs))


# ---------------------------------------------------------------------------
# lazy (row-wise) optimizer updates: with a row_sparse gradient and
# lazy_update=True only the gradient's rows are read and written
# ---------------------------------------------------------------------------
def _rows_and_grad(grad, rescale_grad, clip_gradient):
    g = grad._data.detach() * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return grad._aux["indices"].long(), g


def _row_view(x, rows):
    """``(values at rows, write)`` for the global row ids ``rows`` of
    ``x``: a dense NDArray (gathered and written in place), or a
    RowSparseNDArray whose block first grows zero rows for ids it lacks,
    so missing rows read as zeros and updates to them materialize (the
    kvstore's row_sparse weights and states)."""
    if isinstance(x, RowSparseNDArray):
        rows_np = _host(rows)
        idx_np = _host(x._aux["indices"]).astype(np.int64)
        union = np.union1d(idx_np, rows_np)
        old = x._data.detach()
        if union.shape[0] != idx_np.shape[0]:
            block = torch.zeros((union.shape[0],) + tuple(old.shape[1:]),
                                dtype=old.dtype, device=old.device)
            if idx_np.shape[0]:
                block.index_copy_(0, _ids(np.searchsorted(union, idx_np),
                                          old.device), old)
            x._aux = dict(x._aux, indices=_i32(union, old.device))
            x._set_data(block)
        pos = _ids(np.searchsorted(union, rows_np), old.device)
    else:
        pos = rows
    block = x._data

    def write(new_vals):
        with torch.no_grad():
            block.index_copy_(0, pos, new_vals)
        x._version += 1

    return block.detach().index_select(0, pos), write


def _in_place(weight, grad, out):
    if not isinstance(grad, RowSparseNDArray):
        raise MXNetError("a lazy update needs a row_sparse gradient, got %s"
                         % grad.stype)
    if out is not None and out is not weight:
        raise MXNetError("lazy sparse updates write in place (out=weight)")


def sgd_update(weight, grad, out=None, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, **kw):
    """Row-lazy SGD: only the gradient's rows are touched, weight decay
    included."""
    _in_place(weight, grad, out)
    rows, g = _rows_and_grad(grad, rescale_grad, clip_gradient)
    wr, write_w = _row_view(weight, rows)
    write_w(wr - lr * (g + wd * wr))
    return weight


def sgd_mom_update(weight, grad, mom, out=None, lr=0.01, momentum=0.0,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   lazy_update=True, **kw):
    _in_place(weight, grad, out)
    rows, g = _rows_and_grad(grad, rescale_grad, clip_gradient)
    wr, write_w = _row_view(weight, rows)
    mr, write_m = _row_view(mom, rows)
    new_m = momentum * mr - lr * (g + wd * wr)
    write_m(new_m)
    write_w(wr + new_m)
    return weight


def adam_update(weight, grad, mean, var, out=None, lr=0.001, beta1=0.9,
                beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True, **kw):
    """Row-lazy Adam: the moments and the weight of the gradient's rows;
    ``lr`` carries the bias correction of the parameter's update count
    (one count per parameter, not per row)."""
    _in_place(weight, grad, out)
    rows, g = _rows_and_grad(grad, rescale_grad, clip_gradient)
    wr, write_w = _row_view(weight, rows)
    mr, write_m = _row_view(mean, rows)
    vr, write_v = _row_view(var, rows)
    g = g + wd * wr
    new_m = beta1 * mr + (1 - beta1) * g
    new_v = beta2 * vr + (1 - beta2) * torch.square(g)
    write_m(new_m)
    write_v(new_v)
    write_w(wr - lr * new_m / (torch.sqrt(new_v) + epsilon))
    return weight
