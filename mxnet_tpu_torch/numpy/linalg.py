"""``mx.np.linalg``: NumPy-style linear algebra.

Port of ``mxnet_tpu/numpy/linalg.py``: each function is a
``_np_linalg_*`` registry op over ``torch.linalg`` (LAPACK on the CPU,
cuSOLVER and cuBLAS on the card).
"""
from __future__ import annotations


def _apply(op, *inputs, **attrs):
    from . import _apply as apply_
    return apply_(op, *inputs, **attrs)


def norm(a, ord=None, axis=None, keepdims=False):
    return _apply("_np_linalg_norm", a, ord=ord, axis=axis,
                  keepdims=keepdims)


def inv(a):
    return _apply("_np_linalg_inv", a)


def det(a):
    return _apply("_np_linalg_det", a)


def slogdet(a):
    return _apply("_np_linalg_slogdet", a)


def cholesky(a):
    return _apply("_np_linalg_cholesky", a)


def qr(a):
    return _apply("_np_linalg_qr", a)


def svd(a):
    return _apply("_np_linalg_svd", a)


def eigh(a):
    return _apply("_np_linalg_eigh", a)


def eigvalsh(a):
    return _apply("_np_linalg_eigvalsh", a)


def solve(a, b):
    return _apply("_np_linalg_solve", a, b)


def lstsq(a, b):
    return _apply("_np_linalg_lstsq", a, b)


def pinv(a):
    return _apply("_np_linalg_pinv", a)


def matrix_rank(a):
    return _apply("_np_linalg_matrix_rank", a)


def matrix_power(a, n):
    return _apply("_np_linalg_matrix_power", a, n=n)
