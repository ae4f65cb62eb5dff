"""Linear algebra: the ``linalg_*`` family, ``moments`` and the
interleaved FFT pair.

Port of ``mxnet_tpu/ops/linalg.py``, name for name.  The reference left
the factorizations to XLA (LAPACK on the CPU); the port leaves them to
``torch.linalg`` (LAPACK on the CPU, cuSOLVER/cuBLAS on the card), with
the reference's conventions: ``potrf`` gives the lower Cholesky factor,
``potri`` the inverse of ``L L^T`` from that factor, ``syevd`` the
eigenvectors as rows (``A = U^T diag(L) U``), ``gelqf`` the ``L Q`` of
``A`` from the QR of ``A^T``.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0, axis=-2, **kw):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                 axis=-2, **kw):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


class _Potrf(torch.autograd.Function):
    """The lower Cholesky factor, with the reference's gradient: the
    transpose of ``dL = L phi(L^-1 dA L^-T)`` (``phi``: the lower
    triangle, its diagonal halved) over every entry of ``dA``, not
    torch's symmetrized one (the two agree on symmetric
    perturbations)."""

    @staticmethod
    def forward(ctx, A):
        L = torch.linalg.cholesky(A)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, gL):
        (L,) = ctx.saved_tensors
        m = torch.tril(_t(L) @ gL)
        m = m - 0.5 * torch.diag_embed(torch.diagonal(m, dim1=-2, dim2=-1))
        # L^-T m L^-1
        x = torch.linalg.solve_triangular(_t(L), m, upper=True)
        return _t(torch.linalg.solve_triangular(_t(L), _t(x), upper=True))


@register("_linalg_potrf", aliases=("linalg_potrf",))
def linalg_potrf(A, **kw):
    return _Potrf.apply(A)


@register("_linalg_potri", aliases=("linalg_potri",))
def linalg_potri(A, **kw):
    """``(L L^T)^{-1}`` from the lower Cholesky factor ``L``."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    linv = torch.linalg.solve_triangular(A, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kw):
    """``op(A) X = alpha B`` (``X op(A) = alpha B`` with ``rightside``)
    for triangular ``A``."""
    a = _t(A) if transpose else A
    lo = lower != transpose
    if rightside:
        return _t(torch.linalg.solve_triangular(_t(a), _t(alpha * B),
                                                upper=lo))
    return torch.linalg.solve_triangular(a, alpha * B, upper=not lo)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                alpha=1.0, **kw):
    tri = torch.tril(A) if lower else torch.triu(A)
    tri = _t(tri) if transpose else tri
    if rightside:
        return alpha * torch.matmul(B, tri)
    return alpha * torch.matmul(tri, B)


@register("_linalg_syrk", aliases=("linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0, **kw):
    if transpose:
        return alpha * torch.matmul(_t(A), A)
    return alpha * torch.matmul(A, _t(A))


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def linalg_syevd(A, **kw):
    w, v = torch.linalg.eigh(A)
    return _t(v), w


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def linalg_gelqf(A, **kw):
    q, r = torch.linalg.qr(_t(A))
    return _t(r), _t(q)


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def linalg_sumlogdiag(A, **kw):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_extractdiag", aliases=("linalg_extractdiag",))
def linalg_extractdiag(A, offset=0, **kw):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=("linalg_makediag",))
def linalg_makediag(A, offset=0, **kw):
    return torch.diag_embed(A, offset=offset)


@register("_linalg_extracttrian", aliases=("linalg_extracttrian",))
def linalg_extracttrian(A, offset=0, lower=True, **kw):
    n = A.shape[-1]
    ii, jj = (np.tril_indices if lower else np.triu_indices)(n, k=offset)
    return A[..., torch.as_tensor(ii, device=A.device),
             torch.as_tensor(jj, device=A.device)]


@register("_linalg_inverse", aliases=("linalg_inverse", "inverse"))
def linalg_inverse(A, **kw):
    return torch.linalg.inv(A)


@register("_linalg_det", aliases=("linalg_det", "det"))
def linalg_det(A, **kw):
    return torch.linalg.det(A)


@register("_linalg_slogdet", aliases=("linalg_slogdet", "slogdet"),
          num_outputs=2)
def linalg_slogdet(A, **kw):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("moments", num_outputs=2)
def moments(data, axes=None, keepdims=False, **kw):
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    return (data.mean(dim=ax, keepdim=keepdims),
            data.var(dim=ax, unbiased=False, keepdim=keepdims))


@register("_contrib_fft", aliases=("fft",))
def contrib_fft(data, compute_size=128, **kw):
    """FFT over the last axis, the complex result interleaved as
    (re, im) pairs, float32."""
    out = torch.fft.fft(data.float(), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1)
    return packed.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],))


@register("_contrib_ifft", aliases=("ifft",))
def contrib_ifft(data, compute_size=128, **kw):
    """The inverse of ``_contrib_fft`` on interleaved input: the real
    part, scaled by N."""
    n = data.shape[-1] // 2
    c = data.reshape(tuple(data.shape[:-1]) + (n, 2)).float()
    comp = torch.complex(c[..., 0], c[..., 1])
    return torch.fft.ifft(comp, dim=-1).real * n
