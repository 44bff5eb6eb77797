"""Linear-algebra ops — port of ``mxtpu/ops/linalg.py`` (the reference's
``linalg_*`` ops), under the ``linalg`` namespace (``nd.linalg.*``,
``sym.linalg.*``) and the root-level ``linalg_<name>`` aliases.

They are ``torch.linalg`` calls (cuSOLVER and cuBLAS on the card), as the
JAX package's are ``jnp.linalg``/``lax.linalg`` calls with no Pallas
kernel. The JAX package's conventions are kept where torch's differ:
``potrf`` and ``eigh`` read the symmetrized input ``(A + Aᵀ) / 2``;
``gelqf`` returns ``(Q, L)``, the transpose of the QR of ``Aᵀ``; ``syevd``
returns ``(U, L)`` with the eigenvectors as the rows of ``U``.
"""

from __future__ import annotations

import math

import torch

from .registry import alias, register

NS = "linalg"


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _sym(a: torch.Tensor) -> torch.Tensor:
    return (a + _t(a)) / 2


@register("gemm", namespace=NS)
def _gemm(A, B, C, transpose_a: bool = False, transpose_b: bool = False,
          alpha: float = 1.0, beta: float = 1.0, axis: int = -2):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("gemm2", namespace=NS)
def _gemm2(A, B, transpose_a: bool = False, transpose_b: bool = False,
           alpha: float = 1.0):
    a = _t(A) if transpose_a else A
    b = _t(B) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("potrf", namespace=NS)
def _potrf(A):
    """Cholesky factor L with A = L Lᵀ."""
    return torch.linalg.cholesky(_sym(A))


@register("potri", namespace=NS)
def _potri(A):
    """(L Lᵀ)⁻¹ from the Cholesky factor L."""
    ident = torch.eye(A.shape[-1], dtype=A.dtype,
                      device=A.device).expand(A.shape)
    linv = torch.linalg.solve_triangular(A, ident, upper=False)
    return torch.matmul(_t(linv), linv)


@register("trsm", namespace=NS)
def _trsm(A, B, transpose: bool = False, rightside: bool = False,
          lower: bool = True, alpha: float = 1.0):
    """Solve op(A) X = alpha B (or X op(A) = alpha B when ``rightside``)
    for triangular A."""
    a, upper = (_t(A), lower) if transpose else (A, not lower)
    return torch.linalg.solve_triangular(a, alpha * B, upper=upper,
                                         left=not rightside)


@register("trmm", namespace=NS)
def _trmm(A, B, transpose: bool = False, rightside: bool = False,
          lower: bool = True, alpha: float = 1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(B, tri) if rightside
                    else torch.matmul(tri, B))


@register("syrk", namespace=NS)
def _syrk(A, transpose: bool = False, alpha: float = 1.0):
    return alpha * (torch.matmul(_t(A), A) if transpose
                    else torch.matmul(A, _t(A)))


@register("sumlogdiag", namespace=NS)
def _sumlogdiag(A):
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("extractdiag", namespace=NS)
def _extractdiag(A, offset: int = 0):
    return torch.diagonal(A, offset=offset, dim1=-2, dim2=-1)


@register("makediag", namespace=NS)
def _makediag(A, offset: int = 0):
    return torch.diag_embed(A, offset=offset)


def _tri_indices(n: int, offset: int, lower: bool, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("extracttrian", namespace=NS)
def _extracttrian(A, offset: int = 0, lower: bool = True):
    rows, cols = _tri_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register("maketrian", namespace=NS)
def _maketrian(A, offset: int = 0, lower: bool = True):
    m = A.shape[-1]
    n = (math.isqrt(8 * m + 1) - 1) // 2 + abs(offset)
    rows, cols = _tri_indices(n, offset, lower, A.device)
    out = A.new_zeros(A.shape[:-1] + (n, n))
    out[..., rows, cols] = A
    return out


@register("inverse", namespace=NS)
def _inverse(A):
    return torch.linalg.inv(A)


@register("det", namespace=NS)
def _det(A):
    return torch.linalg.det(A)


@register("slogdet", namespace=NS, num_outputs=2)
def _slogdet(A):
    sign, logdet = torch.linalg.slogdet(A)
    return sign, logdet


@register("svd", namespace=NS, num_outputs=3)
def _svd(A):
    """On the card through cuSOLVER's ``gesvd`` (QR iterations): on an
    H100 with the default (Jacobi) method the gradients at (4, 64, 64)
    were 1.05e-3 of their largest entry from LAPACK's, with ``gesvd``
    under 9.1e-5."""
    kw = dict(driver="gesvd") if A.is_cuda else {}
    u, s, vt = torch.linalg.svd(A, full_matrices=False, **kw)
    return u, s, vt


@register("eigh", namespace=NS, num_outputs=2)
def _eigh(A):
    w, v = torch.linalg.eigh(_sym(A))
    return w, v


@register("qr", namespace=NS, num_outputs=2)
def _qr(A):
    q, r = torch.linalg.qr(A)
    return q, r


@register("gelqf", namespace=NS, num_outputs=2)
def _gelqf(A):
    """LQ factorization A = L Q: Q (x, y) with orthonormal rows, L (x, x)
    lower-triangular; outputs (Q, L), the transpose of the QR of Aᵀ."""
    q, r = torch.linalg.qr(_t(A))
    return _t(q), _t(r)


@register("syevd", namespace=NS, num_outputs=2)
def _syevd(A):
    """Symmetric eigendecomposition A = Uᵀ diag(L) U with the eigenvectors
    as the rows of U; outputs (U, L)."""
    w, v = torch.linalg.eigh(_sym(A))
    return _t(v), w


# the reference's root-level names
for _n in ("gelqf", "syevd", "gemm", "gemm2", "potrf", "potri", "trsm", "trmm",
           "syrk", "sumlogdiag", "extractdiag", "makediag", "extracttrian",
           "maketrian", "inverse", "det", "slogdet"):
    alias(f"linalg.{_n}", f"linalg_{_n}")
