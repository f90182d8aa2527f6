"""Linear algebra.

Counterpart: ``paddle_tpu/ops/linalg.py:18-292``. `matmul`, `mm`,
`bmm`, `mv` and `einsum` cast their operands through
`core.dispatch.amp_cast` under those names (the AMP white list: float16
or bfloat16 inside `amp.auto_cast`), `norm` and `dist` under theirs
(the black list: float32), as the reference's ``apply_op`` does; the
products then run on cuBLAS through ``torch.matmul``. A model that
follows the reference calls `matmul` wherever the reference writes
``@``, ``.matmul`` or ``ops.matmul``: torch's operators do not cast
(ROADMAP C.3).

The decompositions are torch.linalg's. `lu` returns 1-based int32
pivots (:197-203). `eig` and `eigvals` return complex values and run on
the tensor's device (the reference computes them with numpy on the
host, :151-153). `lstsq` solves with ``gels`` on a CUDA tensor (torch
takes no other driver there: full rank only) and ``gelsd`` on the CPU;
its residuals, rank and singular values are computed alike on both. `cholesky_solve`
takes the right-hand side first and the factor second.
"""
from __future__ import annotations

import math

import torch

from ..core import dispatch


def _t(a):
    """``a`` with its last two dims swapped (a vector as it is)."""
    return a.mT if a.ndim > 1 else a


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = dispatch.amp_cast("matmul", x, y)
    return torch.matmul(_t(a) if transpose_x else a,
                        _t(b) if transpose_y else b)


def mm(input, mat2, name=None):
    return torch.matmul(*dispatch.amp_cast("mm", input, mat2))


def bmm(x, y, name=None):
    return torch.matmul(*dispatch.amp_cast("bmm", x, y))


def mv(x, vec, name=None):
    return torch.matmul(*dispatch.amp_cast("mv", x, vec))


def dot(x, y, name=None):
    return torch.sum(x * y, dim=-1)


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (the default 9: the first dim of
    size 3)."""
    ax = axis
    if ax == 9:
        ax = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=ax)


def _is_inf(p, sign):
    return isinstance(p, (int, float)) and p == sign * math.inf


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """The reference's norms: Frobenius (the default), a vector ``p``-norm
    over ``axis`` (or of the flattened tensor), a matrix norm over a
    pair of axes."""
    (v,) = dispatch.amp_cast("norm", x)
    if p == "fro" and axis is None:
        return torch.sqrt(torch.sum(v * v))
    if axis is None:
        return torch.linalg.vector_norm(v.reshape(-1), ord=p,
                                        keepdim=keepdim)
    if isinstance(axis, (list, tuple)):
        axes = tuple(axis)
        if len(axes) == 1:
            return norm(v, 2 if p == "fro" else p, axes[0], keepdim)
        return torch.linalg.matrix_norm(v, ord=p, dim=axes, keepdim=keepdim)
    if p == "fro":
        return torch.sqrt(torch.sum(v * v, dim=axis, keepdim=keepdim))
    if _is_inf(p, 1):
        return torch.amax(v.abs(), dim=axis, keepdim=keepdim)
    if _is_inf(p, -1):
        return torch.amin(v.abs(), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((v != 0).to(v.dtype), dim=axis, keepdim=keepdim)
    return torch.sum(v.abs() ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    a, b = dispatch.amp_cast("dist", x, y)
    d = (a - b).abs()
    if p == 0:
        return torch.sum((d != 0).to(a.dtype)).to(a.dtype)
    if _is_inf(p, 1):
        return torch.amax(d)
    if _is_inf(p, -1):
        return torch.amin(d)
    return torch.sum(d ** p) ** (1.0 / p)


def cdist(x, y, p=2.0, name=None):
    d = (x[..., :, None, :] - y[..., None, :, :]).abs()
    if _is_inf(p, 1):
        return torch.amax(d, dim=-1)
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def inv(x, name=None):
    return torch.linalg.inv(x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def svd(x, full_matrices=False, name=None):
    """``(U, S, V)`` with ``x = U diag(S) V^H`` (V, not V^H)."""
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh.mH


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def eig(x, name=None):
    return torch.linalg.eig(x)


def eigh(x, UPLO="L", name=None):
    return torch.linalg.eigh(x, UPLO=UPLO)


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` for ``A = y y^H`` (``y`` lower) or ``y^H y``
    (``upper``); only ``y``'s triangle is read, so only it has a grad."""
    return torch.cholesky_solve(x, torch.triu(y) if upper else torch.tril(y),
                                upper=upper)


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x z = y`` (``x^T z = y`` with ``transpose``) for a
    triangular ``x``."""
    a = x.mT if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != transpose, unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular values)`` of ``min |x z -
    y|`` as ``jnp.linalg.lstsq`` gives them: the squared residual norm of
    each column of ``y`` (whatever the rank), the int64 rank, the
    singular values of ``x``."""
    if driver is None:
        driver = "gels" if x.is_cuda else "gelsd"
    vec = y.ndim == 1
    b = y[:, None] if vec else y
    sol = torch.linalg.lstsq(x, b, driver=driver).solution
    m, n = x.shape[-2], x.shape[-1]
    sv = torch.linalg.svdvals(x)
    cut = (torch.finfo(x.dtype).eps * max(m, n)) if rcond is None else rcond
    rank = torch.sum((sv > 0) & (sv >= cut * sv[..., :1]), -1)
    res = torch.sum((b - x @ sol).abs() ** 2, dim=-2)
    return (sol[:, 0] if vec else sol), res, rank, sv


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factors and the 1-based int32 pivots (and a zero
    int32 info with ``get_infos``)."""
    lu_mat, piv = torch.linalg.lu_factor(x)
    outs = (lu_mat, piv.to(torch.int32))
    if get_infos:
        return outs + (torch.zeros((), dtype=torch.int32, device=x.device),)
    return outs


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` of `lu`'s output, ``A = P L U`` (those asked for; one
    alone is returned bare)."""
    p, l, u = torch.lu_unpack(x, y, unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    outs = tuple(o for o, on in ((p, unpack_pivots), (l, unpack_ludata),
                                 (u, unpack_ludata)) if on)
    return outs if len(outs) > 1 else outs[0]


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """The count of singular values above ``tol`` (an absolute bound, as
    the reference's ``jnp.linalg.matrix_rank(rtol=tol)`` reads it), or
    by default above ``max(m, n) * eps`` times the largest."""
    if tol is None:
        return torch.linalg.matrix_rank(x).to(torch.int64)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0).to(torch.int64)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def cond(x, p=None, name=None):
    return torch.linalg.cond(x, p)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    def w(v):
        return None if v is None else torch.as_tensor(v, device=x.device)
    return torch.cov(x if rowvar else _t(x), correction=1 if ddof else 0,
                     fweights=w(fweights), aweights=w(aweights))


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar else _t(x))


def einsum(equation, *operands):
    tensors = operands[0] if len(operands) == 1 and isinstance(
        operands[0], (list, tuple)) else operands
    return torch.einsum(equation, *dispatch.amp_cast("einsum", *tensors))


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if isinstance(axes, torch.Tensor) else axes
    return torch.tensordot(x, y, dims=ax)


def householder_product(x, tau, name=None):
    """The first n columns of ``H_0 ... H_{n-1}``, ``H_i = I - tau_i v_i
    v_i^H`` from the reflectors below the diagonal of ``x``."""
    return torch.linalg.householder_product(x, tau)
