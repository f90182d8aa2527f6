"""`paddle.linalg`: the namespace of the linear-algebra ops.

Counterpart: ``paddle_tpu/linalg.py``, which re-exports the same names
of its ``ops.linalg``.
"""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, householder_product, inv, lstsq, lu, lu_unpack, matmul,
    matrix_power, matrix_rank, multi_dot, norm, pinv, qr, slogdet, solve,
    svd, triangular_solve,
)

__all__ = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det", "eig",
    "eigh", "eigvals", "eigvalsh", "householder_product", "inv", "lstsq",
    "lu", "lu_unpack", "matmul", "matrix_power", "matrix_rank", "multi_dot",
    "norm", "pinv", "qr", "slogdet", "solve", "svd", "triangular_solve",
]
