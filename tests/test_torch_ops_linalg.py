"""The port's `ops.linalg` (and `paddle_tpu_torch.linalg`) against
paddle_tpu's ``ops/linalg.py``: every public function on the same seeded
numpy inputs, dtypes and values within `_torch_ops.TOL_LINALG` (rtol and
atol 1e-4: LAPACK's and XLA's orders of summation differ), the grads of
the products and norms. Factors fixed only up to the signs of their
columns (``svd``, ``eigh``, ``eig``) are held by their invariants:
singular values and eigenvalues, the reconstruction, and the columns'
absolute values where they are unique."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.linalg as jlinalg
import paddle_tpu_torch as pt
from _torch_ops import (Raw, TOL_LINALG, as_numpy, call, check, held,
                        on_cpu, rand)  # noqa: F401

TOL = TOL_LINALG
A = rand((4, 4), 1)
SPD = (A @ A.T + 4 * np.eye(4)).astype("float32")
B = rand((4, 3), 2)
TALL = rand((6, 3), 3)


def _lower(m):
    return np.tril(m) + 3 * np.eye(len(m), dtype=m.dtype)


#: (name, args, kwargs, grad)
CASES = [
    ("matmul", [rand((3, 4), 4), rand((4, 5), 5)], {}, True),
    ("matmul", [rand((2, 3, 4), 4), rand((4,), 5)], {}, True),
    ("matmul", [rand((4, 3), 4), rand((5, 4), 5)],
     {"transpose_x": True, "transpose_y": True}, True),
    ("matmul", [rand((2, 4, 3), 4), rand((2, 4, 5), 5)],
     {"transpose_x": True}, False),
    ("mm", [rand((3, 4), 6), rand((4, 2), 7)], {}, True),
    ("bmm", [rand((2, 3, 4), 8), rand((2, 4, 5), 9)], {}, True),
    ("mv", [rand((3, 4), 10), rand((4,), 11)], {}, True),
    ("dot", [rand((5,), 12), rand((5,), 13)], {}, True),
    ("dot", [rand((2, 5), 12), rand((2, 5), 13)], {}, False),
    ("cross", [rand((4, 3), 14), rand((4, 3), 15)], {}, True),
    ("cross", [rand((3, 5), 14), rand((3, 5), 15)], {"axis": 0}, False),
    ("norm", [rand((3, 4), 16)], {}, True),
    ("norm", [rand((3, 4), 16)], {"p": 1}, False),
    ("norm", [rand((3, 4), 16)], {"p": 2, "axis": 1}, True),
    ("norm", [rand((3, 4), 16)], {"p": 3, "axis": 0, "keepdim": True},
     False),
    ("norm", [rand((3, 4), 16)], {"p": np.inf, "axis": 1}, False),
    ("norm", [rand((3, 4), 16)], {"p": -np.inf, "axis": 1}, False),
    ("norm", [rand((3, 4), 16)], {"p": 0, "axis": 1}, False),
    ("norm", [rand((3, 4), 16)], {"p": "fro", "axis": 1}, False),
    ("norm", [rand((2, 3, 4), 16)], {"p": "fro", "axis": [1, 2]}, True),
    ("norm", [rand((2, 3, 4), 16)], {"p": "nuc", "axis": [1, 2]}, False),
    ("norm", [rand((2, 3, 4), 16)], {"p": 1, "axis": [1, 2]}, False),
    ("dist", [rand((3, 4), 17), rand((3, 4), 18)], {}, True),
    ("dist", [rand((3, 4), 17), rand((3, 4), 18)], {"p": 1}, False),
    ("dist", [rand((3, 4), 17), rand((3, 4), 18)], {"p": 0}, False),
    ("dist", [rand((3, 4), 17), rand((3, 4), 18)], {"p": np.inf}, False),
    ("dist", [rand((3, 4), 17), rand((3, 4), 18)], {"p": -np.inf}, False),
    ("cdist", [rand((3, 4), 19), rand((5, 4), 20)], {}, True),
    ("cdist", [rand((2, 3, 4), 19), rand((2, 5, 4), 20)], {"p": 1.0},
     False),
    ("cdist", [rand((3, 4), 19), rand((5, 4), 20)], {"p": np.inf}, False),
    ("det", [A], {}, True),
    ("det", [rand((2, 3, 3), 21)], {}, False),
    ("slogdet", [A], {}, True),
    ("inv", [SPD], {}, True),
    ("pinv", [TALL], {}, True),
    ("pinv", [SPD], {"hermitian": True}, False),
    ("qr", [TALL], {}, True),
    ("qr", [TALL], {"mode": "complete"}, False),
    ("qr", [TALL], {"mode": "r"}, False),
    ("eigvalsh", [SPD], {}, True),
    ("eigvalsh", [SPD], {"UPLO": "U"}, False),
    ("cholesky", [SPD], {}, True),
    ("cholesky", [SPD], {"upper": True}, False),
    ("cholesky_solve", [B, np.linalg.cholesky(SPD).astype("float32")], {},
     True),
    ("cholesky_solve", [B, np.linalg.cholesky(SPD).T.astype("float32")],
     {"upper": True}, False),
    ("solve", [SPD, B], {}, True),
    ("triangular_solve", [_lower(A).T.copy(), B], {}, True),
    ("triangular_solve", [_lower(A), B], {"upper": False}, False),
    ("triangular_solve", [_lower(A), B], {"upper": False,
                                          "transpose": True}, False),
    ("triangular_solve", [_lower(A), B], {"upper": False,
                                          "unitriangular": True}, False),
    ("lu", [A], {}, False),
    ("lu", [rand((2, 3, 3), 22)], {"get_infos": True}, False),
    ("matrix_power", [A], {"n": 3}, True),
    ("matrix_power", [SPD], {"n": -2}, False),
    ("matrix_rank", [TALL], {}, False),
    ("matrix_rank", [np.outer(rand((4,), 23), rand((5,), 24))], {}, False),
    ("matrix_rank", [TALL], {"tol": 0.5}, False),
    ("multi_dot", [[rand((3, 4), 25), rand((4, 5), 26), rand((5, 2), 27)]],
     {}, True),
    ("cond", [SPD], {}, False),
    ("cond", [SPD], {"p": "fro"}, False),
    ("cov", [rand((3, 6), 28)], {}, True),
    ("cov", [rand((6, 3), 28)], {"rowvar": False, "ddof": False}, False),
    ("cov", [rand((3, 6), 28)], {"fweights": np.array([1, 2, 1, 3, 1, 1]),
                                 "aweights": rand((6,), 29, low=0.5,
                                                  high=2.0)}, False),
    ("corrcoef", [rand((3, 6), 30)], {}, True),
    ("corrcoef", [rand((6, 3), 30)], {"rowvar": False}, False),
    ("einsum", [Raw("ij,jk->ik"), rand((3, 4), 31), rand((4, 2), 32)], {},
     False),
    ("einsum", [Raw("bij,bkj->bik"), rand((2, 3, 4), 31),
                rand((2, 5, 4), 32)], {}, False),
    ("tensordot", [rand((3, 4, 5), 33), rand((4, 5, 2), 34)], {}, True),
    ("tensordot", [rand((3, 4, 5), 33), rand((5, 3), 34)],
     {"axes": [[2, 0], [0, 1]]}, False),
    ("tensordot", [rand((3, 4), 33), rand((4, 2), 34)], {"axes": 1}, False),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_linalg(case):
    name, args, kw, grad = case
    check(name, args, kw, tol=TOL, grad=grad)


def test_einsum_grads_and_its_list_form():
    a, b = rand((3, 4), 35), rand((4, 2), 36)
    check("einsum", [Raw("ij,jk->ik"), a, b], tol=TOL, grad=True)
    r = paddle_tpu.einsum("ij,jk->ik", [paddle_tpu.to_tensor(a),
                                         paddle_tpu.to_tensor(b)])
    p = pt.einsum("ij,jk->ik", [torch.from_numpy(a), torch.from_numpy(b)])
    held(r, p, TOL)


def test_svd_by_its_invariants():
    """Singular values equal; ``U diag(S) V^H`` rebuilds ``x``; the
    factors' columns agree up to sign."""
    for full in (False, True):
        r, p, _, _ = call(paddle_tpu.svd, pt.svd, [TALL],
                          {"full_matrices": full})
        held(r[1], p[1], TOL)
        u, s, v = (x.numpy() for x in p)
        assert u.shape == as_numpy(r[0]).shape and v.shape == (3, 3)
        np.testing.assert_allclose((u[:, :3] * s) @ v.T, TALL, **TOL)
        np.testing.assert_allclose(np.abs(u[:, :3]),
                                   np.abs(as_numpy(r[0])[:, :3]), **TOL)
        np.testing.assert_allclose(np.abs(v), np.abs(as_numpy(r[2])), **TOL)


def test_eigh_by_its_invariants():
    for uplo in ("L", "U"):
        r, p, _, _ = call(paddle_tpu.eigh, pt.eigh, [SPD], {"UPLO": uplo})
        held(r[0], p[0], TOL)
        w, q = (x.numpy() for x in p)
        np.testing.assert_allclose(q @ np.diag(w) @ q.T, SPD, **TOL)
        np.testing.assert_allclose(np.abs(q), np.abs(as_numpy(r[1])), **TOL)


def test_eig_and_eigvals_are_complex():
    """Complex eigenvalues (sorted to compare: the packages may list them
    in other orders) and eigenvectors with ``A v = w v``; computed on the
    tensor's device (the reference goes through numpy)."""
    m = rand((5, 5), 37)
    r, p, _, _ = call(paddle_tpu.eig, pt.eig, [m])
    w, v = p
    assert w.dtype == torch.complex64 and str(r[0].dtype) == "complex64"
    np.testing.assert_allclose(np.sort_complex(w.numpy()),
                               np.sort_complex(as_numpy(r[0])), **TOL)
    a = torch.from_numpy(m).to(torch.complex64)
    np.testing.assert_allclose((a @ v).numpy(), (v * w).numpy(), **TOL)
    r, p, _, _ = call(paddle_tpu.eigvals, pt.eigvals, [m])
    assert p.dtype == torch.complex64
    np.testing.assert_allclose(np.sort_complex(p.numpy()),
                               np.sort_complex(as_numpy(r)), **TOL)


def test_lstsq():
    """Solution, squared residual norms, int64 rank and singular values;
    rank deficient (the CPU's ``gelsd`` gives the least-norm solution, as
    the reference's SVD does) and with a vector right-hand side too."""
    y = rand((6, 2), 38)
    check("lstsq", [TALL, y], tol=TOL)
    check("lstsq", [TALL, y[:, 0].copy()], tol=TOL)
    low = np.concatenate([TALL[:, :2], TALL[:, :1]], 1)
    _, p = check("lstsq", [low, y], tol=TOL)
    assert int(p[2]) == 2
    check("lstsq", [SPD, rand((4, 2), 39)], tol=TOL)


def test_lu_pivots_are_one_based_int32_and_lu_unpack():
    r, p = check("lu", [A], tol=TOL)
    assert p[1].dtype == torch.int32 and int(p[1].min()) >= 1
    for kw in ({}, {"unpack_ludata": False}, {"unpack_pivots": False}):
        rr = paddle_tpu.lu_unpack(*r, **kw)
        pp = pt.lu_unpack(*p, **kw)
        held(rr, pp, TOL)
    pm, lm, um = (x.numpy() for x in pt.lu_unpack(*p))
    np.testing.assert_allclose(pm @ lm @ um, A, **TOL)
    batch = rand((2, 3, 3), 40)
    r, p = check("lu", [batch], tol=TOL)
    held(paddle_tpu.lu_unpack(*r), pt.lu_unpack(*p), TOL)


def test_householder_product():
    x = rand((5, 3), 41)
    tau = rand((3,), 42, low=0.5, high=1.5)
    check("householder_product", [x, tau], tol=TOL, grad=True)
    check("householder_product", [rand((2, 4, 2), 43),
                                  rand((2, 2), 44, low=0.5, high=1.5)],
          tol=TOL)


def test_the_linalg_module_re_exports_the_ops():
    assert sorted(pt.linalg.__all__) == sorted(jlinalg.__all__)
    for name in jlinalg.__all__:
        assert getattr(pt.linalg, name) is getattr(pt.ops.linalg, name)


def test_every_function_of_the_module_has_a_case():
    from paddle_tpu.ops import _collect, linalg as jl
    covered = {c[0] for c in CASES} | {
        "svd", "eigh", "eig", "eigvals", "lstsq", "lu_unpack",
        "householder_product"}
    names = set(_collect(jl))
    assert not names - covered, sorted(names - covered)
    assert all(hasattr(pt.ops.linalg, n) for n in names)
