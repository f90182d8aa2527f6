"""The port's `ops.math` against paddle_tpu's ``ops/math.py``: every
public function on the same seeded numpy inputs, in float32 and in the
reference's integer, bool and complex dtypes where the op takes them,
the outputs' dtypes and values held within `_torch_ops.TOL` (float32:
rtol 2e-5, atol 2e-6), the grads of the differentiable ones too. The
traps where torch's function of the same name means something else are
cases of their own: ``max``/``min`` over an axis return values only,
``median`` averages the two middle values, an integer ``sum`` is
int64, ``std``/``var`` take ``unbiased``, ``mod`` and ``floor_divide``
follow Python's signs."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from _torch_ops import Raw, check, on_cpu, rand  # noqa: F401

F32 = "float32"

#: unary ops: name -> (low, high) of the float32 inputs (None: normal)
UNARY = {
    "abs": None, "acos": (-0.9, 0.9), "asin": (-0.9, 0.9), "atan": None,
    "acosh": (1.1, 3.0), "asinh": None, "atanh": (-0.9, 0.9), "ceil": None,
    "floor": None, "cos": None, "cosh": None, "sin": None, "sinh": None,
    "tan": (-1.2, 1.2), "tanh": None, "exp": None, "expm1": None,
    "log": (0.1, 3.0), "log2": (0.1, 3.0), "log10": (0.1, 3.0),
    "log1p": (-0.5, 3.0), "sqrt": (0.1, 3.0), "rsqrt": (0.1, 3.0),
    "square": None, "sign": None, "round": None, "trunc": None,
    "reciprocal": (0.5, 3.0), "neg": None, "erf": None,
    "erfinv": (-0.9, 0.9), "sigmoid": None, "lgamma": (0.2, 4.0),
    "digamma": (0.2, 4.0), "angle": None, "conj": None, "deg2rad": None,
    "rad2deg": None, "frac": None, "i0": None, "i0e": None, "i1": None,
    "i1e": None, "isnan": None, "isinf": None, "isfinite": None,
    "real": None, "imag": None, "logit": (0.05, 0.95), "sgn": None,
    "stanh": None, "bitwise_not": "int32", "logical_not": "bool",
}
#: ops whose float grads are held too (the rest are piecewise constant,
#: predicates or have no grad in one package)
NO_GRAD = {"ceil", "floor", "sign", "round", "trunc", "isnan", "isinf",
           "isfinite", "angle", "imag", "sgn", "bitwise_not",
           "logical_not", "frac", "i0e", "i1", "i1e", "i0", "real"}
#: unary ops that also take integers, with their int outputs
INT_UNARY = ["abs", "neg", "sign", "square", "isnan", "isfinite"]
COMPLEX_UNARY = ["abs", "conj", "real", "imag", "angle", "exp", "sgn",
                 "isfinite"]

BINARY = ["add", "subtract", "multiply", "divide", "floor_divide", "mod",
          "remainder", "floor_mod", "pow", "maximum", "minimum", "fmax",
          "fmin", "atan2", "logaddexp", "copysign", "nextafter", "hypot",
          "heaviside", "inner", "outer", "kron", "ldexp"]
BINARY_GRAD = {"add", "subtract", "multiply", "divide", "maximum",
               "minimum", "atan2", "logaddexp", "hypot", "inner", "outer",
               "kron", "pow"}
INT_BINARY = ["add", "subtract", "multiply", "floor_divide", "mod",
              "remainder", "floor_mod", "maximum", "minimum", "gcd", "lcm"]
LOGIC = ["equal", "not_equal", "less_than", "less_equal", "greater_than",
         "greater_equal", "logical_and", "logical_or", "logical_xor"]
BITWISE = ["bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
           "bitwise_right_shift"]

REDUCE = ["sum", "nansum", "mean", "nanmean", "prod", "max", "min", "amax",
          "amin", "logsumexp", "all", "any", "count_nonzero"]
REDUCE_AXES = [None, 1, (0, 2), -1]


def _unary_input(name):
    spec = UNARY[name]
    if spec == "int32":
        return rand((3, 4), 1, "int32")
    if spec == "bool":
        return rand((3, 4), 1, "bool")
    if spec is None:
        return rand((3, 4), 1)
    return rand((3, 4), 1, low=spec[0], high=spec[1])


@pytest.mark.parametrize("name", list(UNARY))
def test_unary_float32(name):
    x = _unary_input(name)
    grad = name not in NO_GRAD and x.dtype == np.float32
    check(name, [x], grad=grad)


@pytest.mark.parametrize("name", INT_UNARY)
def test_unary_int(name):
    check(name, [rand((3, 4), 2, "int64")])


@pytest.mark.parametrize("name", COMPLEX_UNARY)
def test_unary_complex64(name):
    check(name, [rand((3, 4), 3, "complex64")])


@pytest.mark.parametrize("name", BINARY)
def test_binary_float32(name):
    a, b = rand((3, 4), 4), rand((3, 4), 5)
    if name in ("pow",):
        a = np.abs(a) + 0.5
    if name in ("floor_divide", "mod", "remainder", "floor_mod", "divide"):
        b = np.where(np.abs(b) < 0.2, 0.7, b).astype(F32)
    if name == "heaviside":
        a[0, :2] = 0.0
    if name in ("inner",):
        b = rand((5, 4), 5)
    check(name, [a, b], grad=name in BINARY_GRAD)


@pytest.mark.parametrize("name", INT_BINARY)
def test_binary_int(name):
    """Integer ops stay integer; ``mod`` / ``floor_divide`` follow
    Python's signs (``-7 // 2 == -4``, ``-7 % 2 == 1``)."""
    a = rand((4, 5), 6, "int64")
    b = rand((4, 5), 7, "int64")
    b = np.where(b == 0, 3, b)
    if name in ("gcd", "lcm"):
        a, b = np.abs(a), np.abs(b)
    _, p = check(name, [a, b])
    if name == "floor_divide":
        np.testing.assert_array_equal(p.numpy(), a // b)
    if name in ("mod", "remainder", "floor_mod"):
        np.testing.assert_array_equal(p.numpy(), a % b)


def test_binary_with_a_number_keeps_the_tensor_dtype():
    x = rand((3, 4), 8)
    for name in ("add", "multiply", "subtract", "pow", "maximum"):
        check(name, [x, Raw(2.0)])
    check("add", [rand((3, 4), 8, "int32"), Raw(3)])


@pytest.mark.parametrize("name", LOGIC)
def test_logic(name):
    a, b = rand((3, 4), 9), rand((3, 4), 10)
    b[0] = a[0]
    if name.startswith("logical"):
        a, b = a > 0, b > 0
    check(name, [a, b])


@pytest.mark.parametrize("name", BITWISE)
def test_bitwise(name):
    a = np.abs(rand((3, 4), 11, "int32"))
    b = np.abs(rand((3, 4), 12, "int32")) % 5
    check(name, [a, b])
    if name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        check(name, [a > 3, b > 2])


@pytest.mark.parametrize("name", REDUCE)
def test_reductions(name):
    x = rand((2, 3, 4), 13)
    if name == "prod":
        x = 0.5 + np.abs(x)
    if name in ("all", "any", "count_nonzero"):
        x = (x > 0.3).astype(F32) * x
    grad = name not in ("all", "any", "count_nonzero")
    for ax in REDUCE_AXES:
        if name == "prod" and isinstance(ax, tuple):
            continue
        for keep in (False, True):
            check(name, [x], {"axis": ax, "keepdim": keep}, grad=grad)


@pytest.mark.parametrize("name", ["sum", "nansum", "prod"])
def test_integer_sum_and_prod_are_int64(name):
    """An int32 (or bool) sum is int64 in both (jnp's int promotion);
    ``dtype=`` sets it."""
    x = rand((3, 4), 14, "int32")
    r, p = check(name, [x], {"axis": 1})
    assert p.dtype == torch.int64
    check(name, [x > 0])
    check(name, [x], {"dtype": "float32"})


def test_max_over_an_axis_returns_values_only():
    """``torch.max(x, dim)`` returns (values, indices); the op returns
    the values, as the reference's."""
    x = rand((3, 5), 15)
    _, p = check("max", [x], {"axis": 1})
    assert isinstance(p, torch.Tensor) and p.shape == (3,)
    _, p = check("min", [x], {"axis": 0, "keepdim": True})
    assert isinstance(p, torch.Tensor) and p.shape == (1, 5)


def test_median_averages_the_two_middle_values():
    """jnp's median; torch's ``median`` returns the lower middle value."""
    x = rand((4, 6), 16)
    _, p = check("median", [x], {"axis": 1})
    low = torch.median(torch.from_numpy(x), dim=1).values
    assert not torch.equal(p, low)
    check("median", [x])
    check("median", [x], {"axis": 0, "keepdim": True})
    x[1, 2] = np.nan
    check("median", [x], {"axis": 1})
    check("nanmedian", [x], {"axis": 1})
    check("nanmedian", [x])


@pytest.mark.parametrize("unbiased", [True, False])
def test_std_var_unbiased(unbiased):
    x = rand((3, 5), 17)
    for name in ("std", "var"):
        check(name, [x], {"unbiased": unbiased}, grad=True)
        check(name, [x], {"axis": 1, "unbiased": unbiased, "keepdim": True},
              grad=True)


@pytest.mark.parametrize("name", ["quantile", "nanquantile"])
def test_quantiles(name):
    x = rand((4, 7), 18)
    if name == "nanquantile":
        x[0, 3] = np.nan
    for q in (0.3, [0.1, 0.5, 0.9]):
        for interp in ("linear", "lower", "higher", "nearest", "midpoint"):
            kw = {"q": q, "axis": 1, "interpolation": interp}
            if name == "nanquantile" and interp == "nearest":
                # the reference's jnp.nanquantile rounds the position
                # before dropping the NaN (0.43234 where numpy and the
                # port give 0.35926 at q=0.3): held against numpy
                got = pt.ops.nanquantile(torch.from_numpy(x), **kw)
                np.testing.assert_allclose(
                    got.numpy(), np.nanquantile(x, q, axis=1,
                                                method="nearest"))
                continue
            check(name, [x], kw)
    check(name, [x], {"q": 0.25})
    check(name, [x], {"q": [0.25, 0.75], "axis": 0, "keepdim": True})


@pytest.mark.parametrize("name", ["cumsum", "cumprod", "logcumsumexp"])
def test_cumulative(name):
    x = rand((3, 4), 19)
    if name == "cumprod":
        check(name, [x], {"dim": 1}, grad=True)
        check(name, [x])
        return
    check(name, [x], {"axis": 1}, grad=True)
    check(name, [x])
    if name == "cumsum":
        check(name, [rand((3, 4), 19, "int32")], {"axis": 0})


@pytest.mark.parametrize("name", ["cummax", "cummin"])
def test_cummax_cummin(name):
    """Values and the index of each running extreme (ties: the latest)."""
    x = rand((3, 6), 20, "int64").astype("float32")
    check(name, [x], {"axis": 1})
    check(name, [x])
    check(name, [rand((3, 6), 21, "int64")], {"axis": 0})


def test_scale_increment_clip():
    x = rand((3, 4), 22)
    check("scale", [x], {"scale": 2.0, "bias": 0.5}, grad=True)
    check("scale", [x], {"scale": 2.0, "bias": 0.5,
                         "bias_after_scale": False})
    check("clip", [x], {"min": -0.5, "max": 0.5}, grad=True)
    check("clip", [x], {"min": -0.5})
    jx, px = paddle_tpu.to_tensor(x), torch.from_numpy(x.copy())
    paddle_tpu.ops.increment(jx, 2.5)
    out = pt.ops.increment(px, 2.5)
    assert out is px
    np.testing.assert_allclose(px.numpy(), np.asarray(jx._value))


def test_multiplex_addmm_lerp_nan_to_num_trace():
    ins = [rand((4, 3), 23), rand((4, 3), 24), rand((4, 3), 25)]
    idx = np.array([[2], [0], [1], [2]], np.int32)
    # the reference's multiplex calls its own `all` (ops.math.all shadows
    # the builtin there) on a generator and raises: held against its
    # formula, row i of input idx[i]
    got = pt.ops.multiplex([torch.from_numpy(a) for a in ins],
                           torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.stack(ins)[idx[:, 0],
                                                             np.arange(4)])
    with pytest.raises(AttributeError):
        paddle_tpu.ops.multiplex([paddle_tpu.to_tensor(a) for a in ins],
                                 paddle_tpu.to_tensor(idx))
    a, b, c = rand((3, 5), 26), rand((3, 4), 27), rand((4, 5), 28)
    check("addmm", [a, b, c], {"beta": 0.5, "alpha": 2.0}, grad=True)
    x, y, w = rand((3, 4), 29), rand((3, 4), 30), rand((3, 4), 31,
                                                       low=0, high=1)
    check("lerp", [x, y, Raw(0.3)], grad=True)
    check("lerp", [x, y, w], grad=True)
    z = rand((3, 4), 32)
    z[0, 0], z[1, 1], z[2, 2] = np.nan, np.inf, -np.inf
    check("nan_to_num", [z])
    check("nan_to_num", [z], {"nan": 1.0, "posinf": 9.0, "neginf": -9.0})
    m = rand((4, 5), 33)
    check("trace", [m], grad=True)
    check("trace", [m], {"offset": 1})
    check("trace", [rand((3, 4, 4), 34)], {"axis1": 1, "axis2": 2})
    check("trace", [rand((4, 4), 35, "int32")])


def test_isclose_allclose_equal_all():
    a = rand((3, 4), 36)
    b = a + rand((3, 4), 37) * 1e-6
    b[0, 0] = a[0, 0] + 1.0
    check("isclose", [a, b])
    check("isclose", [a, b], {"rtol": 1e-3, "atol": 1e-3})
    check("allclose", [a, b])
    check("allclose", [a, a.copy()])
    n = a.copy()
    n[1, 1] = np.nan
    check("isclose", [n, n.copy()], {"equal_nan": True})
    check("equal_all", [a, a.copy()])
    check("equal_all", [a, b])


def test_where_and_its_nonzero_form():
    c = rand((3, 4), 38) > 0
    x, y = rand((3, 4), 39), rand((3, 4), 40)
    check("where", [c, x, y], grad=True)
    check("where", [c])
    check("where", [c, x, Raw(0.0)])


def test_predicates_is_tensor_isreal_is_empty():
    x = rand((2, 3), 41)
    for fn in ("is_floating_point", "is_integer", "is_complex",
               "is_tensor"):
        for a in (x, rand((2, 3), 41, "int32"), rand((2, 3), 41,
                                                     "complex64")):
            r, p = check(fn, [a])
            assert p is r
    check("isreal", [rand((2, 3), 42, "complex64")])
    check("isreal", [x])
    check("is_empty", [x])
    check("is_empty", [np.zeros((0, 3), np.float32)])


def test_while_loop_trapezoid_add_n_frexp():
    def cond(i, s):
        return i < 5

    def body(i, s):
        return [i + 1, s * 2.0]

    r = paddle_tpu.ops.while_loop(
        cond, body, [paddle_tpu.to_tensor(0), paddle_tpu.to_tensor(1.5)])
    p = pt.ops.while_loop(cond, body, [torch.tensor(0), torch.tensor(1.5)])
    assert [int(r[0].item()), float(r[1].item())] == \
        [int(p[0].item()), float(p[1].item())] == [5, 48.0]
    y, x = rand((3, 6), 43), np.sort(rand((6,), 44))
    check("trapezoid", [y], grad=True)
    check("trapezoid", [y], {"dx": 0.5, "axis": 0})
    check("trapezoid", [y, x], grad=True)
    check("add_n", [[rand((3, 4), 45), rand((3, 4), 46), rand((3, 4), 47)]],
          grad=True)
    check("add_n", [[rand((3, 4), 48)]])
    check("frexp", [rand((3, 4), 49) * 100])


def test_every_function_of_the_module_has_a_case():
    """Every public function of ``paddle_tpu/ops/math.py`` is named by a
    case of this file."""
    from paddle_tpu.ops import _collect, math as jmath
    covered = (set(UNARY) | set(BINARY) | set(INT_BINARY) | set(LOGIC)
               | set(BITWISE) | set(REDUCE)
               | {"std", "var", "median", "nanmedian", "quantile",
                  "nanquantile", "cumsum", "cumprod", "logcumsumexp",
                  "cummax", "cummin", "scale", "increment", "clip",
                  "multiplex", "addmm", "lerp", "nan_to_num", "trace",
                  "isclose", "allclose", "equal_all", "where",
                  "is_floating_point", "is_integer", "is_complex",
                  "is_tensor", "isreal", "is_empty", "while_loop",
                  "trapezoid", "add_n", "frexp"})
    names = set(_collect(jmath))
    assert not names - covered, sorted(names - covered)
    assert all(hasattr(pt.ops.math, n) for n in names)


@pytest.mark.parametrize("axis", [[0, 2], (1, 2)])
@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("name", ["median", "nanmedian", "quantile",
                                  "nanquantile"])
def test_reductions_over_several_axes(name, axis, keepdim):
    """``axis`` a list or tuple: the reference reduces over every named
    axis at once (``jnp.median(axis=(0, 2))``), the port moves them last
    and flattens them (C.10)."""
    x = rand((3, 4, 5), 40)
    if name.startswith("nan"):
        x[1, 2, 3] = np.nan
    kw = {"axis": axis, "keepdim": keepdim}
    if "quantile" in name:
        for q in (0.3, [0.25, 0.75]):
            check(name, [x], {"q": q, **kw})
    else:
        check(name, [x], kw)


def test_clip_without_bounds_returns_x():
    """``jnp.clip(v, None, None)`` is ``v`` (C.10): float and int."""
    for x in (rand((3, 4), 41), rand((3, 4), 41, "int32")):
        check("clip", [x])
        check("clip", [x], {"min": None, "max": None})


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_heaviside_of_integers_is_float32(dtype):
    """``jnp.heaviside`` of integers is a float: int32 [2, -3, 4, 0, 5]
    with [3, -1, 2, -2, 0] gives float32 [1, 0, 1, -2, 1] (C.10). Of
    int64 the reference's x64 mode gives float64, the port float32
    (C.3), so that case holds values and the port's dtype."""
    a = np.array([2, -3, 4, 0, 5], dtype)
    b = np.array([3, -1, 2, -2, 0], dtype)
    _, p = check("heaviside", [a, b], dtypes=dtype == "int32")
    assert p.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), [1, 0, 1, -2, 1])
