"""Elementwise math, reductions, logic and bitwise ops.

Counterpart: ``paddle_tpu/ops/math.py:20-473``. Each op computes in
torch on its tensors' device. The ops of the unary, binary, logic and
bitwise tables and the `_make_reduce` reductions cast their tensor
arguments through `core.dispatch.amp_cast` under their names first, as
``apply_op`` does, so ``auto_cast``'s default and custom lists reach
them; of the other ops, those the reference runs under a name of the
default lists (``logsumexp``, ``cumsum``, ``addmm``) cast under it.
A number beside a tensor keeps the tensor's dtype (the reference's weak
types). Where the reference's x64 mode turns an integer or a Python
number into float64 (``mean`` of an integer tensor, ``divide`` of two),
the port computes in torch's default float32 (ROADMAP C.3).

The module exports names that shadow Python builtins (``sum``, ``max``,
``min``, ``abs``, ``all``, ``any``, ``round``, ``pow``): code below
their definitions reaches the builtins through ``builtins``.
"""
from __future__ import annotations

import builtins
import functools

import numpy as np
import torch

from ..core import dispatch
from ..core.dtype import convert_dtype


def _t(x, like=None):
    """``x`` as a tensor: numbers and arrays on ``like``'s device (in its
    dtype for a number, as a weak-typed scalar is in the reference)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None and isinstance(x, (bool, int, float, builtins.complex)) \
            and not isinstance(like, (bool, int, float)):
        dt = like.dtype
        if isinstance(x, float) and not (dt.is_floating_point or dt.is_complex):
            dt = torch.get_default_dtype()
        if isinstance(x, builtins.complex) and not dt.is_complex:
            dt = torch.complex64
        return torch.as_tensor(x, dtype=dt, device=like.device)
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(np.asarray(x) if not isinstance(
        x, (bool, int, float, builtins.complex)) else x, device=dev)


def _pair(x, y):
    if isinstance(x, torch.Tensor):
        return x, _t(y, x)
    y = _t(y)
    return _t(x, y), y


def _imag(v):
    return v.imag if v.is_complex() else torch.zeros_like(v)


def _real(v):
    return v.real if v.is_complex() else v


def _frac(v):
    return v - torch.trunc(v)


def _logit(v):
    return torch.log(v / (1.0 - v))


def _sign(v):
    return torch.sgn(v) if v.is_complex() else torch.sign(v)


_UNARY = {
    "abs": torch.abs, "acos": torch.acos, "asin": torch.asin,
    "atan": torch.atan, "acosh": torch.acosh, "asinh": torch.asinh,
    "atanh": torch.atanh, "ceil": torch.ceil, "floor": torch.floor,
    "cos": torch.cos, "cosh": torch.cosh, "sin": torch.sin,
    "sinh": torch.sinh, "tan": torch.tan, "tanh": torch.tanh,
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "square": torch.square,
    "sign": _sign, "round": torch.round, "trunc": torch.trunc,
    "reciprocal": torch.reciprocal, "neg": torch.neg,
    "erf": torch.special.erf, "erfinv": torch.erfinv,
    "sigmoid": torch.sigmoid, "lgamma": torch.lgamma,
    "digamma": torch.digamma, "angle": torch.angle,
    "conj": torch.conj_physical, "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg, "frac": _frac, "i0": torch.special.i0,
    "i0e": torch.special.i0e, "i1": torch.special.i1,
    "i1e": torch.special.i1e, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "real": _real, "imag": _imag,
    "logit": _logit,
}


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


def _heaviside(a, b):
    """``jnp.heaviside``: a float result, integers included (the
    reference's float64 under x64 is float32 here, C.3)."""
    a = _floaty(a)
    return torch.heaviside(a, b.to(a.dtype))


def _ldexp(a, b):
    return a * torch.pow(2.0, b)


def _float_if_int(fn):
    """``fn`` on floats: integer or bool inputs computed in float32."""
    def run(a, b):
        if not (a.is_floating_point() or a.is_complex()):
            a = a.to(torch.get_default_dtype())
        return fn(a, b)
    return run


_BINARY = {
    "add": torch.add, "subtract": torch.subtract, "multiply": torch.multiply,
    "divide": torch.true_divide, "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "floor_mod": torch.remainder, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": torch.fmax,
    "fmin": torch.fmin, "atan2": torch.atan2,
    "logaddexp": _float_if_int(torch.logaddexp),
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "hypot": torch.hypot, "heaviside": _heaviside, "inner": torch.inner,
    "outer": _outer, "kron": torch.kron, "gcd": torch.gcd, "lcm": torch.lcm,
    "ldexp": _ldexp,
}

_LOGIC = {
    "equal": torch.eq, "not_equal": torch.ne, "less_than": torch.lt,
    "less_equal": torch.le, "greater_than": torch.gt,
    "greater_equal": torch.ge, "logical_and": torch.logical_and,
    "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
}

_BITWISE = {
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "bitwise_left_shift": torch.bitwise_left_shift,
    "bitwise_right_shift": torch.bitwise_right_shift,
}

def _make_unary(name, fn):
    def op(x, name=None):
        return fn(*dispatch.amp_cast(name_, _t(x)))
    name_ = name
    op.__name__ = op.__qualname__ = name
    return op


def _make_binary(name, fn):
    def op(x, y, name=None):
        return fn(*dispatch.amp_cast(name_, *_pair(x, y)))
    name_ = name
    op.__name__ = op.__qualname__ = name
    return op


for _n, _f in _UNARY.items():
    globals()[_n] = _make_unary(_n, _f)
for _table in (_BINARY, _LOGIC, _BITWISE):
    for _n, _f in _table.items():
        globals()[_n] = _make_binary(_n, _f)


def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


def logical_not(x, name=None):
    return torch.logical_not(x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def increment(x, value=1.0, name=None):
    """``x += value`` in place, outside autograd; returns ``x``."""
    with torch.no_grad():
        x.add_(value)
    return x


def clip(x, min=None, max=None, name=None):
    """``jnp.clip``: with neither bound, ``x`` itself."""
    if min is None and max is None:
        return x
    return torch.clamp(x, min, max)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def multiplex(inputs, index, name=None):
    idx = index.reshape(-1).long()
    stacked = torch.stack(list(inputs))
    return stacked[idx, torch.arange(idx.shape[0], device=idx.device)]


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, a, b = dispatch.amp_cast("addmm", input, x, y)
    return beta * i + alpha * (a @ b)


def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    d = torch.diagonal(x, offset, axis1, axis2)
    if not (d.is_floating_point() or d.is_complex()):
        return d.sum(-1, dtype=torch.int64)
    return d.sum(-1)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(v, ax):
    """``ax`` as a tuple of dims of ``v`` (every dim for None)."""
    if ax is None:
        return tuple(range(v.ndim))
    return ax if isinstance(ax, tuple) else (ax,)


def _reduce(fn, v, ax, keepdim, **kw):
    """``fn`` over the dims ``ax`` (None: all) with the reference's
    ``keepdims``, for a torch reduction that takes a tuple of dims."""
    if ax is None or v.ndim == 0:
        out = fn(v, **kw)
        return out.reshape((1,) * v.ndim) if keepdim else out
    return fn(v, dim=ax, keepdim=keepdim, **kw)


def _one_by_one(fn, v, ax, keepdim):
    """``fn(v, dim, keepdim=True)`` over each dim of ``ax`` in turn, for
    a torch reduction that takes one dim."""
    dims = sorted(d % builtins.max(v.ndim, 1) for d in _dims(v, ax))
    out = v
    if v.ndim == 0:
        return fn(out.reshape(1), 0, keepdim=False)
    for d in dims:
        out = fn(out, d, keepdim=True)
    if not keepdim:
        out = out.squeeze(tuple(dims)) if dims else out
    return out


def _floaty(v):
    if v.is_floating_point() or v.is_complex():
        return v
    return v.to(torch.get_default_dtype())


def _make_reduce(name, fn, int_promote=False, to_float=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        ax = _norm_axis(axis)
        (v,) = dispatch.amp_cast(name_, _t(x))
        kw = {}
        if dtype is not None:
            kw["dtype"] = convert_dtype(dtype)
        elif int_promote and not (v.is_floating_point() or v.is_complex()):
            kw["dtype"] = torch.int64
        if to_float:
            v = _floaty(v)
        return fn(v, ax, keepdim, **kw)
    name_ = name
    op.__name__ = op.__qualname__ = name
    return op


def _prod(v, ax, keepdim, dtype=None):
    if ax is None:
        out = torch.prod(v, dtype=dtype)
        return out.reshape((1,) * v.ndim) if keepdim else out
    return _one_by_one(lambda a, d, keepdim: torch.prod(
        a, d, keepdim=keepdim, dtype=dtype), v, ax, keepdim)


sum = _make_reduce("sum", lambda v, ax, k, **kw: _reduce(torch.sum, v, ax, k,
                                                         **kw),
                   int_promote=True)
nansum = _make_reduce("nansum", lambda v, ax, k, **kw: _reduce(
    torch.nansum, v, ax, k, **kw), int_promote=True)
mean = _make_reduce("mean", lambda v, ax, k, **kw: _reduce(
    torch.mean, v, ax, k, **kw), to_float=True)
nanmean = _make_reduce("nanmean", lambda v, ax, k, **kw: _reduce(
    torch.nanmean, v, ax, k, **kw), to_float=True)
prod = _make_reduce("prod", _prod, int_promote=True)


def max(x, axis=None, keepdim=False, name=None):
    """The largest value over ``axis`` (values only)."""
    return _reduce(torch.amax, x, _norm_axis(axis), keepdim)


def min(x, axis=None, keepdim=False, name=None):
    """The smallest value over ``axis`` (values only)."""
    return _reduce(torch.amin, x, _norm_axis(axis), keepdim)


amax = max
amin = min


def logsumexp(x, axis=None, keepdim=False, name=None):
    (v,) = dispatch.amp_cast("logsumexp", x)
    return torch.logsumexp(v, _dims(v, _norm_axis(axis)), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(torch.std, _floaty(x), _norm_axis(axis), keepdim,
                   correction=1 if unbiased else 0)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _reduce(torch.var, _floaty(x), _norm_axis(axis), keepdim,
                   correction=1 if unbiased else 0)


def _flat_axis(v, axis):
    """``(view, dim)``: the reduction over ``axis`` as one over ``dim``
    of ``view``. None flattens every axis; a list or tuple of axes is
    moved last and flattened into one (``jnp.median(axis=(0, 2))``)."""
    if axis is None:
        return v.reshape(-1), 0
    ax = _norm_axis(axis)
    if not isinstance(ax, tuple):
        return v, ax
    axes = sorted({a % v.ndim for a in ax})
    if len(axes) == 1:
        return v, axes[0]
    rest = [d for d in range(v.ndim) if d not in axes]
    v = v.permute(*rest, *axes).reshape(*(v.shape[d] for d in rest), -1)
    return v, len(rest)


def _keep(out, x, axis, keepdim, lead=0):
    """The reference's ``keepdims`` shape of a reduction of ``x`` over
    ``axis`` (None: all; an int; several) computed without it; ``lead``
    dims of ``out`` come before ``x``'s (a quantile's ``q`` axis)."""
    if not keepdim:
        return out
    if axis is None:
        return out.reshape(out.shape[:lead] + (1,) * x.ndim)
    ax = _norm_axis(axis)
    for a in sorted({a % x.ndim for a in (ax if isinstance(ax, tuple)
                                          else (ax,))}):
        out = out.unsqueeze(lead + a)
    return out


def median(x, axis=None, keepdim=False, name=None):
    """The middle value; of an even count the mean of the two middle ones
    (``jnp.median``; torch's ``median`` returns the lower)."""
    v, ax = _flat_axis(_floaty(x), axis)
    s = torch.sort(v, dim=ax).values
    n = s.shape[ax]
    mid = (s.narrow(ax, (n - 1) // 2, 1) + s.narrow(ax, n // 2, 1)) / 2
    mid = torch.where(torch.isnan(v).any(ax, keepdim=True),
                      torch.full_like(mid, float("nan")), mid).squeeze(ax)
    return _keep(mid, x, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    v, ax = _flat_axis(_floaty(x), axis)
    out = torch.nanquantile(v, 0.5, dim=ax)
    return _keep(out, x, axis, keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation):
    v, ax = _flat_axis(_floaty(x), axis)
    qt = q if isinstance(q, (int, float)) else torch.as_tensor(
        q, dtype=v.dtype, device=v.device)
    out = fn(v, qt, dim=ax, interpolation=interpolation)
    return _keep(out, x, axis, keepdim, lead=out.ndim - (v.ndim - 1))


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


def all(x, axis=None, keepdim=False, name=None):
    return _one_by_one(torch.all, x.bool(), _norm_axis(axis), keepdim) \
        if axis is not None else _reduce(torch.all, x.bool(), None, keepdim)


def any(x, axis=None, keepdim=False, name=None):
    return _one_by_one(torch.any, x.bool(), _norm_axis(axis), keepdim) \
        if axis is not None else _reduce(torch.any, x.bool(), None, keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _reduce(torch.sum, x != 0, _norm_axis(axis), keepdim,
                   dtype=torch.int64)


def cumsum(x, axis=None, dtype=None, name=None):
    (v,) = dispatch.amp_cast("cumsum", x)
    if axis is None:
        v, axis = v.reshape(-1), 0
    return torch.cumsum(v, axis, dtype=_cum_dtype(v, dtype))


def _cum_dtype(v, dtype):
    """``dtype``, else an integer input's own (jnp's; torch's cumulative
    ops make integers int64)."""
    if dtype is not None:
        return convert_dtype(dtype)
    dt = v.dtype
    return None if dt.is_floating_point or dt.is_complex \
        or dt == torch.bool else dt


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.cumprod(x, dim, dtype=_cum_dtype(x, dtype))


def _cum_extreme(fn, x, axis, dtype):
    v, ax = (x.reshape(-1), 0) if axis is None else (x, axis)
    vals, idx = fn(v, ax)
    return vals, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maxima and the index of each (the latest on ties)."""
    return _cum_extreme(torch.cummax, x, axis, dtype)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(torch.cummin, x, axis, dtype)


def logcumsumexp(x, axis=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, axis)


# ---------------------------------------------------------------------------
# comparison / misc logic
# ---------------------------------------------------------------------------

def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = _pair(x, y)
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a, b = _pair(x, y)
    return torch.tensor(torch.allclose(a, b, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan), device=a.device)


def equal_all(x, y, name=None):
    return torch.tensor(x.shape == y.shape and torch.equal(x, y.to(x.dtype)),
                        device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def isreal(x, name=None):
    return torch.isreal(x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return tuple(torch.nonzero(condition, as_tuple=True))
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        a, b = _pair(x, y)
    else:
        a, b = _t(x, condition), _t(y, condition)
    return torch.where(condition, a, b)


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """`paddle.static.nn.while_loop`, eagerly: ``body`` runs while
    ``cond`` holds (one host read of the condition a turn); ``cond`` and
    ``body`` take and return the loop variables. Returns them as a
    list."""
    vals = [v if isinstance(v, torch.Tensor) else _t(v) for v in loop_vars]
    while builtins.bool(cond(*vals)):
        out = body(*vals)
        vals = list(out) if isinstance(out, (tuple, list)) else [out]
    return vals


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def add_n(inputs, name=None):
    """The sum of a list of tensors, left to right."""
    tensors = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if len(tensors) == 1:
        return tensors[0].clone()
    return functools.reduce(torch.add, tensors)


def sgn(x, name=None):
    return torch.sgn(x)


def frexp(x, name=None):
    """Mantissa in [0.5, 1) and exponent, both in ``x``'s dtype."""
    m, e = torch.frexp(x)
    return m, e.to(x.dtype)


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    dt = x.dtype
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def is_complex(x):
    return x.is_complex()


def is_empty(x, name=None):
    """0-d bool: whether ``x`` has no elements."""
    return torch.tensor(x.numel() == 0, device=x.device)
