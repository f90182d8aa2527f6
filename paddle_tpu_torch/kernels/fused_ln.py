"""Fused (residual +) LayerNorm: the Hopper kernels and their plain
versions.

Counterpart: ``paddle_tpu/kernels/fused_ln.py``. Its two TPU kernels,
``_fwd_kernel`` (:45, launched by ``_fwd`` :83) and ``_bwd_kernel`` (:62,
launched by ``_bwd_call`` :113), are replaced by the hand-written CUDA
kernels of ``csrc/fused_ln.cu`` (its header note says how they work and
what bounds them).

- `fused_ln_fwd` / `fused_ln_bwd`: the kernel wrappers (CUDA tensors
  only).
- `fused_ln_reference` / `fused_ln_bwd_reference`: the plain versions.
- `fused_add_layer_norm` (:172-184): ``y = LN(x + residual)`` (residual
  may be None) over the last dim, differentiable through `_FusedAddLN`;
  `supported` (:166-169) is the reference's shape gate.

The contract both share, over rows of ``[N, M]``: ``a = x (+ residual)``
in float32; ``mean = mean(a)``, then ``var = mean((a - mean)^2)`` (two
passes), ``rstd = rsqrt(var + eps)``; ``y = (a - mean) * rstd * g + b``
in x's dtype; ``mean`` and ``rstd`` float32 ``[N]`` saved for the
backward (the TPU kernels' 8-row broadcast is a tiling artifact). The
backward recomputes ``x^`` from them: ``dx = rstd * (dy*g - mean(dy*g) -
x^ * mean(dy*g*x^))`` in x's dtype, the residual's gradient the same
``dx``; ``dg = sum(dy * x^)`` and ``db = sum(dy)`` over the rows, in
float32, cast to g's dtype by the autograd Function (as the reference
casts them, :160).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch, runs_plain

_SOURCE = "fused_ln"
_FWD = "fused_ln_fwd"
_BWD = "fused_ln_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PART_ROWS = 32              # rows of one dg/db partial (csrc kPartRows)
_fns = None


def supported(shape, m) -> bool:
    """``supported`` (:166-169): the rows tile by 128 and the feature dim
    is a multiple of 128."""
    n = 1
    for s in shape[:-1]:
        n *= int(s)
    return m % 128 == 0 and n % 128 == 0


# ----------------------------------------------------------- plain versions
def _a(x, residual):
    return x.float() if residual is None else x.float() + residual.float()


def fused_ln_reference(x, residual, weight, bias, eps):
    """The plain version of `fused_ln_fwd`: ``(y [N, M] in x's dtype, mean
    [N], rstd [N] float32)``."""
    a = _a(x, residual)
    mean = a.mean(dim=1, keepdim=True)
    xc = a - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * weight.float() + bias.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def fused_ln_bwd_reference(x, residual, weight, mean, rstd, dy):
    """The plain version of `fused_ln_bwd`: ``(dx [N, M] in x's dtype,
    dg [M], db [M] float32)``."""
    xhat = (_a(x, residual) - mean[:, None]) * rstd[:, None]
    dyf = dy.float()
    dyg = dyf * weight.float()
    m1 = dyg.mean(dim=1, keepdim=True)
    m2 = (dyg * xhat).mean(dim=1, keepdim=True)
    dx = rstd[:, None] * (dyg - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


# ---------------------------------------------------------- kernel wrappers
def _kernel_fns():
    """``(fwd, bwd, error_string)``: the C entry points with their
    argument types declared (pointers and the stream as ``c_void_p``)."""
    global _fns
    if _fns is None:
        lib = _build.load(_SOURCE)
        fwd = lib.ptt_ln_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                        + [ctypes.c_float] + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.ptt_ln_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns = (fwd, bwd, err_str)
    return _fns


def _check(cond, kernel, msg):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_rows(kernel, x, residual, vectors, rows=()):
    """Device, dtype, shape and layout checks shared by both wrappers:
    ``x``, ``residual`` and the ``rows`` tensors (name, tensor) as
    contiguous 16-byte aligned ``[N, M]`` of x's dtype, the ``vectors``
    (g, b) as contiguous 16-byte aligned float32 ``[M]``. Returns
    ``(n, m)``."""
    _check(x.device.type == "cuda", kernel,
           f"needs CUDA tensors, got {x.device}")
    _check(x.dim() == 2, kernel, f"x must be [N, M], got {tuple(x.shape)}")
    n, m = x.shape
    _check(supported(x.shape, m), kernel,
           f"N and M must be multiples of 128, got {n} x {m}")
    _check(x.dtype in _DTYPE_CODES, kernel,
           f"dtype must be float32 or bfloat16, got {x.dtype}")
    named = [("x", x)] + ([] if residual is None else
                          [("residual", residual)]) + list(rows)
    for name, t in named:
        _check(t.device == x.device and tuple(t.shape) == (n, m)
               and t.dtype == x.dtype and t.is_contiguous()
               and t.data_ptr() % 16 == 0, kernel,
               f"{name} must be contiguous 16-byte aligned {x.dtype} "
               f"{(n, m)} on {x.device}, got {t.dtype} {tuple(t.shape)} on "
               f"{t.device}")
    for t in vectors:
        _check(t.device == x.device and t.dtype == torch.float32
               and tuple(t.shape) == (m,) and t.is_contiguous()
               and t.data_ptr() % 16 == 0, kernel,
               f"weight and bias must be contiguous 16-byte aligned float32 "
               f"({m},) on {x.device}")
    return n, m


def _raise_on(err, kernel, err_str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}"
                           f" ({err_str(err).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_ln_fwd(x, residual, weight, bias, eps):
    """Launch the forward kernel on ``x [N, M]`` (CUDA, contiguous,
    float32 or bfloat16; N and M multiples of 128) and ``residual`` (x's
    shape and dtype, or None); ``weight`` and ``bias`` float32 ``[M]``.
    Returns ``(y [N, M], mean [N], rstd [N])``."""
    n, m = _check_rows(_FWD, x, residual, (weight, bias))
    y = torch.empty_like(x)
    mean, rstd = (torch.empty((n,), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    fwd, _, err_str = _kernel_fns()
    err = fwd(x.data_ptr(), _ptr(residual), weight.data_ptr(),
              bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
              rstd.data_ptr(), n, m, float(eps), _DTYPE_CODES[x.dtype],
              x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, _FWD, err_str)
    count_launch(_FWD)
    return y, mean, rstd


def fused_ln_bwd(x, residual, weight, mean, rstd, dy):
    """Launch the backward kernels: ``(dx [N, M] in x's dtype, dg [M], db
    [M] float32)`` from the forward's inputs, its ``mean`` and ``rstd``
    and the cotangent ``dy`` (x's shape and dtype). One call runs the dx
    pass and the dg/db pass, whose per-32-row partials one torch sum
    reduces; it counts as one launch."""
    n, m = _check_rows(_BWD, x, residual, (weight,), [("dy", dy)])
    for name, t in (("mean", mean), ("rstd", rstd)):
        _check(t.device == x.device and t.dtype == torch.float32
               and tuple(t.shape) == (n,) and t.is_contiguous(), _BWD,
               f"{name} must be contiguous float32 ({n},) on {x.device}")
    dx = torch.empty_like(x)
    dg_part, db_part = (torch.empty((n // _PART_ROWS, m), dtype=torch.float32,
                                    device=x.device) for _ in range(2))
    _, bwd, err_str = _kernel_fns()
    err = bwd(x.data_ptr(), _ptr(residual), weight.data_ptr(),
              mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
              dg_part.data_ptr(), db_part.data_ptr(), n, m,
              _DTYPE_CODES[x.dtype], x.device.index,
              torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, _BWD, err_str)
    count_launch(_BWD)
    return dx, dg_part.sum(dim=0), db_part.sum(dim=0)


# ----------------------------------------------------------------- autograd
class _FusedAddLN(torch.autograd.Function):
    """``custom_vjp`` of ``_fused_add_ln`` / ``_fused_add_ln_nores``
    (:146-204): forward saves ``(x, residual, g, mean, rstd)``; the
    residual, when given, gets the same gradient as x."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, eps):
        w32, b32 = weight.float(), bias.float()
        if runs_plain(x, _FWD):
            y, mean, rstd = fused_ln_reference(x, residual, w32, b32, eps)
        else:
            y, mean, rstd = fused_ln_fwd(x, residual, w32.contiguous(),
                                         b32.contiguous(), eps)
        ctx.save_for_backward(x, residual, w32, mean, rstd)
        ctx.dtypes = (weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, residual, w32, mean, rstd = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if runs_plain(x, _BWD):
            dx, dg, db = fused_ln_bwd_reference(x, residual, w32, mean, rstd,
                                                dy)
        else:
            dx, dg, db = fused_ln_bwd(x, residual, w32.contiguous(), mean,
                                      rstd, dy)
        return (dx, None if residual is None else dx, dg.to(ctx.dtypes[0]),
                db.to(ctx.dtypes[1]), None)


def fused_add_layer_norm(x, residual, weight, bias, eps=1e-5):
    """``y = LN(x + residual)`` (residual may be None) over the last dim,
    differentiable in every input. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernels (or the wrappers raise). Leading
    dims are flattened into rows."""
    shp = x.shape
    m = shp[-1]
    x2 = x.reshape(-1, m)
    r2 = None if residual is None else residual.reshape(-1, m)
    if not runs_plain(x, _FWD):
        x2 = x2.contiguous()
        r2 = None if r2 is None else r2.contiguous()
    return _FusedAddLN.apply(x2, r2, weight, bias, float(eps)).reshape(shp)


__all__ = ["supported", "fused_ln_reference", "fused_ln_bwd_reference",
           "fused_ln_fwd", "fused_ln_bwd", "fused_add_layer_norm"]
