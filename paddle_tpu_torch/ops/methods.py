"""The op namespace's Tensor methods, on ``torch.Tensor``.

Counterpart: ``paddle_tpu/ops/methods.py:156-213``. The reference binds
every op of `math`, `linalg`, `manip` and `creation` (but the creation
functions that take no tensor) to its Tensor, with the operators, the
in-place forms (``scale_``, ``flatten_``, ``put_along_axis_``, ...),
``uniform_``, ``exponential_`` and a few aliases. The port's Tensor is
``torch.Tensor`` (`core.tensor`), so `install` follows that module's rule:

- a name torch lacks is added, bound to the port's op (`ADDED`);
- a name torch has keeps torch's meaning (`KEPT_TORCH`): every
  operator, ``__getitem__`` / ``__setitem__``, ``matmul``, ``sum``,
  ``max``, ``transpose``, ``split``, ``gather``, ``scatter``,
  ``uniform_``, ``exponential_`` and the rest. Where the meanings part,
  the namespace function (``paddle.split(x, 3)``) has the reference's
  and the method (``x.split(3)``) torch's (ROADMAP C.3);
- the names `core.tensor` added already are left to it.

Both sets are computed against the torch at hand when the module is
imported: a torch that has a name this one lacks keeps it, and the name
is recorded in `KEPT_TORCH` instead of `ADDED`.
"""
from __future__ import annotations

import contextlib

import torch

from ..core import tensor as _core_tensor
from . import creation, linalg, manip, math as math_ops

#: the creation functions the reference does not bind (they take no
#: tensor), and names that are no ops
_SKIP = {"to_tensor", "as_tensor", "zeros", "ones", "full", "empty",
         "arange", "linspace", "logspace", "eye", "rand", "randn",
         "randint", "randperm", "meshgrid", "tril_indices", "triu_indices",
         "uniform", "normal", "standard_normal", "scatter_nd",
         "broadcast_shape", "is_tensor", "cond_trace"}

#: names the reference's Tensor class defines itself (so its install
#: leaves them): `core.tensor` ports them
_NATIVE = {"clone", "tolist", "cast", "shape", "size", "place", "astype",
           "numpy", "item", "cpu", "to", "detach", "backward", "grad",
           "set_value", "copy_", "fill_", "zero_", "clear_grad",
           "clear_gradient", "retain_grads", "ndim", "dtype", "is_leaf",
           "stop_gradient", "name", "persistable"}

#: the operators the reference installs (each keeps torch's meaning)
OPERATORS = ("__add__", "__sub__", "__mul__", "__truediv__",
             "__floordiv__", "__mod__", "__pow__", "__matmul__", "__eq__",
             "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "__and__",
             "__or__", "__xor__", "__radd__", "__rmul__", "__rsub__",
             "__rtruediv__", "__rdiv__", "__rpow__", "__neg__", "__abs__",
             "__invert__", "__getitem__", "__setitem__")


def _make_inplace(fn):
    """``x.op_(...)``: ``fn(x, ...)`` written back into ``x`` (its shape
    may change: then outside autograd)."""
    def op(self, *args, **kwargs):
        out = fn(self, *args, **kwargs)
        if out.shape == self.shape:
            with torch.no_grad() if self.is_leaf and self.requires_grad \
                    else contextlib.nullcontext():
                return self.copy_(out)
        return manip._rebind(self, out)
    op.__name__ = op.__qualname__ = fn.__name__ + "_"
    return op


def _rank(self):
    """ndim as a 0-d int64 tensor (the reference's method)."""
    return torch.tensor(self.ndim, dtype=torch.int64, device=self.device)


def _table():
    """The reference's method table, name -> the port's function, in its
    install order (a later entry replaces an earlier one)."""
    table = {}
    for mod in (math_ops, linalg, manip, creation):
        for name in dir(mod):
            if name.startswith("_") or name in _SKIP or name in _NATIVE:
                continue
            fn = getattr(mod, name)
            if callable(fn) and not isinstance(fn, type) \
                    and getattr(fn, "__module__", "").startswith(
                        "paddle_tpu_torch.ops"):
                table[name] = fn
    for name, fn in {
            "add_": math_ops.add, "subtract_": math_ops.subtract,
            "multiply_": math_ops.multiply, "divide_": math_ops.divide,
            "clip_": math_ops.clip, "scale_": math_ops.scale,
            "exp_": math_ops.exp, "sqrt_": math_ops.sqrt,
            "rsqrt_": math_ops.rsqrt, "reciprocal_": math_ops.reciprocal,
            "floor_": math_ops.floor, "ceil_": math_ops.ceil,
            "round_": math_ops.round, "tanh_": math_ops.tanh,
            "squeeze_": manip.squeeze, "unsqueeze_": manip.unsqueeze,
            "remainder_": math_ops.remainder, "flatten_": manip.flatten,
            "lerp_": math_ops.lerp, "erfinv_": math_ops.erfinv,
            "put_along_axis_": manip.put_along_axis}.items():
        table[name] = _make_inplace(fn)
    table.update({
        "inverse": linalg.inv, "is_tensor": math_ops.is_tensor,
        "scatter_nd": manip.scatter_nd,
        "broadcast_shape": staticmethod(manip.broadcast_shape),
        "uniform_": None, "exponential_": None, "mm": linalg.mm,
        "matmul": linalg.matmul, "dim": None, "rank": _rank,
        "numel": None, "element_size": None, "pow": math_ops.pow,
        "abs": math_ops.abs})
    table.update(dict.fromkeys(OPERATORS))
    return table


#: name -> function: the reference's methods torch lacks, added to
#: ``torch.Tensor`` by `install`
ADDED = {}
#: the reference's method names torch has: they keep torch's meaning
KEPT_TORCH = set()


def install():
    """Add the names torch lacks; record the ones it has. Idempotent."""
    for name, fn in _table().items():
        if name in _core_tensor.ADDED:
            continue
        if name in ADDED or (name not in KEPT_TORCH
                             and not hasattr(torch.Tensor, name)):
            if fn is None:
                continue        # an alias or operator torch never had
            ADDED[name] = fn
            setattr(torch.Tensor, name, fn)
        else:
            KEPT_TORCH.add(name)


__all__ = ["ADDED", "KEPT_TORCH", "OPERATORS", "install"]
