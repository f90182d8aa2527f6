"""Shared helpers of the op-namespace parity tests (tests/
test_torch_ops_{creation,math,manip,linalg}.py, test_torch_fft_signal.py,
test_torch_ops_amp.py): one call of a reference op and of the port's on
the same numpy inputs, its outputs (a tensor, or a tuple or list of
them) compared leaf by leaf, dtype and values, and the grads of ``sum(y
* r)`` for one random ``r`` through each package's own autograd. Imports
jax: CPU tests only."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.ops  # noqa: F401  (installs the reference's methods)
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.core.dtype import dtype_name

import _torch_layers as tl

#: float32 values: relative and absolute tolerance (torch and XLA round
#: transcendental functions and sums in another order)
TOL = dict(rtol=2e-5, atol=2e-6)
#: the decompositions and products (LAPACK's and XLA's orders differ)
TOL_LINALG = dict(rtol=1e-4, atol=1e-4)


class Raw:
    """An argument passed to both packages as it is (not a tensor)."""

    def __init__(self, value):
        self.value = value


@pytest.fixture
def on_cpu():
    """The port's expected device set to the CPU for the test, the
    previous setting put back after (``set_device`` is process state),
    and both packages' default random state too (``seed()`` is)."""
    saved = pdevice.expected_device()
    seed = prandom.default_generator().initial_seed
    pt.set_device("cpu")
    try:
        with tl.rng_state_kept():
            yield
    finally:
        pdevice.set_expected_device(saved)
        prandom._DEFAULT._seed = seed


@contextlib.contextmanager
def cpu_device():
    saved = pdevice.expected_device()
    pt.set_device("cpu")
    try:
        yield
    finally:
        pdevice.set_expected_device(saved)


def rand(shape, seed=0, dtype="float32", low=None, high=None):
    """Seeded numpy values: normal, or uniform in [low, high)."""
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, high, shape).astype(dtype)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(-9 if np.dtype(dtype).kind == "i" else 0, 10,
                            shape).astype(dtype)
    if np.dtype(dtype).kind == "b":
        return rng.random(shape) < 0.5
    if np.dtype(dtype).kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _ref_arg(a, grad):
    if isinstance(a, Raw):
        return a.value
    if isinstance(a, np.ndarray):
        return JTensor(jnp.asarray(a), stop_gradient=not grad)
    if isinstance(a, (list, tuple)):
        return type(a)(_ref_arg(x, grad) for x in a)
    return a


def _port_arg(a, grad):
    if isinstance(a, Raw):
        return a.value
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(a.copy())
        return t.requires_grad_(grad and t.is_floating_point())
    if isinstance(a, (list, tuple)):
        return type(a)(_port_arg(x, grad) for x in a)
    return a


def leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in leaves(o)]
    return [out]


def as_numpy(t):
    if isinstance(t, JTensor):
        return np.asarray(t._value)
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.resolve_conj().numpy()
    return np.asarray(t)


def dtype_of(t):
    if isinstance(t, JTensor):
        return str(np.dtype(t._value.dtype))
    if isinstance(t, torch.Tensor):
        return dtype_name(t.dtype)
    return type(t).__name__


def same_structure(r, p):
    if isinstance(r, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(p) == len(r), (r, p)
        for a, b in zip(r, p):
            same_structure(a, b)


def held(r, p, tol=TOL, dtypes=True):
    """Each leaf of the port's output ``p`` against the reference's
    ``r``: same structure, shape, dtype (unless ``dtypes`` is False)
    and values within ``tol``."""
    same_structure(r, p)
    for a, b in zip(leaves(r), leaves(p)):
        if dtypes:
            assert dtype_of(a) == dtype_of(b), (dtype_of(a), dtype_of(b))
        na, nb = as_numpy(a), as_numpy(b)
        assert na.shape == nb.shape, (na.shape, nb.shape)
        if na.dtype.kind in "fc":
            np.testing.assert_allclose(nb, na, equal_nan=True, **tol)
        else:
            np.testing.assert_array_equal(nb, na)


def call(fn_ref, fn_port, args, kw=None, grad=False):
    """``(ref_out, port_out, ref_ins, port_ins)`` of one call on the same
    inputs (tensors that require grad where ``grad``)."""
    kw = kw or {}
    ri = [_ref_arg(a, grad) for a in args]
    pi = [_port_arg(a, grad) for a in args]
    return fn_ref(*ri, **kw), fn_port(*pi, **kw), ri, pi


def grads_held(r, p, ri, pi, tol=TOL, seed=7):
    """The grads of ``sum(y * c)`` (``c`` seeded, over the first float
    output) w.r.t. every float tensor input, in both packages."""
    ro, po = leaves(r)[0], leaves(p)[0]
    c = rand(tuple(po.shape), seed)
    (ro * JTensor(jnp.asarray(c))).sum().backward()
    (po * torch.from_numpy(c)).sum().backward()
    got = [t for t in leaves(pi) if isinstance(t, torch.Tensor)
           and t.requires_grad]
    want = [t for t in leaves(ri) if isinstance(t, JTensor)
            and not t.stop_gradient and np.dtype(t._value.dtype).kind == "f"]
    assert len(got) == len(want) and got
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad._value),
                                   **tol)


def check(name, args, kw=None, tol=TOL, grad=False, ref_mod=None,
          port_mod=None, dtypes=True):
    """The op ``name`` of ``ref_mod`` (default ``paddle_tpu.ops``) and of
    ``port_mod`` (``paddle_tpu_torch.ops``) held on the same inputs, and
    with ``grad`` their input grads."""
    ref_mod = ref_mod or paddle_tpu.ops
    port_mod = port_mod or pt.ops
    r, p, ri, pi = call(getattr(ref_mod, name), getattr(port_mod, name),
                        args, kw, grad)
    held(r, p, tol, dtypes)
    if grad:
        grads_held(r, p, ri, pi, tol)
    return r, p
