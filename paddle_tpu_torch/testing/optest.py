"""OpTest: golden outputs and numeric-gradient checks on torch tensors.

Counterpart: ``paddle_tpu/testing/optest.py:21-136``, with its contract:
`OpTest.check_output` holds ``fn(*inputs)`` against arrays or a numpy
reference; `OpTest.check_grad` holds the gradients autograd gives
against central differences (`numeric_grad`) of the same scalar loss, a
fixed random projection of every floating output (seeded, float64), at
the reference's tolerances. Inputs are tensors or arrays (an array
becomes a tensor, float64 kept: the numeric side probes in float64); a
bfloat16 array or tensor is probed in float32, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _make_inputs(inputs, stop_gradient=False):
    tensors = []
    for x in inputs:
        t = _as_tensor(x)
        if not isinstance(x, torch.Tensor):
            t.requires_grad_(not stop_gradient and t.is_floating_point())
        tensors.append(t)
    return tensors


def _scalar_loss(out, seed=7):
    """The sum of each floating output times a fixed random array (seed
    ``seed + i``), in float64: a projection catches sign and permutation
    errors a plain sum would miss."""
    outs = out if isinstance(out, (tuple, list)) else [out]
    total = None
    for i, o in enumerate(outs):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            continue
        rng = np.random.default_rng(seed + i)
        w = torch.from_numpy(rng.standard_normal(tuple(o.shape))).to(
            o.device)
        term = (o.to(torch.float64) * w).sum()
        total = term if total is None else total + term
    assert total is not None, "op has no floating outputs to differentiate"
    return total


def numeric_grad(fn, inputs, wrt, delta=1e-3, seed=7):
    """Central differences of the projected loss with respect to
    ``inputs[wrt]`` (a float64 array)."""
    inputs = [t.detach() for t in _make_inputs(inputs)]
    base = _as_np(inputs[wrt]).astype(np.float64)
    probe_dtype = (torch.float32 if inputs[wrt].dtype == torch.bfloat16
                   else inputs[wrt].dtype)
    flat = base.reshape(-1).copy()
    grad = np.zeros_like(flat)

    def eval_at(vals):
        probe = list(inputs)
        probe[wrt] = torch.from_numpy(vals.reshape(base.shape)).to(
            inputs[wrt].device, probe_dtype)
        with torch.no_grad():
            return float(_scalar_loss(fn(*probe), seed))

    for i in range(flat.size):
        orig = flat[i]
        flat[i] = orig + delta
        hi = eval_at(flat)
        flat[i] = orig - delta
        lo = eval_at(flat)
        flat[i] = orig
        grad[i] = (hi - lo) / (2 * delta)
    return grad.reshape(base.shape)


class OpTest:
    """Subclass-free harness: call the check_* methods directly."""

    @staticmethod
    def check_output(fn, inputs, expected, rtol=1e-5, atol=1e-6):
        """``fn(*tensors)`` against ``expected``: arrays, or a numpy
        reference called on the inputs as arrays."""
        tensors = _make_inputs(inputs, stop_gradient=True)
        with torch.no_grad():
            out = fn(*tensors)
        outs = out if isinstance(out, (tuple, list)) else [out]
        if callable(expected):
            expected = expected(*[_as_np(t) for t in tensors])
        exps = expected if isinstance(expected, (tuple, list)) else [expected]
        assert len(outs) >= len(exps), (f"{len(outs)} outputs < "
                                        f"{len(exps)} refs")
        for o, e in zip(outs, exps):
            np.testing.assert_allclose(
                _as_np(o).astype(np.float64),
                np.asarray(e).astype(np.float64), rtol=rtol, atol=atol)

    @staticmethod
    def check_grad(fn, inputs, grad_wrt=None, delta=1e-3,
                   max_relative_error=5e-3, atol=1e-5, seed=7):
        """Autograd's gradients against `numeric_grad` for each input
        index in ``grad_wrt`` (default: every floating input): the largest
        error over the larger of the two largest magnitudes (at least
        1e-3) below ``max_relative_error``, or within ``atol``."""
        tensors = _make_inputs(inputs, stop_gradient=False)
        if grad_wrt is None:
            grad_wrt = [i for i, t in enumerate(tensors)
                        if t.is_floating_point()]
        leaves = []
        for t in tensors:
            if t.is_floating_point():
                t = t.detach().requires_grad_(True)
            leaves.append(t)
        _scalar_loss(fn(*leaves), seed).backward()
        for i in grad_wrt:
            analytic = leaves[i].grad
            assert analytic is not None, f"no grad reached input {i}"
            a = _as_np(analytic).astype(np.float64)
            n = numeric_grad(fn, inputs, i, delta=delta, seed=seed)
            scale = max(np.abs(n).max(), np.abs(a).max(), 1e-3)
            err = np.abs(a - n).max() / scale
            assert err < max_relative_error or np.allclose(
                a, n, atol=atol), (
                f"input {i}: max relative grad error {err:.2e} >= "
                f"{max_relative_error:.2e}\nanalytic:\n{a}\nnumeric:\n{n}")


__all__ = ["OpTest", "numeric_grad"]
