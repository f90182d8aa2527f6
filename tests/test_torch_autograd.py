"""The port's autograd (`core.autograd`, `autograd`) against paddle_tpu's.

`grad`, `backward`, the grad-mode switches, `saved_tensors_hooks` and
`PyLayer` run the same computations on the same numpy values in both
packages; gradients agree within 1e-6 (float32, the same formulas).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.ops  # noqa: F401  (the reference's Tensor methods)
from paddle_tpu import autograd as jag
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch import autograd as pag

TOL = dict(rtol=1e-6, atol=1e-6)


def _leaves(*arrays):
    j = [JTensor(jnp.asarray(a), stop_gradient=False) for a in arrays]
    p = [torch.tensor(a, requires_grad=True) for a in arrays]
    return j, p


def _np(x):
    return np.asarray(x._value) if isinstance(x, JTensor) else \
        x.detach().numpy()


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(_np(g), _np(w), **TOL)


A = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
B = np.linspace(0.5, 2, 6, dtype=np.float32).reshape(2, 3)


def _f(x, y):
    h = x * y + x.exp()
    return h, (h * h).sum()


def test_grad_of_leaves_and_of_an_intermediate():
    (jx, jy), (px, py) = _leaves(A, B)
    jh, jl = _f(jx, jy)
    ph, pl = _f(px, py)
    want = paddle_tpu.grad(jl, [jx, jh, jy])
    got = pt.grad(pl, [px, ph, py])
    _same(got, want)
    assert all(not g.requires_grad for g in got)
    assert px.grad is None and jx.grad is None


def test_grad_outputs_and_retain_graph():
    (jx, jy), (px, py) = _leaves(A, B)
    jh, _ = _f(jx, jy)
    ph, _ = _f(px, py)
    g = np.full((2, 3), 0.5, np.float32)
    want = paddle_tpu.grad(jh, jx, grad_outputs=[JTensor(jnp.asarray(g))],
                           retain_graph=True)
    got = pt.grad(ph, px, grad_outputs=[torch.from_numpy(g)],
                  retain_graph=True)
    _same(got, want)
    _same(pt.grad(ph, py, grad_outputs=[torch.from_numpy(g)]),
          paddle_tpu.grad(jh, jy, grad_outputs=[JTensor(jnp.asarray(g))]))


def test_unused_input_raises_unless_allow_unused():
    (jx, jy), (px, py) = _leaves(A, B)
    for grad, x, y in ((paddle_tpu.grad, jx, jy), (pt.grad, px, py)):
        with pytest.raises(RuntimeError, match="allow_unused=True"):
            grad((x * 2.0).sum(), [x, y])
    _same(pt.grad((px * 2.0).sum(), [px, py], allow_unused=True),
          paddle_tpu.grad((jx * 2.0).sum(), [jx, jy], allow_unused=True))
    # an input that needs no grad counts as unused too
    stop = torch.tensor(A)
    assert pt.grad((px * stop).sum(), [px, stop],
                   allow_unused=True)[1] is None


def test_create_graph_raises_as_the_reference():
    (jx,), (px,) = _leaves(A)
    with pytest.raises(NotImplementedError):
        paddle_tpu.grad((jx * jx).sum(), jx, create_graph=True)
    with pytest.raises(NotImplementedError):
        pt.grad((px * px).sum(), px, create_graph=True)


def test_backward_fills_ones_and_takes_grad_tensors():
    (jx, jy), (px, py) = _leaves(A, B)
    jh, _ = _f(jx, jy)
    ph, _ = _f(px, py)
    jag.backward([jh])
    pag.backward([ph])
    _same([px.grad, py.grad], [jx.grad, jy.grad])
    (jx, jy), (px, py) = _leaves(A, B)
    g = np.arange(6, dtype=np.float32).reshape(2, 3)
    jag.backward([jx * jy, jy * 3.0], [JTensor(jnp.asarray(g)), None])
    pag.backward([px * py, py * 3.0], [torch.from_numpy(g), None])
    _same([px.grad, py.grad], [jx.grad, jy.grad])
    pag.backward(torch.tensor(A))          # needs no grad: nothing to do


def test_deviation_a_leaf_root_keeps_its_own_gradient():
    """Deviation: a root that is itself a leaf adds its gradient (ones)
    in the port (torch's engine); the reference's drops it when another
    root reaches the same leaf (``run_backward``'s ``setdefault``)."""
    (jx, jy), (px, py) = _leaves(A, B)
    jag.backward([jx * jy, jx])
    pag.backward([px * py, px])
    np.testing.assert_allclose(_np(jx.grad), B, **TOL)
    np.testing.assert_allclose(px.grad.numpy(), B + 1.0, **TOL)
    (jx,), (px,) = _leaves(A)
    jag.backward([jx])
    pag.backward([px])
    _same([px.grad], [jx.grad])


def test_grad_mode_switches():
    (jx,), (px,) = _leaves(A)
    for mod, x in ((paddle_tpu, jx), (pt, px)):
        assert mod.is_grad_enabled()
        with mod.no_grad():
            assert not mod.is_grad_enabled()
            y = x * 2.0
            with mod.enable_grad():
                z = x * 2.0
        assert y.stop_gradient and not z.stop_gradient
        mod.set_grad_enabled(False)
        try:
            assert not mod.is_grad_enabled()
            assert (x * 2.0).stop_gradient
        finally:
            mod.set_grad_enabled(True)
        assert mod.is_grad_enabled()
    assert pt.set_grad_enabled(True) is None
    assert pag.no_grad is pt.no_grad


def test_saved_tensors_hooks_pack_and_unpack():
    """Every saved tensor goes through pack at forward time and unpack at
    backward time; a hook that stores float16 changes the grads as the
    reference's does."""
    (jx, jy), (px, py) = _leaves(A, B)
    seen = {"j": [0, 0], "p": [0, 0]}

    def hooks(key, half):
        def pack(t):
            seen[key][0] += 1
            return t.astype("float16") if half else t

        def unpack(t):
            seen[key][1] += 1
            return t.astype("float32") if half else t
        return pack, unpack

    with jag.saved_tensors_hooks(*hooks("j", True)):
        jl = (jx * jy).sum()
    with pag.saved_tensors_hooks(*hooks("p", True)):
        pl = (px * py).sum()
    jl.backward()
    pl.backward()
    assert seen["j"][0] > 0 and seen["p"][0] > 0
    assert seen["p"][1] == seen["p"][0] and seen["j"][1] == seen["j"][0]
    _same([px.grad, py.grad], [jx.grad, jy.grad])
    np.testing.assert_array_equal(
        py.grad.numpy(), A.astype(np.float16).astype(np.float32))


class _Cube:
    """y = x^3 (and 2*z, whose grad backward leaves None)."""

    @staticmethod
    def forward(ctx, x, z, scale=1.0):
        ctx.save_for_backward(x)
        ctx.scale = scale
        return x * x * x * scale, z * 2.0

    @staticmethod
    def backward(ctx, dy, dz):
        (x,) = ctx.saved_tensor()
        return dy * 3.0 * x * x * ctx.scale, None


def _layers():
    class J(jag.PyLayer):
        forward = _Cube.forward
        backward = _Cube.backward

    class P(pag.PyLayer):
        forward = _Cube.forward
        backward = _Cube.backward

    return J, P


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_pylayer_forward_backward_and_a_none_grad(scale):
    J, P = _layers()
    (jx, jz), (px, pz) = _leaves(A, B)
    jy, jw = J.apply(jx, jz, scale=scale)
    py, pw = P.apply(px, pz, scale=scale)
    _same([py, pw], [jy, jw])
    assert not py.stop_gradient and not jy.stop_gradient
    (jy.sum() + jw.sum()).backward()
    (py.sum() + pw.sum()).backward()
    _same([px.grad], [jx.grad])
    assert jz.grad is None and pz.grad is None
    with pt.no_grad():
        assert P.apply(px, pz)[0].stop_gradient


def test_pylayer_saved_tensor_under_hooks():
    J, P = _layers()
    calls = {"j": 0, "p": 0}

    def pack_of(key):
        def pack(t):
            calls[key] += 1
            return t
        return pack

    (jx, jz), (px, pz) = _leaves(A, B)
    with jag.saved_tensors_hooks(pack_of("j"), lambda t: t):
        jy, _ = J.apply(jx, jz)
    with pag.saved_tensors_hooks(pack_of("p"), lambda t: t):
        py, _ = P.apply(px, pz)
    jy.sum().backward()
    py.sum().backward()
    assert calls["j"] >= 1 and calls["p"] >= 1
    _same([px.grad], [jx.grad])
