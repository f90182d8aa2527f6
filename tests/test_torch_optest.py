"""The port's OpTest harness (`testing.optest`) against paddle_tpu's.

The same functions (the two packages' own ``nn.functional``) on the same
numpy inputs: `numeric_grad` gives the reference's central differences
(float64, the same seeded projection; within 1e-9, and 1e-3 through
``layer_norm``, which the reference computes in float32 on float64
inputs and the port in float64, ROADMAP C.3), `OpTest.check_grad`
and `OpTest.check_output` pass where the reference's pass, and both
fail on a wrong backward (a custom op whose gradient is off by a
factor) and on a wrong golden output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import autograd as jag
from paddle_tpu.nn import functional as jF
from paddle_tpu.testing import optest as jopt
from paddle_tpu_torch import autograd as pag
from paddle_tpu_torch.nn import functional as pF
from paddle_tpu_torch.testing import OpTest, numeric_grad


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


#: name -> (the function of a functional module, inputs, numeric_grad's
#: tolerance against the reference's)
CASES = {
    "softmax": (lambda F: lambda x: F.softmax(x, axis=-1), [_x(3, 5)],
                1e-9),
    "tanh": (lambda F: lambda x: F.tanh(x), [_x(4, 3)], 1e-9),
    "linear": (lambda F: lambda x, w, b: F.linear(x, w, b),
               [_x(3, 4), _x(4, 2, seed=1), _x(2, seed=2)], 1e-9),
    "layer_norm": (lambda F: lambda x, w, b: F.layer_norm(x, 5, w, b),
                   [_x(2, 5), _x(5, seed=1), _x(5, seed=2)], 1e-3),
}


@pytest.mark.parametrize("name", list(CASES))
def test_numeric_grad_is_the_references(name):
    make, inputs, atol = CASES[name]
    for i in range(len(inputs)):
        want = jopt.numeric_grad(make(jF), inputs, i)
        got = numeric_grad(make(pF), inputs, i)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(CASES))
def test_check_grad_passes_as_the_references(name):
    make, inputs, _ = CASES[name]
    jopt.OpTest.check_grad(make(jF), inputs)
    OpTest.check_grad(make(pF), inputs)


def test_check_output_against_arrays_and_a_numpy_reference():
    x = _x(3, 4)
    for mod, F in ((jopt.OpTest, jF), (OpTest, pF)):
        mod.check_output(lambda t: F.tanh(t), [x], np.tanh)
        mod.check_output(lambda t: F.softmax(t), [x],
                         [np.exp(x) / np.exp(x).sum(-1, keepdims=True)])
        with pytest.raises(AssertionError):
            mod.check_output(lambda t: F.tanh(t), [x], np.sin)


def test_check_output_of_bfloat16_inputs():
    x = _x(4, 4).astype(jnp.bfloat16)
    want = np.tanh(x.astype(np.float32))
    for mod, F in ((jopt.OpTest, jF), (OpTest, pF)):
        mod.check_output(lambda t: F.tanh(t), [x], want, rtol=2e-2,
                         atol=2e-2)


def _wrong(ag):
    class Twice(ag.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * x * 3.0          # the true gradient is 2x

    return Twice.apply


def test_check_grad_catches_a_wrong_backward():
    x = _x(3, 3) + 2.0
    for mod, ag in ((jopt.OpTest, jag), (OpTest, pag)):
        with pytest.raises(AssertionError, match="max relative grad error"):
            mod.check_grad(_wrong(ag), [x])


def test_inputs_may_be_tensors_and_grad_wrt_picks_them():
    x, w = _x(2, 3), _x(3, 3, seed=4)
    OpTest.check_grad(lambda a, b: pF.softmax(a @ b),
                      [torch.from_numpy(x), w], grad_wrt=[1])
    with pytest.raises(AssertionError, match="no floating outputs"):
        numeric_grad(lambda a: (a > 0).long(), [x], 0)
