"""The op namespace under `amp.auto_cast` O1 against the reference's.

Every op of the namespace that the reference runs under a name of the
AMP lists (white: ``matmul``, ``mm``, ``bmm``, ``mv``, ``einsum``,
``addmm``; black: ``exp``, ``square``, ``log``, ``mean``, ``sum``,
``logsumexp``, ``norm``, ``dist``, ``cumsum``, ``renorm``) runs under
O1 in float16 and in bfloat16 on the same numpy inputs as the
reference's: a white-list op on float32 inputs, which it casts down; a
black-list op on inputs in the AMP dtype, which it casts up. The
output's dtype is the reference's (the AMP dtype for a white-list op,
float32 for a black-list one), and its values lie within 2 ulps of that
dtype at the output's largest magnitude (float32 outputs within 1e-5 of
it), `test_torch_amp.py`'s rule. A gray op computes in its inputs'
dtype; with AMP off nothing is cast. Table ops and reductions put on a
list by ``custom_white_list`` / ``custom_black_list`` cast as the
reference's do."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.ops as jops
from paddle_tpu import amp as jamp
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch.core.dtype import dtype_name

import _torch_layers as tl
from _torch_ops import rand

ULP = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8, "float32": 1e-5 / 2}
ULPS = 2

WHITE = {
    "matmul": lambda m, a: m.matmul(a[0], a[1], transpose_y=True),
    "mm": lambda m, a: m.mm(a[0], a[1].T if isinstance(a[1], torch.Tensor)
                            else m.t(a[1])),
    "bmm": lambda m, a: m.bmm(a[2], a[3]),
    "mv": lambda m, a: m.mv(a[0], a[4]),
    "einsum": lambda m, a: m.einsum("ij,kj->ik", a[0], a[1]),
    "addmm": lambda m, a: m.addmm(a[5], a[0], a[6], beta=0.5, alpha=2.0),
}
WHITE_INPUTS = [rand((4, 8), 1), rand((5, 8), 2), rand((2, 3, 4), 3),
                rand((2, 4, 5), 4), rand((8,), 5), rand((4, 6), 6),
                rand((8, 6), 7)]

BLACK = {
    "exp": lambda m, a: m.exp(a[0]),
    "square": lambda m, a: m.square(a[0]),
    "log": lambda m, a: m.log(m.abs(a[0]) + 0.5),
    "mean": lambda m, a: m.mean(a[0], axis=1),
    "sum": lambda m, a: m.sum(a[0]),
    "logsumexp": lambda m, a: m.logsumexp(a[0], axis=-1),
    "norm": lambda m, a: m.norm(a[0], p=2, axis=1),
    "dist": lambda m, a: m.dist(a[0], a[1]),
    "cumsum": lambda m, a: m.cumsum(a[0], axis=1),
    "renorm": lambda m, a: m.renorm(a[0], 2.0, 0, 1.0),
}
BLACK_INPUTS = [rand((4, 8), 8), rand((4, 8), 9)]


def _jt(a):
    return JTensor(jnp.asarray(a))


def _run(calls, op, inputs, dtype):
    with jautograd.no_grad(), jamp.auto_cast(dtype=dtype):
        want = calls[op](paddle_tpu, [_jt(a) for a in inputs])
    with torch.no_grad(), pamp.auto_cast(dtype=dtype):
        got = calls[op](pt, [torch.from_numpy(np.array(a)) for a in inputs])
    return want, got


def _held(want, got, expect, op):
    want_dt = np.dtype(want._value.dtype).name
    assert want_dt == expect, (op, want_dt)
    assert dtype_name(got.dtype) == want_dt, (op, got.dtype)
    tl.close_to_scale(got.float().numpy(),
                      np.asarray(want._value.astype(jnp.float32)),
                      ULPS * ULP[want_dt], op)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", list(WHITE))
def test_white_list_op_casts_down(op, dtype):
    want, got = _run(WHITE, op, WHITE_INPUTS, dtype)
    _held(want, got, dtype, op)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", list(BLACK))
def test_black_list_op_casts_up(op, dtype):
    low = [jnp.asarray(a).astype(dtype) for a in BLACK_INPUTS]
    with jautograd.no_grad(), jamp.auto_cast(dtype=dtype):
        want = BLACK[op](paddle_tpu, [JTensor(a) for a in low])
    with torch.no_grad(), pamp.auto_cast(dtype=dtype):
        got = BLACK[op](pt, [torch.from_numpy(a).to(getattr(torch, dtype))
                             for a in BLACK_INPUTS])
    _held(want, got, "float32", op)


def test_the_namespace_ops_of_the_lists_are_covered():
    """Every op of the namespace named on an AMP list has a case here."""
    listed = (jamp.white_list | jamp.black_list) & set(jops.__all__)
    assert listed == set(WHITE) | set(BLACK)


def test_gray_ops_keep_their_inputs_dtype_and_amp_off_casts_nothing():
    a = torch.from_numpy(rand((3, 4), 10))
    with pamp.auto_cast(dtype="float16"):
        assert pt.add(a.half(), a.half()).dtype == torch.float16
        assert pt.maximum(a, a).dtype == torch.float32
        assert pt.tanh(a).dtype == torch.float32
    with pamp.auto_cast(enable=False, dtype="float16"):
        assert pt.matmul(a, a.T).dtype == torch.float32
        assert pt.sum(a.half()).dtype == torch.float16
    assert pt.matmul(a, a.T).dtype == torch.float32


#: table ops and reductions put on the lists by ``custom_white_list`` /
#: ``custom_black_list``, with the dtype of their inputs in each case
CUSTOM = {
    "tanh": lambda m, a: m.tanh(a[0]),
    "add": lambda m, a: m.add(a[0], a[1]),
    "maximum": lambda m, a: m.maximum(a[0], a[1]),
    "prod": lambda m, a: m.prod(a[0], axis=1),
}


@pytest.mark.parametrize("listed", ["white", "black"])
@pytest.mark.parametrize("op", list(CUSTOM))
def test_custom_lists_reach_the_table_ops(op, listed):
    """``auto_cast(custom_white_list=...)`` casts a table op's float32
    inputs to float16, ``custom_black_list`` a float16 op's up to
    float32, as the reference's ``apply_op`` does for any op name."""
    src = "float32" if listed == "white" else "float16"
    kw = {f"custom_{listed}_list": {op}, "dtype": "float16"}
    with jautograd.no_grad(), jamp.auto_cast(**kw):
        want = CUSTOM[op](paddle_tpu, [_jt(np.asarray(a, src))
                                       for a in BLACK_INPUTS])
    with torch.no_grad(), pamp.auto_cast(**kw):
        got = CUSTOM[op](pt, [torch.from_numpy(np.asarray(a, src))
                              for a in BLACK_INPUTS])
    _held(want, got, "float16" if listed == "white" else "float32", op)


def test_the_cast_is_differentiable():
    """A float32 leaf's grad through a white-list op is float32, as in the
    reference."""
    x = torch.from_numpy(rand((4, 8), 11)).requires_grad_(True)
    w = torch.from_numpy(rand((8, 3), 12)).requires_grad_(True)
    with pamp.auto_cast(dtype="float16"):
        y = pt.matmul(x, w)
        assert y.dtype == torch.float16
        loss = pt.sum(y)
        assert loss.dtype == torch.float32
    loss.backward()
    assert x.grad.dtype == w.grad.dtype == torch.float32
    np.testing.assert_allclose(w.grad.numpy(), np.repeat(
        x.detach().numpy().sum(0)[:, None], 3, 1), rtol=2e-3, atol=2e-3)
