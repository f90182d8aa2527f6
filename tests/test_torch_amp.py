"""`amp.auto_cast` and `amp.decorate` against paddle_tpu's.

Every function of the port's ``nn.functional`` whose reference
counterpart runs under a name of the AMP lists (white: ``linear``, the
six convolutions, ``sdpa`` on its composed branch; black: ``softmax``,
``log_softmax``, ``cross_entropy``, ``nll_loss``, ``bce``,
``bce_logits``, ``layer_norm``, ``batch_norm`` in both modes,
``group_norm``, ``instance_norm``, ``rms_norm``) runs under O1 in
float16 and in bfloat16, on the same numpy inputs (float32, as a layer
would hand them over) as the reference's: the output's dtype is the
reference's (the AMP dtype for a white-list op, float32 for a black-list
one), and its values lie within 2 ulps of that dtype at the output's
largest magnitude (float32 outputs within 1e-5 of it: the float32
functions differ only in summation order). Then the hook's rules: a
gray op (``flash_attention``) computes in its inputs' dtype unless a
custom list names it; a custom black list wins over the white list;
``enable=False`` casts nothing; the state is per thread and comes back
on exit; the cast is differentiable, so a float32 leaf's grad is
float32; `decorate` casts the float parameters at O2 only and sets the
optimizers' ``_multi_precision``, as the reference's does.
"""
import importlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import kernels as jkernels
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as jF
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.core import dispatch as pdispatch
from paddle_tpu_torch.core.dtype import dtype_name
from paddle_tpu_torch.nn import functional as pF

import _torch_layers as tl

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
jauto = importlib.import_module("paddle_tpu.amp.auto_cast")
pauto = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
ULP = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8, "float32": 1e-5 / 2}
ULPS = 2


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _labels(n, k, seed=1):
    return np.random.default_rng(seed).integers(0, k, (n,))


def _mask(b, s, seed=2):
    return np.arange(s)[None, None, None, :] < np.random.default_rng(
        seed).integers(s // 2, s, (b, 1, 1, 1))


def _running(c):
    return [np.zeros(c, np.float32), np.ones(c, np.float32)]


#: op -> (its list, the call on a functional module F with arrays made
#: tensors by mk, the arrays)
CASES = {
    "linear": ("white", lambda F, a: F.linear(*a), [_x(4, 8), _x(8, 6, seed=1),
                                                    _x(6, seed=2)]),
    "conv1d": ("white", lambda F, a: F.conv1d(*a, padding=1),
               [_x(2, 3, 10), _x(4, 3, 3, seed=1), _x(4, seed=2)]),
    "conv2d": ("white", lambda F, a: F.conv2d(*a, stride=2, padding=1),
               [_x(2, 3, 8, 8), _x(4, 3, 3, 3, seed=1), _x(4, seed=2)]),
    "conv3d": ("white", lambda F, a: F.conv3d(*a),
               [_x(1, 2, 4, 5, 5), _x(3, 2, 2, 3, 3, seed=1),
                _x(3, seed=2)]),
    "conv1d_transpose": ("white", lambda F, a: F.conv1d_transpose(
        *a, stride=2), [_x(2, 3, 6), _x(3, 4, 3, seed=1), _x(4, seed=2)]),
    "conv2d_transpose": ("white", lambda F, a: F.conv2d_transpose(
        *a, padding=1), [_x(1, 3, 5, 5), _x(3, 2, 3, 3, seed=1),
                         _x(2, seed=2)]),
    "conv3d_transpose": ("white", lambda F, a: F.conv3d_transpose(*a),
                         [_x(1, 2, 3, 4, 4), _x(2, 2, 2, 2, 2, seed=1),
                          _x(2, seed=2)]),
    "sdpa": ("white", lambda F, a: F.scaled_dot_product_attention(
        *a[:3], attn_mask=a[3], use_flash=False),
        [_x(2, 16, 2, 8), _x(2, 16, 2, 8, seed=1), _x(2, 16, 2, 8, seed=2),
         _mask(2, 16)]),
    "softmax": ("black", lambda F, a: F.softmax(a[0], axis=-1), [_x(4, 9)]),
    "log_softmax": ("black", lambda F, a: F.log_softmax(a[0]), [_x(4, 9)]),
    "cross_entropy": ("black", lambda F, a: F.cross_entropy(*a),
                      [_x(6, 11), _labels(6, 11)]),
    "nll_loss": ("black", lambda F, a: F.nll_loss(*a),
                 [np.log(np.random.default_rng(3).dirichlet(
                     np.ones(5), 6)).astype(np.float32), _labels(6, 5)]),
    "bce": ("black", lambda F, a: F.binary_cross_entropy(*a),
            [np.random.default_rng(4).uniform(0.05, 0.95, (5, 3)).astype(
                np.float32), (_x(5, 3, seed=5) > 0).astype(np.float32)]),
    "bce_logits": ("black", lambda F, a: F.binary_cross_entropy_with_logits(
        *a), [_x(5, 3), (_x(5, 3, seed=6) > 0).astype(np.float32)]),
    "layer_norm": ("black", lambda F, a: F.layer_norm(a[0], 8, *a[1:]),
                   [_x(3, 4, 8), _x(8, seed=1), _x(8, seed=2)]),
    "batch_norm": ("black", lambda F, a: F.batch_norm(
        a[0], a[1], a[2], *a[3:], training=True),
        [_x(4, 3, 5), *_running(3), _x(3, seed=1), _x(3, seed=2)]),
    "batch_norm_eval": ("black", lambda F, a: F.batch_norm(
        a[0], a[1], a[2], *a[3:], training=False),
        [_x(4, 3, 5), _x(3, seed=3), np.abs(_x(3, seed=4)) + 0.5,
         _x(3, seed=1), _x(3, seed=2)]),
    "group_norm": ("black", lambda F, a: F.group_norm(
        a[0], 2, weight=a[1], bias=a[2]),
        [_x(2, 4, 3, 3), _x(4, seed=1), _x(4, seed=2)]),
    "instance_norm": ("black", lambda F, a: F.instance_norm(
        a[0], weight=a[1], bias=a[2]),
        [_x(2, 3, 4, 4), _x(3, seed=1), _x(3, seed=2)]),
    "rms_norm": ("black", lambda F, a: F.rms_norm(*a),
                 [_x(3, 8), _x(8, seed=1)]),
}


def _jt(a):
    return JTensor(jnp.asarray(a))


def _out(x):
    return x[0] if isinstance(x, tuple) else x


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("op", list(CASES))
def test_listed_op_casts_as_the_reference(op, dtype):
    kind, call, arrays = CASES[op]
    with jautograd.no_grad(), jamp.auto_cast(dtype=dtype):
        want = _out(call(jF, [_jt(a) for a in arrays]))
    with torch.no_grad(), pamp.auto_cast(dtype=dtype):
        got = _out(call(pF, [torch.from_numpy(np.array(a))
                             for a in arrays]))
    want_dt = np.dtype(want._value.dtype).name
    assert want_dt == (dtype if kind == "white" else "float32")
    assert dtype_name(got.dtype) == want_dt
    tl.close_to_scale(got.float().numpy(),
                      np.asarray(want._value.astype(jnp.float32)),
                      ULPS * ULP[want_dt], op)


def test_the_lists_are_the_references():
    assert pamp.white_list == jamp.white_list
    assert pamp.black_list == jamp.black_list


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)


@pytest.mark.parametrize("lists,inputs,want", [
    ({}, "float32", "float32"),
    ({}, "float16", "float16"),
    ({"custom_white_list": ["flash_attention"]}, "float32", "float16"),
    ({"custom_black_list": ["flash_attention"]}, "float16", "float32")])
def test_gray_op_follows_custom_lists(interpret_kernel, lists, inputs, want):
    """``flash_attention`` (gray) in its inputs' dtype, or where a custom
    list sends it, in both packages."""
    q, k, v = (_x(1, 128, 2, 64, seed=i).astype(inputs) for i in range(3))
    with jautograd.no_grad(), jamp.auto_cast(dtype="float16", **lists):
        ref = jkernels.flash_attention(*(_jt(t) for t in (q, k, v)))
    with torch.no_grad(), pamp.auto_cast(dtype="float16", **lists):
        got = pF.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert np.dtype(ref._value.dtype).name == dtype_name(got.dtype) == want
    tl.close_to_scale(got.float().numpy(),
                      np.asarray(ref._value.astype(jnp.float32)),
                      ULPS * ULP[want], "flash_attention")


def test_custom_black_list_wins_and_disable_casts_nothing():
    x, w = torch.randn(3, 4), torch.randn(4, 2)
    for amp, mod in ((pamp, pauto), (jamp, jauto)):
        with amp.auto_cast(dtype="float16", custom_black_list=["linear"],
                           custom_white_list=["linear"]):
            assert mod.amp_dtype_for_op("linear") == mod.amp_dtype_for_op(
                "softmax")
    with pamp.auto_cast(dtype="float16", custom_black_list=["linear"]):
        assert pF.linear(x.half(), w.half()).dtype == torch.float32
    with pamp.auto_cast(enable=False, dtype="float16"):
        assert pF.linear(x, w).dtype == torch.float32
        assert pF.softmax(x.half()).dtype == torch.float16
    jx = _jt(x.numpy())
    with jamp.auto_cast(dtype="float16", custom_black_list=["linear"]):
        assert jF.linear(jx, _jt(w.numpy())).dtype == np.float32
    with jamp.auto_cast(enable=False, dtype="float16"):
        assert jF.softmax(_jt(x.numpy().astype(np.float16))).dtype == \
            np.float16


def test_state_is_per_thread_and_comes_back():
    seen = {}
    with pamp.auto_cast(dtype="bfloat16", level="O2"):
        with pamp.auto_cast(dtype="float16", custom_white_list=["relu"]):
            assert pauto.amp_state()["dtype"] == torch.float16
            t = threading.Thread(target=lambda: seen.update(
                pauto.amp_state(), out=pF.linear(torch.ones(1, 2),
                                                torch.ones(2, 2)).dtype))
            t.start()
            t.join()
        st = pauto.amp_state()
        assert (st["dtype"], st["level"], st["custom_white"]) == (
            torch.bfloat16, "O2", set())
        assert pF.linear(torch.ones(1, 2), torch.ones(2, 2)).dtype == \
            torch.bfloat16
    assert not pauto.amp_state()["enabled"]
    assert not seen["enabled"] and seen["out"] == torch.float32
    assert pF.linear(torch.ones(1, 2), torch.ones(2, 2)).dtype == \
        torch.float32
    assert pamp.amp_guard is pamp.auto_cast


def test_one_flag_says_whether_amp_is_on():
    """The state's ``enabled`` is the dispatch's own flag: switched in
    place inside a scope, the cast follows it, as the reference's hook
    follows its state."""
    assert pauto.amp_state is pdispatch.amp_state
    x, w = np.ones((1, 2), np.float32), np.ones((2, 2), np.float32)
    for amp, mod, lin, half in (
            (pamp, pauto, lambda: pF.linear(torch.from_numpy(x),
                                            torch.from_numpy(w)).dtype,
             torch.float16),
            (jamp, jauto, lambda: jF.linear(_jt(x), _jt(w)).dtype,
             np.float16)):
        with amp.auto_cast(dtype="float16"):
            st = mod.amp_state()
            st["enabled"] = False
            off = lin()
            st["enabled"] = True
            assert lin() == half and off != half
        assert lin() != half


def test_cast_is_differentiable_and_grads_keep_the_leaf_dtype():
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)
    with pamp.auto_cast(dtype="float16"):
        y = pF.linear(x, w)
        loss = pF.cross_entropy(y, torch.tensor([0, 1, 2, 0]))
    assert y.dtype == torch.float16 and loss.dtype == torch.float32
    loss.backward()
    assert x.grad.dtype == w.grad.dtype == torch.float32
    assert torch.isfinite(w.grad).all()


def test_amp_off_casts_nothing_and_costs_one_thread_local_read():
    a = torch.ones(2)
    assert pdispatch.amp_cast("linear", a, None) == (a, None)
    assert pdispatch.amp_cast("linear", a)[0] is a


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_decorate_matches_the_reference(level):
    jlin, plin = jnn.Linear(4, 3), pnn.Linear(4, 3, device="cpu")
    jo = jopt.AdamW(parameters=jlin.parameters())
    po = popt.AdamW(parameters=plin.parameters())
    m, o = jamp.decorate(jlin, jo, level=level, dtype="float16")
    pm, p_o = pamp.decorate(plin, po, level=level, dtype="float16")
    assert m is jlin and o is jo and pm is plin and p_o is po
    assert [np.dtype(p._value.dtype).name for p in jlin.parameters()] == [
        dtype_name(p.dtype) for p in plin.parameters()]
    assert jo._multi_precision == po._multi_precision == (level == "O2")
    models = pamp.decorate([plin], level=level, dtype="float16")
    assert models == [plin]
