"""The port's Tensor surface (`core.tensor`) against paddle_tpu's Tensor.

The port's Tensor is ``torch.Tensor`` itself: `core.tensor` adds at
import only the names torch lacks (`core.tensor.ADDED`), and every name
torch has keeps torch's meaning. Each test drives one part of the
reference's surface (``paddle_tpu/core/tensor.py:30-210``) on the same
numpy values in both packages; the deviations (ROADMAP C.3) are named
and held as torch's behaviour.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import tensor as jtensor
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu.ops  # noqa: F401  (installs the reference's methods)
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import tensor as ptensor
from paddle_tpu_torch.core.place import CPUPlace, Place

X = np.arange(6, dtype=np.float32).reshape(2, 3) / 4


def _pair(requires_grad=False):
    j = JTensor(jnp.asarray(X), stop_gradient=not requires_grad)
    p = torch.tensor(X, requires_grad=requires_grad)
    return j, p


def test_the_port_tensor_is_torch_tensor_with_only_new_names():
    assert pt.Tensor is torch.Tensor
    assert isinstance(pt.Parameter(torch.ones(2)), pt.Tensor)
    for name in ptensor.ADDED:
        assert name in vars(torch.Tensor)
        assert not hasattr(torch._C.TensorBase, name), name
    # torch's own names keep torch's meaning
    for name in ("size", "is_leaf", "shape", "dtype", "numpy", "to",
                 "copy_", "backward", "name"):
        assert name not in ptensor.ADDED
    assert set(ptensor.ADDED) == {
        "stop_gradient", "clear_grad", "clear_gradient", "retain_grads",
        "astype", "cast", "set_value", "place", "persistable"}


def test_stop_gradient_and_the_grad_setter():
    j, p = _pair()
    assert j.stop_gradient is p.stop_gradient is True
    j.stop_gradient = False
    p.stop_gradient = False
    assert p.requires_grad and not j.stop_gradient
    j.grad = np.ones((2, 3), np.float32)
    p.grad = torch.ones(2, 3)
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(j.grad._value))
    # a Parameter's is the same property, inherited
    par, jpar = pt.Parameter(torch.ones(2)), JParameter(jnp.ones(2))
    assert par.stop_gradient is jpar.stop_gradient is False
    par.stop_gradient = jpar.stop_gradient = True
    assert not par.requires_grad and jpar.stop_gradient
    assert "stop_gradient" not in vars(pt.Parameter)
    assert type(par).stop_gradient is torch.Tensor.stop_gradient


@pytest.mark.parametrize("set_to_zero", [False, True])
def test_backward_clear_grad_and_clear_gradient(set_to_zero):
    j, p = _pair(requires_grad=True)
    (j * j).sum().backward()
    (p * p).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(j.grad._value))
    # a second backward accumulates, in both
    (j * 3.0).sum().backward()
    (p * 3.0).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(j.grad._value))
    j.clear_grad(set_to_zero)
    p.clear_grad(set_to_zero)
    if set_to_zero:
        assert not p.grad.any() and not np.asarray(j.grad._value).any()
    else:
        assert p.grad is None and j.grad is None
    p.grad = torch.ones(2, 3)
    p.clear_gradient()
    assert p.grad is None


def test_backward_with_a_grad_tensor_and_retain_graph():
    j, p = _pair(requires_grad=True)
    g = np.full((2, 3), 2.0, np.float32)
    jy, py = j * j, p * p
    jy.backward(JTensor(jnp.asarray(g)), retain_graph=True)
    py.backward(torch.from_numpy(g), retain_graph=True)
    jy.backward(JTensor(jnp.asarray(g)))
    py.backward(torch.from_numpy(g))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(j.grad._value))


def test_deviation_backward_of_a_non_scalar_needs_its_gradient():
    """The reference fills ones for any root; torch's backward wants a
    gradient for a non-scalar (`autograd.backward` fills ones)."""
    j, p = _pair(requires_grad=True)
    (j * 2.0).backward()
    with pytest.raises(RuntimeError, match="scalar"):
        (p * 2.0).backward()
    pt.autograd.backward([p * 2.0])
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(j.grad._value))
    with pytest.raises(TypeError):
        (p * 2.0).sum().backward(grad_tensor=torch.ones(()))


def test_detach_clone_item_tolist_cpu():
    j, p = _pair(requires_grad=True)
    assert j.detach().stop_gradient and p.detach().stop_gradient
    jc, pc = j.clone(), p.clone()
    assert not jc.stop_gradient and not pc.stop_gradient
    np.testing.assert_array_equal(pc.detach().numpy(), np.asarray(jc._value))
    assert p[1, 2].item() == j[1, 2].item()
    assert p.tolist() == j.tolist()
    assert p.cpu().device.type == "cpu"
    np.testing.assert_array_equal(p.detach().cpu().numpy(), j.cpu().numpy())


def test_deviation_numpy_refuses_a_tensor_that_requires_grad():
    j, p = _pair(requires_grad=True)
    np.testing.assert_array_equal(j.numpy(), X)
    with pytest.raises(RuntimeError, match="requires grad"):
        p.numpy()
    np.testing.assert_array_equal(p.detach().numpy(), X)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float64",
                                   "int32"])
def test_astype_cast_and_to_a_dtype(dtype):
    j, p = _pair()
    for jt, pt_ in ((j.astype(dtype), p.astype(dtype)),
                    (j.cast(dtype), p.cast(dtype))):
        assert np.dtype(jt._value.dtype).name == str(pt_.dtype)[6:]
        np.testing.assert_array_equal(
            pt_.float().numpy(), np.asarray(jt._value.astype(jnp.float32)))
    assert p.astype(torch.float16).dtype == torch.float16
    assert j.to(dtype).dtype == np.dtype(j.astype(dtype)._value.dtype)
    assert p.to(getattr(torch, dtype)).dtype == p.astype(dtype).dtype


def test_astype_is_differentiable():
    _, p = _pair(requires_grad=True)
    p.astype("float16").float().sum().backward()
    assert p.grad.dtype == torch.float32


def test_deviation_to_takes_torch_devices_not_places():
    j, p = _pair()
    assert isinstance(j.to(j.place), JTensor)
    with pytest.raises(TypeError):
        p.to(CPUPlace())
    assert p.to(CPUPlace().device).device.type == "cpu"
    with pytest.raises(RuntimeError):
        p.to("float16")          # torch reads a string as a device


def test_set_value_copy_fill_zero():
    j, p = _pair(requires_grad=True)
    new = np.full((2, 3), 7.5, np.float64)
    j.set_value(new)
    p.set_value(new)
    assert p.dtype == torch.float32 and p.requires_grad
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(j._value))
    j.set_value(np.ones((4,), np.float32))
    p.set_value(np.ones((4,), np.float32))
    assert tuple(p.shape) == tuple(j.shape) == (4,)
    with torch.no_grad():
        assert p.fill_(3.0) is p and p.zero_() is p
    assert j.fill_(3.0) is j and j.zero_() is j
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(j._value))
    src = torch.full((4,), 2.0)
    j.copy_(JTensor(jnp.asarray(src.numpy())))
    with torch.no_grad():
        p.copy_(src)
    np.testing.assert_array_equal(p.detach().numpy(), np.asarray(j._value))


def test_deviation_in_place_ops_on_a_leaf_that_requires_grad():
    """The reference's fill_/zero_/copy_ replace any tensor's value;
    torch's refuse a leaf that requires grad outside no_grad."""
    j, p = _pair(requires_grad=True)
    j.fill_(1.0)
    for op in (lambda: p.fill_(1.0), lambda: p.zero_(),
               lambda: p.copy_(torch.ones(2, 3))):
        with pytest.raises(RuntimeError, match="leaf Variable"):
            op()


def test_place_persistable_name_ndim():
    j, p = _pair()
    assert isinstance(p.place, Place) and p.place == CPUPlace()
    assert p.place.is_cpu_place() and j.place.is_cpu_place()
    assert p.persistable is j.persistable is False
    p.persistable = True
    assert p.persistable
    par = pt.Parameter(torch.ones(2), name="w")
    jpar = JParameter(jnp.ones(2), name="w")
    assert par.persistable is jpar.persistable is True
    assert par.name == jpar.name == "w"
    assert p.ndim == j.ndim == 2


def test_deviation_size_is_a_method_and_is_leaf_a_property():
    j, p = _pair(requires_grad=True)
    assert j.size == p.numel() == 6
    assert p.size() == torch.Size([2, 3])
    assert j.is_leaf() is p.is_leaf is True
    y = p * 2
    assert y.is_leaf is False and (j * 2).is_leaf() is False


def test_deviation_shape_dtype_and_name_are_torchs():
    j, p = _pair()
    assert j.shape == [2, 3] and p.shape == torch.Size([2, 3])
    assert list(p.shape) == j.shape
    assert j.dtype == np.dtype("float32") and p.dtype == torch.float32
    assert j.name is None and p.name is None
    with pytest.raises(AttributeError):
        p.name = "x"


def test_retain_grads_keeps_a_non_leafs_grad():
    """Deviation: the reference's retain_grads sets a flag its engine
    never reads, so its intermediate's grad stays None; the port's
    keeps it (torch's retain_grad)."""
    j, p = _pair(requires_grad=True)
    jy, py = j * 2.0, p * 2.0
    jy.retain_grads()
    py.retain_grads()
    (jy * jy).sum().backward()
    (py * py).sum().backward()
    assert jy.grad is None
    np.testing.assert_allclose(py.grad.numpy(), 2 * np.asarray(jy._value))
    assert jtensor.Tensor is JTensor
