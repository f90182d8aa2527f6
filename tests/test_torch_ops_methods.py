"""The op namespace's Tensor methods (`ops.methods`) against the
reference's (``paddle_tpu/ops/methods.py:156-213``).

The port's Tensor is ``torch.Tensor``: `ops.methods.install` adds only
the names torch lacks (`ADDED`) and leaves torch's own (`KEPT_TORCH`).
Both sets are pinned here for this torch (2.13 on the CPU); together
with `core.tensor.ADDED` they are every name the reference's install
binds. Each added method is held against the reference's method on the
same values. Each kept name whose torch meaning differs from the
reference's is named by a test below (ROADMAP C.3): the namespace
function has the reference's meaning, the method torch's."""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.ops  # noqa: F401
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import tensor as ctensor
from paddle_tpu_torch.ops import methods
from _torch_ops import held, on_cpu, rand  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PINNED_ADDED = {
    "add_n", "as_complex", "as_real", "assign", "atleast_1d", "atleast_2d",
    "atleast_3d", "broadcast_shape", "broadcast_tensors", "bucketize",
    "cdist", "check_shape", "complex", "concat", "cond", "create_parameter",
    "crop", "eigh", "eigvals", "eigvalsh", "einsum", "empty_like",
    "equal_all", "flatten_", "floor_mod", "full_like", "gather_nd",
    "greater_than", "householder_product", "i0e", "i1", "i1e", "increment",
    "index_sample", "inv", "is_empty", "is_integer", "is_tensor",
    "less_than", "lu_unpack", "matrix_rank", "mod", "multi_dot",
    "multiplex", "ones_like", "pad", "pinv", "poisson", "polar",
    "put_along_axis", "put_along_axis_", "randint_like", "rank", "reshape_",
    "reverse", "scale", "scale_", "scatter_nd", "scatter_nd_add",
    "searchsorted", "shard_index", "slice", "stack", "stanh",
    "strided_slice", "take_along_axis", "tensordot", "trapezoid", "unstack",
    "vander", "while_loop", "zeros_like"}

#: the kept names whose torch meaning differs from the reference's, each
#: shown by `test_kept_name_keeps_torchs_meaning`
DIFFERING = ("split", "gather", "scatter", "transpose", "max", "min",
             "median", "sort", "where", "cumsum", "unique", "matmul")


def _reference_native():
    """The names the reference's Tensor class defines itself (its
    install leaves them)."""
    with open(os.path.join(ROOT, "paddle_tpu/core/tensor.py")) as f:
        tree = ast.parse(f.read())
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Tensor")
    names = set()
    for b in cls.body:
        if isinstance(b, ast.FunctionDef):
            names.add(b.name)
        elif isinstance(b, ast.Assign):
            for tg in b.targets:
                if isinstance(tg, ast.Name):
                    names.add(tg.id)
                    if tg.id == "__slots__":
                        names |= set(ast.literal_eval(b.value))
    return names


def test_added_and_kept_are_pinned_for_this_torch():
    assert set(methods.ADDED) == PINNED_ADDED
    assert not set(methods.ADDED) & methods.KEPT_TORCH
    for name in methods.ADDED:
        assert name in vars(torch.Tensor)
        assert not hasattr(torch._C.TensorBase, name), name
    assert len(methods.KEPT_TORCH) == 250
    assert set(methods.OPERATORS) <= methods.KEPT_TORCH
    assert set(DIFFERING) <= methods.KEPT_TORCH


def test_every_reference_method_is_added_or_kept():
    """Every name the reference's install binds is added here, kept as
    torch's, or one of `core.tensor`'s (the reference's install also
    binds the helpers its op modules import: not API)."""
    native = _reference_native()
    ref = {n for n in dir(JTensor) if n not in native
           and n not in dir(object) and not (n.startswith("_")
                                             and not n.startswith("__"))}
    ref -= {"__module__", "apply_op", "convert_dtype", "next_key"}
    ref |= {"__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"}
    port = set(methods.ADDED) | methods.KEPT_TORCH | set(ctensor.ADDED)
    assert ref <= port, sorted(ref - port)
    assert not (set(methods.ADDED) | methods.KEPT_TORCH) - ref


def test_install_keeps_a_name_a_newer_torch_has(monkeypatch):
    """A torch that already has a name this one lacks keeps it: the
    install records it as kept and does not raise."""
    monkeypatch.setattr(torch.Tensor, "stanh", lambda self: "torch's",
                        raising=False)
    added, kept = dict(methods.ADDED), set(methods.KEPT_TORCH)
    monkeypatch.setattr(methods, "ADDED", {k: v for k, v in added.items()
                                           if k != "stanh"})
    monkeypatch.setattr(methods, "KEPT_TORCH", set(kept))
    methods.install()
    assert "stanh" in methods.KEPT_TORCH and "stanh" not in methods.ADDED
    assert torch.ones(1).stanh() == "torch's"


X = rand((3, 4), 1)
V = rand((4,), 2)
IDX = np.array([[0, 3], [2, 1], [1, 1]])

#: added name -> (self, args, kwargs): the method held against the
#: reference's on the same values; numpy arrays become tensors
CALLS = {
    "add_n": (X, (), {}), "as_complex": (rand((3, 2), 3), (), {}),
    "as_real": (rand((3,), 4, "complex64"), (), {}),
    "assign": (X, (), {}), "atleast_1d": (V, (), {}),
    "atleast_2d": (V, (), {}), "atleast_3d": (X, (), {}),
    "broadcast_shape": (X, ([2, 1], [1, 3]), {}),
    "bucketize": (X, (np.sort(V),), {}), "cdist": (X, (X[:2],), {}),
    "check_shape": (np.array([2, 3]), (), {}),
    "complex": (X, (X,), {}), "concat": (X, (), {}),
    "cond": (X[:3, :3] + 3 * np.eye(3, dtype="float32"), (), {}),
    "crop": (X, ([2, 2],), {"offsets": [1, 1]}),
    "eigh": (np.eye(3, dtype="float32") * 2, (), {}),
    "eigvals": (np.diag(V[:3]).astype("float32"), (), {}),
    "eigvalsh": (np.eye(3, dtype="float32") * 2, (), {}),
    "einsum": (X, (), {}), "empty_like": (X, (), {}),
    "equal_all": (X, (X,), {}), "floor_mod": (X, (0.7,), {}),
    "full_like": (X, (2.0,), {}), "gather_nd": (X, (np.array([[1, 2]]),), {}),
    "greater_than": (X, (V,), {}),
    "householder_product": (X.T.copy(), (V[:3] * 0 + 1,), {}),
    "i0e": (X, (), {}), "i1": (X, (), {}), "i1e": (X, (), {}),
    "index_sample": (X, (IDX,), {}),
    "inv": (X[:3, :3] + 3 * np.eye(3, dtype="float32"), (), {}),
    "is_empty": (X, (), {}), "is_integer": (X, (), {}),
    "is_tensor": (X, (), {}), "less_than": (X, (V,), {}),
    "matrix_rank": (X, (), {}), "mod": (X, (0.7,), {}),
    "multi_dot": (X, (), {}), "ones_like": (X, (), {}),
    "pad": (X, ([1, 0, 0, 2],), {}),
    "pinv": (X, (), {}), "polar": (np.abs(X), (X,), {}),
    "put_along_axis": (X, (IDX, 9.0, 1), {}),
    "put_along_axis_": (X, (IDX, 9.0, 1), {}),
    "rank": (X, (), {}), "reshape_": (X, ([4, 3],), {}),
    "reverse": (X, (1,), {}), "scale": (X, (2.0, 1.0), {}),
    "scale_": (X, (2.0, 1.0), {}), "flatten_": (rand((2, 3, 2), 5), (), {}),
    "scatter_nd": (np.array([[1], [0]]), (rand((2, 4), 6), [3, 4]), {}),
    "scatter_nd_add": (X, (np.array([[1], [1]]), rand((2, 4), 6)), {}),
    "searchsorted": (np.sort(V), (X,), {}),
    "shard_index": (np.array([[1], [7]]), (), {"index_num": 8, "nshards": 2,
                                               "shard_id": 1}),
    "slice": (X, ([1], [1], [3]), {}), "stack": (X, (), {}),
    "stanh": (X, (), {}),
    "strided_slice": (X, ([1], [0], [4], [2]), {}),
    "take_along_axis": (X, (IDX, 1), {}),
    "tensordot": (X, (X.T.copy(),), {"axes": 1}),
    "trapezoid": (X, (), {}), "unstack": (X, (), {}),
    "vander": (V, (), {}), "zeros_like": (X, (), {}),
    "lu_unpack": None, "broadcast_tensors": None, "create_parameter": None,
    "increment": None, "multiplex": None, "poisson": None,
    "randint_like": None, "while_loop": None,
}
#: methods held by their own tests below, or (a list-taking or random
#: op bound as a method) by being the namespace's function, which the
#: op files hold against the reference
BOUND_ONLY = {"lu_unpack", "broadcast_tensors", "create_parameter",
              "increment", "multiplex", "poisson", "randint_like",
              "while_loop", "concat", "stack", "add_n", "einsum",
              "multi_dot"}


def _ref(a):
    return JTensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a


def _port(a):
    return torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(PINNED_ADDED))
def test_added_method_against_the_reference(name, on_cpu):
    assert set(CALLS) == PINNED_ADDED
    fn = methods.ADDED[name]
    if name in BOUND_ONLY:
        op = getattr(pt.ops, name)
        assert fn is op and getattr(torch.Tensor, name) is op
        return
    me, args, kw = CALLS[name]
    r = getattr(_ref(me), name)(*[_ref(a) for a in args], **kw)
    pself = _port(me)
    p = getattr(pself, name)(*[_port(a) for a in args], **kw)
    if name.endswith("_"):
        assert p is pself
    if name == "is_tensor" or name == "check_shape":
        assert p == r
        return
    # eigvals: numpy's (the reference's) is real when the spectrum is,
    # the port's complex always
    held(r, p, dtypes=name != "eigvals")


def test_rank_method_is_int64_and_the_function_int32():
    x = torch.zeros(2, 3)
    assert x.rank().dtype == torch.int64 and int(x.rank()) == 2
    assert pt.rank(x).dtype == torch.int32
    j = paddle_tpu.to_tensor(np.zeros((2, 3), "float32"))
    assert int(j.rank()) == 2 and str(paddle_tpu.rank(j).dtype) == "int32"


def test_in_place_method_on_a_leaf_that_requires_grad():
    """The write goes outside autograd, as `set_value` does."""
    w = torch.ones(3, requires_grad=True)
    assert w.scale_(2.0) is w and w.requires_grad
    np.testing.assert_array_equal(w.detach().numpy(), [2.0, 2.0, 2.0])


def _jt(a):
    return paddle_tpu.to_tensor(a)


def test_kept_name_keeps_torchs_meaning():
    """Each name of DIFFERING: the reference's method (= the namespace
    function, `pt.<name>`) against torch's method of the same name."""
    x = np.arange(12, dtype="float32").reshape(3, 4)
    t, j = torch.from_numpy(x.copy()), _jt(x)
    # split: the number of sections / the size of each
    assert len(j.split(2, axis=1)) == 2 == len(pt.split(t, 2, axis=1))
    assert len(t.split(1, dim=1)) == 4
    # gather: rows along an axis / a take along dim
    assert tuple(j.gather(_jt(np.array([2, 0]))).shape) == (2, 4)
    assert tuple(t.gather(0, torch.tensor([[2, 0, 1, 1]])).shape) == (1, 4)
    # scatter: rows (index, updates) / (dim, index, src)
    assert pt.scatter(t, torch.tensor([0]), torch.zeros(1, 4)).shape == \
        t.shape
    assert t.scatter(1, torch.tensor([[0]]), 5.0)[0, 0] == 5.0
    # transpose: a permutation / two dims
    assert tuple(j.transpose([1, 0]).shape) == (4, 3)
    assert t.transpose(0, 1).shape == (4, 3)
    # max, min: values / (values, indices) over a dim
    assert isinstance(t.max(1), tuple) and not isinstance(j.max(1), tuple)
    assert isinstance(t.min(0), tuple) and not isinstance(j.min(0), tuple)
    # median: the mean of the two middle values / the lower one
    assert float(j.median()) == 5.5 == float(pt.median(t))
    assert float(t.median()) == 5.0
    # sort: values / (values, indices)
    assert isinstance(t.sort(), tuple) and not isinstance(j.sort(), tuple)
    # where: self the condition / self the values where the condition
    c = np.array([[True, False, True, False]] * 3)
    jw = _jt(c).where(j, _jt(-x))
    np.testing.assert_array_equal(np.asarray(jw._value), np.where(c, x, -x))
    assert torch.equal(t.where(torch.from_numpy(c), -t),
                       torch.from_numpy(np.where(c, x, -x)))
    # cumsum: no axis flattens / torch wants a dim
    assert tuple(j.cumsum().shape) == (12,)
    with pytest.raises(TypeError):
        t.cumsum()
    # unique: return_index / torch has none
    assert len(j.unique(return_index=True)) == 2
    with pytest.raises(TypeError):
        t.unique(return_index=True)
    # matmul: cast under AMP / torch's method and ``@`` do not
    from paddle_tpu_torch import amp
    with amp.auto_cast(dtype="float16"):
        assert t.matmul(t.T).dtype == torch.float32
        assert (t @ t.T).dtype == torch.float32
        assert pt.matmul(t, t.T).dtype == torch.float16
