"""The port's `ops.creation` against paddle_tpu's ``ops/creation.py``:
every public function, the deterministic ones on the same inputs (dtype
and values, `_torch_ops.TOL`), the random ones in distribution only
(shape, dtype, range and moments: torch's generators and JAX's keys draw
other numbers from one seed). Creation ops given no tensor run on the
expected device, so each test sets the CPU (`_torch_ops.on_cpu`) and
puts the previous setting back."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from paddle_tpu_torch import device as pdevice
from _torch_ops import Raw, check, held, on_cpu, rand  # noqa: F401

#: creation ops with no tensor input: name -> (args, kwargs) cases
NO_INPUT = {
    "zeros": [([[2, 3]], {}), ([[2]], {"dtype": "int32"})],
    "ones": [([[2, 3]], {}), ([[3]], {"dtype": "bool"})],
    "full": [([[2, 3], 1.5], {}), ([[2], 7], {"dtype": "int64"})],
    "empty": [([[2, 3]], {})],
    "arange": [([5], {}), ([1, 7, 2], {}), ([0.0, 1.0, 0.25], {}),
               ([0, 5], {"dtype": "float32"})],
    "linspace": [([0.0, 1.0, 7], {}), ([-2, 3, 5], {"dtype": "float64"})],
    "logspace": [([0.0, 2.0, 5], {}), ([0.0, 3.0, 4], {"base": 2.0})],
    "eye": [([3], {}), ([2, 4], {}), ([3], {"dtype": "int32"})],
    "tril_indices": [([4], {}), ([4, 5, 1], {})],
    "triu_indices": [([4], {}), ([4, 5, -1], {})],
}


@pytest.mark.parametrize("name", list(NO_INPUT))
def test_creation_with_no_input(name, on_cpu):
    for args, kw in NO_INPUT[name]:
        check(name, [Raw(a) for a in args], kw)


@pytest.mark.parametrize("data", [
    1.5, 3, True, [1, 2, 3], [[1.0, 2.0], [3.0, 4.0]],
    np.arange(4, dtype=np.float64), np.arange(6, dtype=np.int32),
    1 + 2j], ids=lambda d: type(d).__name__)
def test_to_tensor_dtypes(data, on_cpu):
    """Python floats become float32 (the reference's rule for py data),
    ints int64; a numpy array keeps its dtype."""
    for name in ("to_tensor", "as_tensor"):
        r, p = check(name, [Raw(data)])
        assert p.device.type == "cpu" and not p.requires_grad


def test_to_tensor_of_tensors_dtype_place_and_stop_gradient(on_cpu):
    x = rand((2, 3), 1)
    check("to_tensor", [x], {"dtype": "float64"})
    p = pt.to_tensor([[1, 2], [3, 4]], dtype="float32", stop_gradient=False)
    assert p.dtype == torch.float32 and p.requires_grad
    p = pt.to_tensor(torch.ones(2), place=pt.CPUPlace())
    assert p.device.type == "cpu"
    mixed = pt.to_tensor([torch.tensor(1.5), torch.tensor(2.5)])
    ref = paddle_tpu.to_tensor([paddle_tpu.to_tensor(1.5),
                                paddle_tpu.to_tensor(2.5)])
    held(ref, mixed)


def test_to_tensor_runs_on_the_expected_device(monkeypatch):
    """With no ``place`` the tensor goes to the expected device: the
    card, or a raise when there is none (``set_device("cpu")`` asks
    for the CPU)."""
    saved = pdevice.expected_device()
    try:
        pdevice.set_expected_device(None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.to_tensor([1.0])
        with pytest.raises(RuntimeError):
            pt.zeros([2])
        pt.set_device("cpu")
        assert pt.zeros([2]).device.type == "cpu"
    finally:
        pdevice.set_expected_device(saved)


def test_like_ops(on_cpu):
    x = rand((2, 3), 2)
    for name in ("zeros_like", "ones_like", "empty_like"):
        check(name, [x])
        check(name, [x], {"dtype": "int32"})
    check("full_like", [x, Raw(2.5)])
    check("full_like", [x, Raw(3)], {"dtype": "int64"})


def test_full_of_a_tensor_value(on_cpu):
    v = np.array([2.5], np.float32)
    check("full", [Raw([2, 2]), v])
    with pytest.raises(ValueError):
        pt.full([2], torch.ones(2))


def test_diag_diagflat_diag_embed(on_cpu):
    v, m = rand((4,), 3), rand((3, 4), 4)
    check("diag", [v], grad=True)
    check("diag", [v], {"offset": 1, "padding_value": 9.0})
    check("diag", [v], {"offset": -2})
    check("diag", [m], {"offset": 1}, grad=True)
    check("diagflat", [m], {"offset": -1}, grad=True)
    x = rand((2, 3), 5)
    check("diag_embed", [x], grad=True)
    check("diag_embed", [x], {"offset": 1})
    check("diag_embed", [x], {"offset": -1, "dim1": 0, "dim2": 2})
    check("diag_embed", [x], {"dim1": 1, "dim2": 0})


def test_meshgrid_tril_triu(on_cpu):
    a, b = rand((3,), 6), rand((4,), 7)
    check("meshgrid", [a, b])
    check("meshgrid", [[a, b]])
    m = rand((4, 5), 8)
    for k in (0, 1, -1):
        check("tril", [m], {"diagonal": k}, grad=True)
        check("triu", [m], {"diagonal": k}, grad=True)


def test_assign_clone_numel_complex_polar(on_cpu):
    x = rand((2, 3), 9)
    check("assign", [x])
    check("assign", [Raw([[1.0, 2.0]])])
    out = pt.zeros([2, 3])
    assert pt.assign(torch.from_numpy(x), out) is out
    np.testing.assert_array_equal(out.numpy(), x)
    check("clone", [x], grad=True)
    check("numel", [x])
    check("complex", [x, rand((2, 3), 10)])
    check("polar", [np.abs(x), rand((2, 3), 11)])


def _moments(t):
    a = t.detach().double()
    return a.mean().item(), a.std().item()


def test_random_ops_in_distribution(on_cpu):
    """Shapes, dtypes, ranges and the first two moments of 20000 draws
    against the distribution's (the reference's draws come from JAX's
    keys: only their shapes and dtypes are compared)."""
    n = (100, 200)
    pt.seed(5)
    cases = {
        "rand": (pt.rand(n), 0.5, (1 / 12) ** 0.5, (0, 1)),
        "randn": (pt.randn(n), 0.0, 1.0, None),
        "standard_normal": (pt.standard_normal(n), 0.0, 1.0, None),
        "uniform": (pt.uniform(n, min=2.0, max=4.0), 3.0, (4 / 12) ** 0.5,
                    (2, 4)),
        "normal": (pt.normal(1.0, 2.0, n), 1.0, 2.0, None),
    }
    for name, (t, mu, sd, rng) in cases.items():
        assert t.shape == n and t.dtype == torch.float32, name
        m, s = _moments(t)
        assert abs(m - mu) < 0.05 * max(sd, 1) and abs(s - sd) < 0.03 * sd, \
            (name, m, s)
        if rng:
            assert rng[0] <= t.min().item() and t.max().item() < rng[1]
        ref = getattr(paddle_tpu, name)(*((n,) if name != "normal"
                                           else (1.0, 2.0, n)))
        assert tuple(ref.shape) == n
    ri = pt.randint(3, 9, n)
    assert ri.dtype == torch.int64 and ri.min() >= 3 and ri.max() <= 8
    assert str(paddle_tpu.randint(3, 9, n).dtype) == "int64"
    like = pt.randint_like(torch.zeros(5, 6, dtype=torch.int32), 10)
    assert like.dtype == torch.int32 and like.shape == (5, 6)
    perm = pt.randperm(50)
    assert sorted(perm.tolist()) == list(range(50))
    assert perm.dtype == torch.int64


def test_normal_of_tensors_and_seeded_uniform(on_cpu):
    m = torch.zeros(300, 300)
    s = torch.full((300, 300), 3.0)
    t = pt.normal(m, s)
    assert t.shape == (300, 300) and abs(t.std().item() - 3.0) < 0.05
    a = pt.uniform([4, 4], seed=11)
    b = pt.uniform([4, 4], seed=11)
    c = pt.uniform([4, 4])
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_bernoulli_multinomial_poisson(on_cpu):
    p = torch.full((200, 100), 0.3)
    b = pt.bernoulli(p)
    assert b.dtype == torch.float32 and set(b.unique().tolist()) <= {0, 1}
    assert abs(b.mean().item() - 0.3) < 0.02
    probs = torch.tensor([0.1, 0.0, 0.6, 0.3])
    draws = pt.multinomial(probs, 4000, replacement=True)
    assert draws.dtype == torch.int64 and (draws != 1).all()
    freq = torch.bincount(draws, minlength=4).double() / 4000
    assert torch.allclose(freq, probs.double(), atol=0.03)
    rows = pt.multinomial(torch.tensor([[0.5, 0.5, 0.0], [0.0, 0.2, 0.8]]),
                          2)
    assert rows.shape == (2, 2) and rows[0].tolist() in ([0, 1], [1, 0])
    lam = torch.full((300, 100), 4.0)
    po = pt.poisson(lam)
    assert po.dtype == torch.float32 and abs(po.mean().item() - 4) < 0.05
    assert abs(po.var().item() - 4) < 0.2
    for name, arg in (("bernoulli", p), ("poisson", lam)):
        ref = getattr(paddle_tpu, name)(paddle_tpu.to_tensor(arg.numpy()))
        assert str(ref.dtype) == "float32"


def test_random_ops_follow_seed_and_generator_state(on_cpu):
    pt.seed(123)
    a = pt.rand([8])
    pt.seed(123)
    assert torch.equal(a, pt.rand([8]))
    state = pt.get_rng_state()
    b = pt.randn([8])
    pt.set_rng_state(state)
    assert torch.equal(b, pt.randn([8]))


def test_create_parameter_and_check_shape(on_cpu):
    w = pt.create_parameter([3, 4], "float32")
    assert isinstance(w, pt.Parameter) and w.shape == (3, 4)
    assert w.requires_grad and w.device.type == "cpu"
    b = pt.ops.create_parameter([4], is_bias=True, device="cpu")
    assert not b.detach().any()
    for mod in (paddle_tpu, pt):
        assert mod.check_shape([2, 3]) is None
        with pytest.raises(TypeError):
            mod.check_shape((2, "3"))
        with pytest.raises(TypeError):
            mod.check_shape(3)
    assert pt.check_shape(torch.tensor([2, 3])) is None
    with pytest.raises(TypeError):
        pt.check_shape(torch.tensor([2.0]))
    with pytest.raises(TypeError):
        paddle_tpu.check_shape(paddle_tpu.to_tensor([2.0]))


def test_every_function_of_the_module_has_a_case():
    from paddle_tpu.ops import _collect, creation as jcreation
    covered = set(NO_INPUT) | {
        "to_tensor", "as_tensor", "zeros_like", "ones_like", "empty_like",
        "full_like", "diag", "diagflat", "diag_embed", "meshgrid", "tril",
        "triu", "assign", "clone", "numel", "complex", "polar", "rand",
        "randn", "standard_normal", "uniform", "normal", "randint",
        "randint_like", "randperm", "bernoulli", "multinomial", "poisson",
        "create_parameter", "check_shape"}
    names = set(_collect(jcreation))
    assert not names - covered, sorted(names - covered)
    assert all(hasattr(pt.ops.creation, n) for n in names)
