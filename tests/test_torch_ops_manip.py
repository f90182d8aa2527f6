"""The port's `ops.manip` against paddle_tpu's ``ops/manip.py``: every
public function on the same seeded numpy inputs, outputs' dtypes and
values (`_torch_ops.TOL`) and, for the differentiable ones, the grads.
The names whose torch meaning differs are cases of their own: ``split``
takes a number of sections, ``gather`` takes rows along an axis,
``scatter(overwrite=False)`` zeroes the rows then accumulates,
``transpose`` takes a permutation, ``unique`` returns int64 indices."""
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as pt
from _torch_ops import Raw, check, held, on_cpu, rand  # noqa: F401

X = rand((2, 3, 4), 1)

#: (name, args, kwargs, grad): one call each
CASES = [
    ("reshape", [X, Raw([6, 4])], {}, True),
    ("reshape", [X, Raw([-1, 2])], {}, False),
    ("transpose", [X, Raw([2, 0, 1])], {}, True),
    ("t", [rand((3, 4), 2)], {}, True),
    ("t", [X], {}, False),
    ("moveaxis", [X, Raw(0), Raw(2)], {}, True),
    ("swapaxes", [X, Raw(0), Raw(2)], {}, True),
    ("squeeze", [rand((2, 1, 3, 1), 3)], {}, True),
    ("squeeze", [rand((2, 1, 3, 1), 3)], {"axis": [1, 2]}, False),
    ("squeeze", [rand((2, 1, 3, 1), 3)], {"axis": -1}, False),
    ("unsqueeze", [X], {"axis": 1}, True),
    ("unsqueeze", [X], {"axis": [0, -1]}, False),
    ("flatten", [X], {}, True),
    ("flatten", [X], {"start_axis": 1}, False),
    ("flatten", [X], {"start_axis": 0, "stop_axis": 1}, False),
    ("concat", [[X, rand((2, 3, 4), 4)]], {"axis": 1}, True),
    ("stack", [[X, rand((2, 3, 4), 4)]], {"axis": -1}, True),
    ("split", [X, Raw(2)], {"axis": 2}, True),
    ("split", [X, Raw([1, 2])], {"axis": 1}, False),
    ("split", [X, Raw([1, -1])], {"axis": 2}, False),
    ("chunk", [X, Raw(3)], {"axis": 1}, False),
    ("unbind", [X], {"axis": 1}, False),
    ("unstack", [X], {}, False),
    ("tile", [rand((2, 3), 5), Raw([2, 1, 2])], {}, True),
    ("expand", [rand((3, 1), 6), Raw([2, 3, 4])], {}, True),
    ("expand", [rand((3, 1), 6), Raw([2, -1, 5])], {}, False),
    ("broadcast_to", [rand((1, 4), 7), Raw([3, 4])], {}, False),
    ("expand_as", [rand((1, 4), 7), rand((3, 4), 8)], {}, False),
    ("view_as", [rand((1, 4), 7), rand((3, 4), 8)], {}, False),
    ("broadcast_tensors", [[rand((1, 4), 7), rand((3, 1), 8)]], {}, False),
    ("broadcast_shape", [Raw([2, 1, 3]), Raw([4, 1])], {}, False),
    ("flip", [X, Raw([0, 2])], {}, True),
    ("flip", [X, Raw(1)], {}, False),
    ("rot90", [X], {"k": 1, "axes": [1, 2]}, True),
    ("rot90", [X], {"k": -1}, False),
    ("roll", [X, Raw(2)], {"axis": 2}, True),
    ("roll", [X, Raw(3)], {}, False),
    ("cast", [X, Raw("int32")], {}, False),
    ("cast", [X, Raw("float64")], {}, False),
    ("slice", [X, Raw([0, 2]), Raw([1, 1]), Raw([2, 3])], {}, True),
    ("slice", [X, Raw([1]), Raw([-2]), Raw([10])], {}, False),
    ("strided_slice", [X, Raw([2]), Raw([0]), Raw([4]), Raw([2])], {}, True),
    ("strided_slice", [X, Raw([1, 2]), Raw([2, 3]), Raw([-4, 0]),
                       Raw([-1, -2])], {}, False),
    ("crop", [X, Raw([1, 2, 2])], {"offsets": [1, 0, 1]}, True),
    ("pad", [rand((2, 3), 9), Raw([1, 2, 0, 1])], {}, True),
    ("pad", [rand((1, 2, 3, 4), 9), Raw([1, 1, 2, 0])],
     {"mode": "reflect"}, True),
    ("pad", [rand((1, 2, 3, 4), 9), Raw([1, 2, 0, 3])],
     {"mode": "replicate"}, False),
    ("pad", [rand((1, 2, 3, 4), 9), Raw([2, 1, 1, 4])],
     {"mode": "circular"}, False),
    ("pad", [rand((1, 3, 4, 2), 9), Raw([1, 0, 2, 1])],
     {"data_format": "NHWC", "value": 2.0}, False),
    ("gather", [rand((5, 3), 10), np.array([4, 0, 2, 2])], {}, True),
    ("gather", [rand((5, 3), 10), np.array([2, 0])], {"axis": 1}, False),
    ("gather", [rand((5, 3), 10), np.array(3)], {}, False),
    ("gather_nd", [X, np.array([[0, 1], [1, 2]])], {}, True),
    ("gather_nd", [X, np.array([[[0, 1, 3]], [[1, 0, 0]]])], {}, False),
    ("scatter_nd_add", [rand((4, 3), 11), np.array([[1], [3], [1]]),
                        rand((3, 3), 12)], {}, True),
    ("scatter_nd", [np.array([[1], [3], [1]]), rand((3, 3), 12),
                    Raw([5, 3])], {}, True),
    ("index_select", [rand((5, 3), 13), np.array([4, 1, 1])], {}, True),
    ("index_select", [rand((5, 3), 13), np.array([2, 0])], {"axis": 1},
     False),
    ("index_sample", [rand((3, 5), 14), np.array([[0, 4], [2, 2], [1, 3]])],
     {}, True),
    ("index_add", [rand((5, 3), 15), np.array([0, 4, 0]), Raw(0),
                   rand((3, 3), 16)], {}, True),
    ("index_put", [rand((4, 3), 17), (np.array([0, 2]), np.array([1, 2])),
                   rand((2,), 18)], {}, True),
    ("index_put", [rand((4, 3), 17), (np.array([0, 0]), np.array([1, 1])),
                   rand((2,), 18)], {"accumulate": True}, False),
    ("take_along_axis", [rand((3, 4), 19), np.array([[0], [3], [1]]),
                         Raw(1)], {}, True),
    ("put_along_axis", [rand((3, 4), 20), np.array([[0], [3], [1]]),
                        rand((3, 1), 21), Raw(1)], {}, True),
    ("put_along_axis", [rand((3, 4), 20), np.array([[0, 0], [3, 1]]),
                        rand((2, 2), 21), Raw(1)], {"reduce": "add"}, False),
    ("put_along_axis", [rand((3, 4), 20), np.array([[0, 2]]), Raw(2.0),
                        Raw(0)], {"reduce": "multiply"}, False),
    ("masked_select", [X, X > 0], {}, False),
    ("masked_fill", [X, X > 0, Raw(-1.0)], {}, True),
    ("repeat_interleave", [rand((2, 3), 22), Raw(2)], {"axis": 1}, True),
    ("repeat_interleave", [rand((2, 3), 22), Raw(3)], {}, False),
    ("as_complex", [rand((2, 3, 2), 23)], {}, False),
    ("as_real", [rand((2, 3), 24, "complex64")], {}, False),
    ("view", [X, Raw([4, 6])], {}, True),
    ("view", [X, Raw("int32")], {}, False),
    ("atleast_1d", [np.array(1.5, np.float32)], {}, False),
    ("atleast_1d", [X], {}, False),
    ("atleast_2d", [rand((3,), 25)], {}, False),
    ("atleast_3d", [rand((3,), 25)], {}, False),
    ("atleast_3d", [rand((3, 2), 25)], {}, False),
    ("diagonal", [X], {"offset": 1, "axis1": 1, "axis2": 2}, True),
    ("argmax", [X], {}, False),
    ("argmax", [X], {"axis": 1, "keepdim": True}, False),
    ("argmin", [X], {"axis": -1, "dtype": "int32"}, False),
    ("argsort", [rand((3, 6), 26, "int64")], {}, False),
    ("argsort", [rand((3, 6), 26, "int64")], {"axis": 0,
                                               "descending": True}, False),
    ("sort", [X], {"axis": 1}, True),
    ("sort", [X], {"descending": True}, False),
    ("topk", [rand((3, 6), 27), Raw(2)], {}, True),
    ("topk", [rand((3, 6), 27), Raw(3)], {"axis": 0, "largest": False},
     False),
    ("kthvalue", [rand((3, 6), 28), Raw(2)], {}, True),
    ("kthvalue", [rand((3, 6), 28), Raw(3)], {"axis": 0, "keepdim": True},
     False),
    ("mode", [rand((3, 7), 29, "int64")], {}, False),
    ("mode", [rand((4, 5), 30, "int64")], {"axis": 0, "keepdim": True},
     False),
    ("nonzero", [X > 0.5], {}, False),
    ("nonzero", [X > 0.5], {"as_tuple": True}, False),
    ("searchsorted", [np.sort(rand((6,), 31)), rand((2, 3), 32)], {}, False),
    ("searchsorted", [np.sort(rand((2, 6), 31), 1), rand((2, 3), 32)],
     {"right": True, "out_int32": True}, False),
    ("bucketize", [rand((2, 3), 32), np.sort(rand((6,), 31))], {}, False),
    ("unique", [rand((3, 5), 33, "int64")], {}, False),
    ("unique", [rand((3, 5), 33, "int64")],
     {"return_index": True, "return_inverse": True, "return_counts": True},
     False),
    ("unique", [np.array([[1, 2], [1, 2], [0, 5]])],
     {"axis": 0, "return_inverse": True, "return_counts": True,
      "return_index": True}, False),
    ("unique_consecutive", [np.array([1, 1, 2, 2, 2, 1, 3, 3])],
     {"return_inverse": True, "return_counts": True}, False),
    ("unique_consecutive", [np.array([[1, 1], [2, 1]])], {}, False),
    ("histogram", [rand((50,), 34)], {"bins": 7}, False),
    ("histogram", [rand((50,), 34)], {"bins": 4, "min": -1, "max": 1},
     False),
    ("bincount", [np.array([0, 3, 3, 1, 5])], {}, False),
    ("bincount", [np.array([0, 3, 3, 1]), rand((4,), 35)],
     {"minlength": 6}, False),
    ("diff", [X], {}, True),
    ("diff", [X], {"n": 2, "axis": 1}, False),
    ("diff", [rand((5,), 36)], {"prepend": np.array([1.0], np.float32),
                                "append": np.array([2.0, 3.0], np.float32)},
     False),
    ("unflatten", [X, Raw(2), Raw([2, 2])], {}, True),
    ("vander", [rand((4,), 37)], {}, True),
    ("vander", [rand((4,), 37)], {"n": 3, "increasing": True}, False),
    ("renorm", [X, Raw(2.0), Raw(1), Raw(1.5)], {}, True),
    ("as_strided", [X, Raw([3, 2]), Raw([4, 1])], {"offset": 2}, True),
    ("take", [X, np.array([[0, 23], [-1, 5]])], {}, True),
    ("take", [X, np.array([30, -30])], {"mode": "wrap"}, False),
    ("take", [X, np.array([30, -3])], {"mode": "clip"}, False),
    ("vsplit", [rand((4, 3), 38), Raw(2)], {}, False),
    ("reverse", [X, Raw([0, 1])], {}, True),
    ("shard_index", [np.array([[1], [6], [12], [19]])],
     {"index_num": 20, "nshards": 2, "shard_id": 1}, False),
    ("shape", [X], {}, False),
    ("rank", [X], {}, False),
]


def _id(case):
    return case[0]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_manip(case, on_cpu):
    name, args, kw, grad = case
    check(name, args, kw, grad=grad)


def test_split_takes_a_number_of_sections():
    """``split(x, 3)`` makes three parts; torch's ``split(x, 3)`` parts
    of size 3."""
    x = torch.arange(12.0).reshape(2, 6)
    parts = pt.split(x, 3, axis=1)
    assert [p.shape[1] for p in parts] == [2, 2, 2]
    assert [p.shape[1] for p in x.split(3, dim=1)] == [3, 3]
    with pytest.raises(ValueError):
        pt.split(x, 4, axis=1)


def test_gather_takes_rows_along_an_axis():
    """``gather(x, idx, axis)`` is ``jnp.take``; torch's ``gather`` is a
    take along ``dim`` with an index of ``x``'s rank."""
    x = rand((4, 3), 40)
    check("gather", [x, np.array([3, 1])], {"axis": 0})
    t = torch.from_numpy(x)
    idx = torch.tensor([[3, 1, 0]])
    assert not torch.equal(pt.gather(t, torch.tensor([3, 1])),
                           t.gather(0, idx))


@pytest.mark.parametrize("overwrite", [True, False])
def test_scatter_overwrite(overwrite):
    """With ``overwrite=False`` the indexed rows are zeroed, then every
    update added: duplicates sum."""
    x = rand((5, 3), 41)
    idx = np.array([1, 3, 1]) if not overwrite else np.array([1, 3, 0])
    upd = rand((3, 3), 42)
    _, p = check("scatter", [x, idx, upd], {"overwrite": overwrite},
                 grad=True)
    if not overwrite:
        np.testing.assert_allclose(p.detach().numpy()[1], upd[0] + upd[2],
                                   rtol=1e-6)


def test_in_place_forms_write_x():
    for overwrite in (True, False):
        x = rand((5, 3), 43)
        jx = paddle_tpu.to_tensor(x)
        px = torch.from_numpy(x.copy())
        idx, upd = np.array([0, 2, 0]), rand((3, 3), 44)
        paddle_tpu.ops.scatter_(jx, paddle_tpu.to_tensor(idx),
                                paddle_tpu.to_tensor(upd),
                                overwrite=overwrite)
        out = pt.ops.scatter_(px, torch.from_numpy(idx),
                              torch.from_numpy(upd), overwrite=overwrite)
        assert out is px
        if not overwrite:
            held(jx, px)
    jx, px = paddle_tpu.to_tensor(x), torch.from_numpy(x.copy())
    paddle_tpu.ops.index_add_(jx, paddle_tpu.to_tensor(np.array([4, 0])), 0,
                              paddle_tpu.to_tensor(upd[:2]))
    assert pt.ops.index_add_(px, torch.tensor([4, 0]), 0,
                             torch.from_numpy(upd[:2])) is px
    held(jx, px)
    jx, px = paddle_tpu.to_tensor(x), torch.from_numpy(x.copy())
    paddle_tpu.ops.reshape_(jx, [3, 5])
    assert pt.ops.reshape_(px, [3, 5]) is px
    held(jx, px)


def test_take_raises_out_of_range():
    for mod, mk in ((paddle_tpu, paddle_tpu.to_tensor), (pt, torch.tensor)):
        with pytest.raises(IndexError):
            mod.take(mk(np.arange(6.0)), mk(np.array([6])))


def test_atleast_of_a_python_number_is_float32():
    """A Python float becomes float32 (torch's default), where the
    reference's x64 mode makes it float64 (ROADMAP C.3)."""
    assert pt.atleast_1d(1.5).dtype == torch.float32
    assert str(paddle_tpu.atleast_1d(1.5).dtype) == "float64"


def test_tolist():
    assert pt.tolist(torch.from_numpy(X)) == paddle_tpu.tolist(
        paddle_tpu.to_tensor(X))


def test_every_function_of_the_module_has_a_case():
    from paddle_tpu.ops import _collect, manip as jmanip
    covered = {c[0] for c in CASES} | {
        "scatter", "scatter_", "index_add_", "reshape_", "tolist"}
    names = set(_collect(jmanip))
    assert not names - covered, sorted(names - covered)
    assert all(hasattr(pt.ops.manip, n) for n in names)
