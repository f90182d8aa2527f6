"""Every public name of `paddle_tpu.ops`, `paddle_tpu.linalg`,
`paddle_tpu.fft`, `paddle_tpu.signal` and the `paddle_tpu` top level is
in the port, or listed here with the ROADMAP item that will bring it
(after ``tests/test_torch_nn_names.py``). The top level's names are those
``import paddle_tpu`` defines, with the subpackages and aliases its
module ``__getattr__`` reaches lazily (``paddle_tpu/__init__.py:192-235``).
"""
import ast
import os
import subprocess
import sys

import pytest

import paddle_tpu
import paddle_tpu.fft as jfft
import paddle_tpu.linalg as jlinalg
import paddle_tpu.ops as jops
import paddle_tpu.signal as jsignal
import paddle_tpu_torch as pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level names the port does not have yet, by ROADMAP item
LATER = {
    "enable_static": "A14", "disable_static": "A14", "summary": "A14",
    "flops": "A14", "get_flags": "A14", "set_flags": "A14", "jit": "A14",
    "static": "A14", "io": "A14", "metric": "A14", "hapi": "A14",
    "distribution": "A14", "sparse": "A14",
    "text": "A14", "onnx": "A14", "callbacks": "A14", "inference": "A14",
    "audio": "A14", "geometric": "A14", "cost_model": "A14", "hub": "A14",
    "utils": "A14", "Model": "A14", "DataParallel": "A12",
}
#: names ``dir(paddle_tpu)`` shows that are no API: the ``from
#: __future__ import annotations`` feature object
NOT_API = {"annotations"}


def _lazy_top_level():
    """The names the reference's top-level ``__getattr__`` resolves:
    ``_LAZY_SUBMODULES`` and the late-bound aliases."""
    with open(os.path.join(ROOT, "paddle_tpu/__init__.py")) as f:
        tree = ast.parse(f.read())
    lazy = next(ast.literal_eval(n.value) for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "_LAZY_SUBMODULES")
    return set(lazy) | {"Model", "DataParallel", "LazyGuard"}


def _top_level():
    """The public names of a fresh ``import paddle_tpu``, in a process of
    their own: in this one, a submodule that another test imported (say
    ``paddle_tpu.sysconfig``) has joined the package's attributes."""
    out = subprocess.run(
        [sys.executable, "-c", "import paddle_tpu; print(' '.join("
         "n for n in dir(paddle_tpu) if not n.startswith('_')))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    names = set(out.stdout.split())
    return (names | _lazy_top_level()) - NOT_API


@pytest.mark.parametrize("ref, port", [
    (jops, pt.ops), (jlinalg, pt.linalg), (jfft, pt.fft),
    (jsignal, pt.signal)], ids=["ops", "linalg", "fft", "signal"])
def test_every_name_of_the_namespace_modules_is_there(ref, port):
    missing = sorted(n for n in ref.__all__ if not hasattr(port, n))
    assert not missing, missing
    assert sorted(port.__all__) == sorted(ref.__all__)


def test_every_op_is_at_the_top_level():
    missing = sorted(n for n in jops.__all__ if not hasattr(pt, n))
    assert not missing, missing
    for n in jops.__all__:
        assert getattr(pt, n) is getattr(pt.ops, n), n


def test_every_top_level_name_is_there_or_labelled():
    names = _top_level()
    assert len(names) > 300
    missing = sorted(n for n in names if n not in LATER
                     and not hasattr(pt, n))
    assert not missing, missing
    # a label is dropped when its name arrives; ``jit`` is the port's own
    # capture module under the reference's name (its ``to_static``,
    # ``save`` and ``load`` are A14)
    arrived = sorted(n for n in LATER if hasattr(pt, n))
    assert arrived == ["jit"], arrived


def test_jit_is_the_ports_capture_module_not_the_reference_jit():
    """``paddle.jit`` exists in the port as its CUDA-graph capture
    (`jit.capture`); the reference's ``to_static``/``save``/``load``
    are A14."""
    assert hasattr(pt.jit, "capture")
    assert not hasattr(pt.jit, "to_static")


def test_the_reference_top_level_helpers():
    """The reference's own helpers at the top level: in-place forms,
    ``batch``, print options, the default dtype, ``iinfo``/``finfo``,
    dynamic mode, ``save``/``load`` bound to ``framework.io``."""
    import numpy as np
    import torch

    x = torch.ones(2, 1, 3)
    assert pt.squeeze_(x, 1) is x and x.shape == (2, 3)
    assert pt.unsqueeze_(x, [0, -1]) is x and x.shape == (1, 2, 3, 1)
    y = torch.zeros(2)
    assert pt.tanh_(y) is y

    def reader():
        yield from range(5)

    assert list(pt.batch(reader, 2)()) == [[0, 1], [2, 3], [4]]
    assert list(pt.batch(reader, 2, drop_last=True)()) == [[0, 1], [2, 3]]
    assert list(paddle_tpu.batch(reader, 2)()) == [[0, 1], [2, 3], [4]]
    saved = pt.get_default_dtype()
    try:
        pt.set_default_dtype("float16")
        assert pt.get_default_dtype() == "float16"
        paddle_tpu.set_default_dtype("float16")
        assert paddle_tpu.get_default_dtype() == "float16"
    finally:
        pt.set_default_dtype(saved)
        paddle_tpu.set_default_dtype(saved)
    assert pt.iinfo("int32").max == np.iinfo(np.int32).max
    assert pt.finfo("float16").eps == float(np.finfo(np.float16).eps)
    assert pt.finfo(pt.bfloat16).bits == 16
    assert pt.in_dynamic_mode() is True is paddle_tpu.in_dynamic_mode()
    assert pt.disable_signal_handler() is None
    pt.set_printoptions(precision=3)
    pt.set_printoptions(precision=4)
    from paddle_tpu_torch.framework import io
    assert pt.save.__module__ == "paddle_tpu_torch" and hasattr(io, "save")


def test_save_load_round_trip(tmp_path):
    import torch

    path = str(tmp_path / "w.pdparams")
    pt.save({"w": torch.arange(4.0)}, path)
    back = pt.load(path)
    assert torch.equal(torch.as_tensor(back["w"]), torch.arange(4.0))
