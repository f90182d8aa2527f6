"""The names of the port's `nn`, `nn.functional`, `nn.quant` and
`nn.utils` against those paddle_tpu declares in ``paddle_tpu/nn/
__init__.py``, ``paddle_tpu/nn/functional/__init__.py`` (every name
their ``from ... import`` lines bring in), ``paddle_tpu/nn/quant/
__init__.py`` and ``paddle_tpu/nn/utils.py`` (their ``__all__``).

Every declared name is in the port: a name the reference adds and the
port lacks fails. No name waits for A12 alone: `SyncBatchNorm` is here,
its cross-rank statistics raise naming A12, and so does
`margin_cross_entropy` over a group of more than one rank. Every name
the port's `nn.functional` exported before it became a package still
imports from it.
"""
import ast
import os

import pytest

import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as pF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``paddle_tpu_torch.nn.functional``'s names before it became a package
BEFORE = ["gelu", "relu", "layer_norm", "mt_attention_core", "dropout",
          "scaled_dot_product_attention", "cross_entropy", "conv1d",
          "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
          "conv3d_transpose", "flash_attention", "flash_attention_enabled",
          "softmax_ce_logits"]

MODULES = {"nn": ("paddle_tpu/nn/__init__.py", pnn),
           "functional": ("paddle_tpu/nn/functional/__init__.py", pF),
           "quant": ("paddle_tpu/nn/quant/__init__.py", pnn.quant),
           "utils": ("paddle_tpu/nn/utils.py", pnn.utils)}


def _declared(path):
    """The names in ``path``'s ``__all__`` where it has one, else those
    its ``from ... import`` lines bring in (a star import is left out:
    the reference lists those names again)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names
            if alias.name != "*"}


@pytest.mark.parametrize("which", list(MODULES))
def test_every_name_of_this_slice_is_there(which):
    """Every name the reference's module declares, in the port's own
    module of the same path."""
    path, mod = MODULES[which]
    own = path[:-len(".py")].replace("/__init__", "").replace("/", ".")
    assert mod.__name__ == own.replace("paddle_tpu", "paddle_tpu_torch", 1)
    declared = _declared(path)
    assert declared
    missing = sorted(n for n in declared if not hasattr(mod, n))
    assert not missing, missing


@pytest.mark.parametrize("which", list(MODULES))
def test_exports_are_importable(which):
    mod = MODULES[which][1]
    assert all(hasattr(mod, n) for n in mod.__all__)
    assert len(set(mod.__all__)) == len(mod.__all__)


def test_functional_names_from_before_the_package():
    missing = [n for n in BEFORE if not hasattr(pF, n)]
    assert not missing, missing
    from paddle_tpu_torch.nn.functional import (conv2d, cross_entropy,  # noqa
                                                mt_attention_core)


def test_functional_modules_follow_the_reference_layout():
    for name in ("activation", "common", "conv", "loss", "norm", "pooling",
                 "vision", "extra"):
        assert os.path.exists(os.path.join(
            ROOT, "paddle_tpu_torch", "nn", "functional", f"{name}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "paddle_tpu", "nn", "functional", f"{name}.py"))
    assert hasattr(pF, "max_pool_with_mask")
