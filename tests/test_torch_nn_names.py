"""The names of the port's `nn` and `nn.functional` against those
paddle_tpu declares in ``paddle_tpu/nn/__init__.py`` and
``paddle_tpu/nn/functional/__init__.py`` (every name its ``from ...
import`` lines bring in).

Every declared name is in the port but those left to the next slice of
A5 (ROADMAP A.1.3): ``nn/rnn.py``, ``nn/decode.py``,
``nn/extra_layers.py``, ``nn/functional/extra.py`` but
``max_pool_with_mask``, ``nn/utils.py`` and ``nn/quant/``. Those are
listed below and must be missing: a name left out by accident fails, and
so does one that arrives without this list being brought up to date. No
name waits for A12 alone: `SyncBatchNorm` is here, its cross-rank
statistics raise naming A12. Every name the port's `nn.functional`
exported before it became a package still imports from it.
"""
import ast
import os

import pytest

import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as pF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's names of the next slice, by the module they come from
LATER = {
    "nn": {
        "rnn": {"BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
                "RNNCellBase", "SimpleRNN", "SimpleRNNCell"},
        "decode": {"BeamSearchDecoder", "dynamic_decode"},
        "extra_layers": {"CTCLoss", "Fold", "HSigmoidLoss", "MaxUnPool1D",
                         "MaxUnPool2D", "MaxUnPool3D",
                         "MultiLabelSoftMarginLoss", "MultiMarginLoss",
                         "PairwiseDistance", "Silu", "SoftMarginLoss",
                         "Softmax2D", "TripletMarginWithDistanceLoss"},
        "modules": {"utils", "quant"},
    },
    "functional": {
        "extra": {"class_center_sample", "ctc_loss", "diag_embed", "elu_",
                  "gather_tree", "hsigmoid_loss", "margin_cross_entropy",
                  "max_unpool1d", "max_unpool2d", "max_unpool3d",
                  "multi_label_soft_margin_loss", "multi_margin_loss",
                  "npair_loss", "pairwise_distance", "sigmoid_focal_loss",
                  "soft_margin_loss", "softmax_", "sparse_attention",
                  "tanh_", "triplet_margin_with_distance_loss",
                  "zeropad2d"},
    },
}

#: ``paddle_tpu_torch.nn.functional``'s names before it became a package
BEFORE = ["gelu", "relu", "layer_norm", "mt_attention_core", "dropout",
          "scaled_dot_product_attention", "cross_entropy", "conv1d",
          "conv2d", "conv3d", "conv1d_transpose", "conv2d_transpose",
          "conv3d_transpose", "flash_attention", "flash_attention_enabled",
          "softmax_ce_logits"]

MODULES = {"nn": ("paddle_tpu/nn/__init__.py", pnn),
           "functional": ("paddle_tpu/nn/functional/__init__.py", pF)}


def _declared(path):
    """The names ``from ... import`` lines of ``path`` bring in (a star
    import is left out: the reference lists those names again)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    return {alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names
            if alias.name != "*"}


def _later(which):
    return set().union(*LATER[which].values())


@pytest.mark.parametrize("which", list(MODULES))
def test_every_name_of_this_slice_is_there(which):
    path, mod = MODULES[which]
    declared = _declared(path)
    assert _later(which) <= declared, _later(which) - declared
    missing = sorted(n for n in declared - _later(which)
                     if not hasattr(mod, n))
    assert not missing, missing


@pytest.mark.parametrize("which", list(MODULES))
def test_the_next_slice_is_still_missing(which):
    """Bring `LATER` up to date with a name the port gains."""
    present = sorted(n for n in _later(which)
                     if hasattr(MODULES[which][1], n))
    assert not present, present


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
                 "vision"):
        assert os.path.exists(os.path.join(
            ROOT, "paddle_tpu_torch", "nn", "functional", f"{name}.py"))
        assert os.path.exists(os.path.join(
            ROOT, "paddle_tpu", "nn", "functional", f"{name}.py"))
    assert hasattr(pF, "max_pool_with_mask")
