"""The port's losses (`nn.functional.loss`, the layers of `nn.loss`)
against paddle_tpu's, on the same numpy inputs.

Each case runs forward and backward (the loss ``sum(y * r)`` for a
random ``r``, a scalar ``r`` for a reduced loss): the loss and the grads
of every float input within 1e-5 of each tensor's largest |value|
(float32; logs, exps and sums in another order). Covered: the reference's
reductions and parameters where they differ from torch's (kl_div's
"mean" over every element and "batchmean", smooth_l1's ``delta``,
binary_cross_entropy's clamp, softmax_with_cross_entropy's kept axis,
log_loss, dice_loss, square_error_cost, triplet_margin's epsilon a
term), cross_entropy's fused branch (hard labels on the last axis) and
its unfused ones (soft labels, class weights, smoothing, another axis,
probabilities), ``ignore_index`` in the means, and every loss layer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 1e-5
N, C = 6, 5


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


def _labels(seed, shape=(N,), high=C):
    return np.random.default_rng(seed).integers(0, high, shape)


def _probs(shape, seed):
    z = tf.randn(shape, seed)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


def _sigmoid(shape, seed):
    return (1 / (1 + np.exp(-tf.randn(shape, seed, 2.0)))).astype("float32")


def _signs(shape, seed):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0,
                    1.0).astype("float32")


LOGITS = tf.randn((N, C), 1, 2.0)
IGNORED = np.where(np.arange(N) % 3 == 0, -100, _labels(2))
WEIGHT = np.abs(tf.randn((C,), 3)) + 0.5

CE_CASES = {
    "fused_mean": ([LOGITS, _labels(2)], {}),
    "fused_ignore_sum": ([LOGITS, IGNORED], {"reduction": "sum"}),
    "fused_ignore_mean": ([LOGITS, IGNORED], {}),
    "fused_kept_axis_labels": ([LOGITS, _labels(2)[:, None]],
                               {"reduction": "none"}),
    "weighted": ([LOGITS, IGNORED], {"weight": WEIGHT}),
    "smoothing": ([LOGITS, _labels(2)], {"label_smoothing": 0.1}),
    "soft": ([LOGITS, _probs((N, C), 4)], {"soft_label": True}),
    "soft_smoothing_weight": ([LOGITS, _probs((N, C), 4)],
                              {"soft_label": True, "label_smoothing": 0.2,
                               "weight": WEIGHT}),
    "axis1": ([tf.randn((2, C, 3), 5), _labels(6, (2, 3))],
              {"axis": 1, "reduction": "none"}),
    "probabilities": ([_probs((N, C), 7), _labels(2)],
                      {"use_softmax": False}),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy(case):
    arrays, kw = CE_CASES[case]
    if "weight" in kw:
        kw = dict(kw)
        w = kw.pop("weight")
        jw, pw = JTensor(jnp.asarray(w)), torch.from_numpy(w)
        tf.held(tf.port_vjp(F.cross_entropy, arrays, [0], weight=pw, **kw),
                tf.ref_vjp(JF.cross_entropy, arrays, [0], weight=jw, **kw),
                REL, case)
        return
    tf.both(JF.cross_entropy, F.cross_entropy, arrays, [0], REL, **kw)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy(return_softmax):
    arrays = [LOGITS, _labels(2)[:, None]]
    if not return_softmax:
        tf.both(JF.softmax_with_cross_entropy, F.softmax_with_cross_entropy,
                arrays, [0], REL)
        return
    t = torch.from_numpy(LOGITS)
    loss, sm = F.softmax_with_cross_entropy(
        t, torch.from_numpy(arrays[1]), return_softmax=True)
    with jautograd.no_grad():
        jloss, jsm = JF.softmax_with_cross_entropy(
            JTensor(jnp.asarray(LOGITS)),
            JTensor(jnp.asarray(arrays[1])), return_softmax=True)
    assert tuple(loss.shape) == (N, 1)
    tf.tl.close_to_scale(loss.numpy(), np.asarray(jloss._value), REL)
    tf.tl.close_to_scale(sm.numpy(), np.asarray(jsm._value), REL)


LOGP = np.log(_probs((N, C), 8))

CASES = {
    "nll_mean": ("nll_loss", [LOGP, IGNORED], [0], {}),
    "nll_sum": ("nll_loss", [LOGP, IGNORED], [0], {"reduction": "sum"}),
    "nll_3d_none": ("nll_loss", [np.log(_probs((2, 3, C), 9)).transpose(
        0, 2, 1).copy(), _labels(10, (2, 3))], [0], {"reduction": "none"}),
    "mse": ("mse_loss", [tf.randn((N, C), 11), tf.randn((N, C), 12)],
            [0, 1], {}),
    "mse_sum": ("mse_loss", [tf.randn((N, C), 11), tf.randn((N, C), 12)],
                [0, 1], {"reduction": "sum"}),
    "l1_none": ("l1_loss", [tf.randn((N, C), 13), tf.randn((N, C), 14)],
                [0, 1], {"reduction": "none"}),
    "smooth_l1": ("smooth_l1_loss", [tf.randn((N, C), 15, 2.0),
                                     tf.randn((N, C), 16)], [0, 1], {}),
    "smooth_l1_delta": ("smooth_l1_loss", [tf.randn((N, C), 15, 2.0),
                                           tf.randn((N, C), 16)], [0, 1],
                        {"delta": 0.5, "reduction": "sum"}),
    "bce": ("binary_cross_entropy", [_sigmoid((N, C), 17),
                                     _sigmoid((N, C), 18)], [0], {}),
    "bce_hard_none": ("binary_cross_entropy", [
        _sigmoid((N, C), 17), (_sigmoid((N, C), 18) > 0.5).astype(
            "float32")], [0], {"reduction": "none"}),
    "bce_logits": ("binary_cross_entropy_with_logits", [
        tf.randn((N, C), 19, 3.0), _sigmoid((N, C), 20)], [0], {}),
    "kl_mean": ("kl_div", [LOGP, _probs((N, C), 21)], [0, 1], {}),
    "kl_batchmean": ("kl_div", [LOGP, _probs((N, C), 21)], [0, 1],
                     {"reduction": "batchmean"}),
    "kl_none": ("kl_div", [LOGP, _probs((N, C), 21)], [0],
                {"reduction": "none"}),
    "margin_ranking": ("margin_ranking_loss", [
        tf.randn((N,), 22), tf.randn((N,), 23), _signs((N,), 24)], [0, 1],
        {"margin": 0.3}),
    "hinge_embedding": ("hinge_embedding_loss", [
        tf.randn((N, C), 25, 2.0), _signs((N, C), 26)], [0],
        {"margin": 1.5}),
    "cosine_embedding": ("cosine_embedding_loss", [
        tf.randn((N, C), 27), tf.randn((N, C), 28), _signs((N,), 29)],
        [0, 1], {"margin": 0.1}),
    "triplet": ("triplet_margin_loss", [
        tf.randn((N, C), 30), tf.randn((N, C), 31), tf.randn((N, C), 32)],
        [0, 1, 2], {}),
    "triplet_p1_swap": ("triplet_margin_loss", [
        tf.randn((N, C), 30), tf.randn((N, C), 31), tf.randn((N, C), 32)],
        [0, 1, 2], {"p": 1.0, "swap": True, "margin": 2.0,
                    "reduction": "sum"}),
    "square_error_cost": ("square_error_cost", [
        tf.randn((N, C), 33), tf.randn((N, C), 34)], [0, 1], {}),
    "log_loss": ("log_loss", [_sigmoid((N, 1), 35),
                              (_sigmoid((N, 1), 36) > 0.5).astype(
                                  "float32")], [0], {}),
    "dice": ("dice_loss", [_probs((N, 2, C), 37), _labels(38, (N, 2, 1))],
             [0], {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_forward_and_grads(case):
    name, arrays, diff, kw = CASES[case]
    tf.both(getattr(JF, name), getattr(F, name), arrays, diff, REL, **kw)


def test_weighted_losses():
    """Class and element weights, ``pos_weight``: nll_loss's weighted
    mean divides by the picked weights of the valid rows."""
    w = np.abs(tf.randn((N, C), 40)) + 0.1
    pos = np.abs(tf.randn((C,), 41)) + 0.5
    cases = [
        ("nll_loss", [LOGP, IGNORED], {"weight": WEIGHT}),
        ("binary_cross_entropy", [_sigmoid((N, C), 17),
                                  _sigmoid((N, C), 18)], {"weight": w}),
        ("binary_cross_entropy_with_logits",
         [tf.randn((N, C), 19, 3.0), _sigmoid((N, C), 20)],
         {"weight": w, "pos_weight": pos}),
    ]
    for name, arrays, kw in cases:
        jkw = {k: JTensor(jnp.asarray(v)) for k, v in kw.items()}
        pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        tf.held(tf.port_vjp(getattr(F, name), arrays, [0], **pkw),
                tf.ref_vjp(getattr(JF, name), arrays, [0], **jkw), REL,
                name)


LAYERS = {
    "CrossEntropyLoss": ((), {"label_smoothing": 0.1},
                         [LOGITS, _labels(2)]),
    "MSELoss": (("sum",), {}, [tf.randn((N, C), 50), tf.randn((N, C), 51)]),
    "L1Loss": ((), {}, [tf.randn((N, C), 52), tf.randn((N, C), 53)]),
    "NLLLoss": ((), {"ignore_index": 1}, [LOGP, _labels(2)]),
    "BCELoss": ((), {"reduction": "none"},
                [_sigmoid((N, C), 54), _sigmoid((N, C), 55)]),
    "BCEWithLogitsLoss": ((), {}, [tf.randn((N, C), 56),
                                   _sigmoid((N, C), 57)]),
    "SmoothL1Loss": ((), {"delta": 0.3}, [tf.randn((N, C), 58),
                                          tf.randn((N, C), 59)]),
    "KLDivLoss": (("batchmean",), {}, [LOGP, _probs((N, C), 60)]),
    "MarginRankingLoss": ((0.2,), {}, [tf.randn((N,), 61),
                                       tf.randn((N,), 62),
                                       _signs((N,), 63)]),
    "HingeEmbeddingLoss": ((), {}, [tf.randn((N, C), 64),
                                    _signs((N, C), 65)]),
    "CosineEmbeddingLoss": ((0.2,), {}, [tf.randn((N, C), 66),
                                         tf.randn((N, C), 67),
                                         _signs((N,), 68)]),
    "TripletMarginLoss": ((), {"swap": True}, [tf.randn((N, C), 69),
                                               tf.randn((N, C), 70),
                                               tf.randn((N, C), 71)]),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_loss_layers(name):
    args, kw, arrays = LAYERS[name]
    got, want = tf.layer_forward(getattr(jnn, name)(*args, **kw),
                                 getattr(pnn, name)(*args, **kw), *arrays)
    tf.tl.close_to_scale(got, want, REL, name)
