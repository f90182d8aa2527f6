"""The port's long tail of `nn.functional` (`functional.extra`) and of the
layers (`nn.extra_layers`) against paddle_tpu's, on the same numpy
inputs.

Each function runs forward and backward (the loss ``sum(y * r)`` for a
random ``r``): the output and the grads of every float input within REL
(1e-5) of each tensor's largest |value| (float32). Covered: distances,
``zeropad2d`` (NCHW, NHWC), ``diag_embed`` (offsets, other dims), the
in-place activations (forward; ``x`` itself comes back), the unpools
(1-D, 2-D, 3-D, ``output_size``) on `max_pool_with_mask`'s indices, the
margin, soft-margin, focal and n-pair losses in their reductions,
``hsigmoid_loss`` on the default tree and a custom one,
``margin_cross_entropy`` (with its softmax; a group of more than one
rank raises), ``ctc_loss`` in every reduction and with
``norm_by_times``, ``sparse_attention`` with both masks, and every layer
of `nn.extra_layers` (`HSigmoidLoss`'s parameter grads too).
``class_center_sample`` draws its negatives from the port's generator,
so it is held on its invariants: the positives first in ascending order
and the relabelling exactly the reference's, every sampled class once,
each label mapped to its own class.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core.random import rng_guard, step_generator
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


def _j(a):
    return JTensor(jnp.asarray(a))


X, Y, Z = tf.randn((N, C), 1), tf.randn((N, C), 2), tf.randn((N, C), 3)
SIGNS = np.where(tf.randn((N, C), 4) > 0, 1.0, -1.0).astype("float32")
MULTI = (tf.randn((N, C), 5) > 0).astype("float32")
W_C = np.abs(tf.randn((C,), 6)) + 0.5

# name -> (reference fn, port fn, arrays, differentiated, keyword args)
CASES = {
    "pairwise_distance": ("pairwise_distance", [X, Y], [0, 1], {}),
    "pairwise_distance_p1_keepdim": ("pairwise_distance", [X, Y], [0, 1],
                                     {"p": 1.0, "keepdim": True}),
    "zeropad2d": ("zeropad2d", [tf.randn((2, 3, 4, 5), 7)], [0],
                  {"padding": [1, 2, 0, 3]}),
    "zeropad2d_nhwc": ("zeropad2d", [tf.randn((2, 4, 5, 3), 7)], [0],
                       {"padding": [1, 0, 2, 1], "data_format": "NHWC"}),
    "diag_embed": ("diag_embed", [tf.randn((2, 4), 8)], [0], {}),
    "diag_embed_offset": ("diag_embed", [tf.randn((2, 4), 8)], [0],
                          {"offset": 1}),
    "diag_embed_negative_dims": ("diag_embed", [tf.randn((2, 3, 4), 8)],
                                 [0], {"offset": -2, "dim1": 0, "dim2": 2}),
    "soft_margin_mean": ("soft_margin_loss", [X, SIGNS], [0], {}),
    "soft_margin_none": ("soft_margin_loss", [X, SIGNS], [0],
                         {"reduction": "none"}),
    "multi_label_soft_margin": ("multi_label_soft_margin_loss", [X, MULTI],
                                [0], {}),
    "multi_label_soft_margin_weighted_sum": (
        "multi_label_soft_margin_loss", [X, MULTI, W_C], [0],
        {"reduction": "sum"}),
    "multi_margin": ("multi_margin_loss", [X, _labels(9)], [0], {}),
    "multi_margin_p2_weighted_none": (
        "multi_margin_loss", [X, _labels(9), 2, 0.7, W_C], [0],
        {"reduction": "none"}),
    "triplet_with_distance": ("triplet_margin_with_distance_loss",
                              [X, Y, Z], [0, 1, 2], {}),
    "triplet_with_distance_swap_sum": (
        "triplet_margin_with_distance_loss", [X, Y, Z], [0, 1, 2],
        {"swap": True, "margin": 2.0, "reduction": "sum"}),
    "sigmoid_focal": ("sigmoid_focal_loss", [X, MULTI], [0], {}),
    "sigmoid_focal_normalized_mean": (
        "sigmoid_focal_loss", [X, MULTI, np.float32(3.0)], [0],
        {"reduction": "mean", "gamma": 1.5}),
    "npair": ("npair_loss", [X, Y, _labels(10, high=3)], [0, 1], {}),
    "margin_cross_entropy": (
        "margin_cross_entropy", [np.tanh(X), _labels(11)], [0], {}),
    "margin_cross_entropy_none": (
        "margin_cross_entropy", [np.tanh(X), _labels(11)], [0],
        {"margin2": 0.3, "margin3": 0.1, "scale": 8.0, "reduction": "none"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_extra_function(case):
    name, arrays, diff, kw = CASES[case]
    arrays = [np.asarray(a) for a in arrays]
    tf.both(getattr(JF, name), getattr(F, name), arrays, diff, REL, **kw)


def test_margin_cross_entropy_softmax_and_group():
    x, y = np.tanh(X), _labels(11)
    want = JF.margin_cross_entropy(_j(x), _j(y), return_softmax=True)
    got = F.margin_cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                                 return_softmax=True)
    for g, w in zip(got, want):
        tf.tl.close_to_scale(g.numpy(), np.asarray(w._value), REL)

    class Group:
        nranks = 2

    with pytest.raises(NotImplementedError, match="A12"):
        F.margin_cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                               group=Group())


@pytest.mark.parametrize("inplace", ["elu_", "softmax_", "tanh_"])
def test_inplace_activations(inplace):
    x = tf.randn((3, 4), 12)
    want = getattr(JF, inplace)(_j(x))
    t = torch.from_numpy(x.copy())
    got = getattr(F, inplace)(t)
    assert got is t
    tf.tl.close_to_scale(t.numpy(), np.asarray(want._value), REL)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool(nd):
    shape = {1: (2, 3, 9), 2: (2, 3, 6, 7), 3: (1, 2, 4, 5, 6)}[nd]
    x = tf.randn(shape, 13)
    pool = getattr(F, f"max_pool{nd}d")
    out, mask = pool(torch.from_numpy(x), 2, 2, return_mask=True)
    arrays = [out.numpy(), mask.numpy()]
    name = f"max_unpool{nd}d"
    tf.both(getattr(JF, name), getattr(F, name), arrays, [0], REL,
            kernel_size=2, stride=2)
    size = list(shape[2:])
    size[-1] += 1
    tf.both(getattr(JF, name), getattr(F, name), arrays, [0], REL,
            kernel_size=2, stride=2, output_size=size)


HS_FEAT, HS_CLASSES = 4, 6


def test_hsigmoid_default_tree():
    x = tf.randn((N, HS_FEAT), 14)
    w = tf.randn((HS_CLASSES - 1, HS_FEAT), 15)
    b = tf.randn((HS_CLASSES - 1,), 16)
    y = _labels(17, high=HS_CLASSES)
    tf.both(JF.hsigmoid_loss, F.hsigmoid_loss, [x, y, HS_CLASSES, w, b],
            [0, 3, 4], REL)


def test_hsigmoid_custom_tree():
    x = tf.randn((N, HS_FEAT), 14)
    w = tf.randn((HS_CLASSES, HS_FEAT), 15)
    b = tf.randn((HS_CLASSES,), 16)
    rng = np.random.default_rng(18)
    table = rng.integers(0, HS_CLASSES, (N, 3))
    table[::2, 2] = -1                             # a shorter path
    code = rng.integers(0, 2, (N, 3))
    y = _labels(17, high=HS_CLASSES)
    tf.both(lambda *a: JF.hsigmoid_loss(*a[:5], path_table=a[5],
                                        path_code=a[6]),
            lambda *a: F.hsigmoid_loss(*a[:5], path_table=a[5],
                                       path_code=a[6]),
            [x, y, HS_CLASSES, w, b, table, code], [0, 3, 4], REL)


CTC_T, CTC_B, CTC_C, CTC_L = 12, 3, 5, 4


def _ctc_arrays():
    rng = np.random.default_rng(19)
    logits = tf.randn((CTC_T, CTC_B, CTC_C), 20)
    labels = rng.integers(1, CTC_C, (CTC_B, CTC_L))
    return [logits, labels, np.array([12, 9, 10]), np.array([4, 2, 0])]


@pytest.mark.parametrize("reduction, norm_by_times",
                         [("mean", False), ("sum", True), ("none", False),
                          ("mean", True)])
def test_ctc_loss(reduction, norm_by_times):
    tf.both(JF.ctc_loss, F.ctc_loss, _ctc_arrays(), [0], REL,
            reduction=reduction, norm_by_times=norm_by_times)


def test_sparse_attention():
    b, h, s, d = 2, 2, 5, 4
    rng = np.random.default_rng(21)
    q, k, v = (tf.randn((b, h, s, d), 22 + i) for i in range(3))
    keep = rng.random((b, h, s, s)) < 0.5
    keep[..., 0] = True                                   # no empty row
    counts = keep.sum(-1)
    nnz = int(counts.sum(-1).max())
    offset = np.zeros((b, h, s + 1), np.int64)
    offset[..., 1:] = np.cumsum(counts, -1)
    cols = np.zeros((b, h, nnz), np.int64)
    for i in range(b):
        for j in range(h):
            c = np.nonzero(keep[i, j])[1]
            cols[i, j, :c.size] = c
    kp = np.ones((b, s), np.int64)
    kp[1, -1] = 0
    am = np.ones((s, s), np.int64)
    am[2, 0] = 0
    tf.both(lambda *a: JF.sparse_attention(
                *a, key_padding_mask=_j(kp), attn_mask=_j(am)),
            lambda *a: F.sparse_attention(
                *a, key_padding_mask=torch.from_numpy(kp),
                attn_mask=torch.from_numpy(am)),
            [q, k, v, offset, cols], [0, 1, 2], REL)


def test_class_center_sample_invariants():
    num_classes, num_samples = 20, 8
    y = np.array([3, 7, 3, 11, 7, 0], np.int64)
    jremap, jsampled = JF.class_center_sample(_j(y), num_classes,
                                              num_samples)
    with rng_guard(step_generator(1, "cpu")):
        remap, sampled = F.class_center_sample(torch.from_numpy(y),
                                               num_classes, num_samples)
    with rng_guard(step_generator(2, "cpu")):
        _, other = F.class_center_sample(torch.from_numpy(y), num_classes,
                                         num_samples)
    pos = np.unique(y)
    sampled, remap = sampled.numpy(), remap.numpy()
    assert sampled.shape == (num_samples,)
    assert len(set(sampled.tolist())) == num_samples
    assert ((sampled >= 0) & (sampled < num_classes)).all()
    np.testing.assert_array_equal(sampled[:pos.size], pos)
    np.testing.assert_array_equal(sampled[remap], y)
    np.testing.assert_array_equal(remap, np.asarray(jremap._value))
    np.testing.assert_array_equal(np.asarray(jsampled._value)[:pos.size], pos)
    assert not np.array_equal(other.numpy(), sampled)
    with pytest.raises(ValueError):
        F.class_center_sample(torch.from_numpy(y), num_classes, 2)


# layer -> (constructor args, inputs, differentiated inputs)
LAYERS = {
    "Fold": (([4, 5], 2), [tf.randn((2, 3 * 4, 12), 30)], [0]),
    "PairwiseDistance": ((3.0,), [X, Y], [0, 1]),
    "Silu": ((), [X], [0]),
    "Softmax2D": ((), [tf.randn((2, 3, 4, 5), 31)], [0]),
    "SoftMarginLoss": (("sum",), [X, SIGNS], [0]),
    "MultiLabelSoftMarginLoss": ((), [X, MULTI], [0]),
    "MultiMarginLoss": ((2, 0.5), [X, _labels(9)], [0]),
    "TripletMarginWithDistanceLoss": ((None, 0.5, True), [X, Y, Z],
                                      [0, 1, 2]),
    "CTCLoss": ((0, "sum"), _ctc_arrays(), [0]),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_extra_layer(name):
    args, arrays, diff = LAYERS[name]
    jlayer, layer = getattr(jnn, name)(*args), getattr(pnn, name)(*args)
    tf.both(lambda *a: jlayer(*a), lambda *a: layer(*a),
            [np.asarray(a) for a in arrays], diff, REL)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_layers(nd):
    shape = {1: (2, 3, 8), 2: (2, 3, 6, 4), 3: (1, 2, 4, 4, 6)}[nd]
    out, mask = getattr(F, f"max_pool{nd}d")(
        torch.from_numpy(tf.randn(shape, 32)), 2, return_mask=True)
    name = f"MaxUnPool{nd}D"
    jlayer, layer = getattr(jnn, name)(2), getattr(pnn, name)(2)
    got, want = tf.layer_forward(jlayer, layer, out.numpy(), mask.numpy())
    tf.tl.close_to_scale(got, want, REL)
    assert got.shape[2:] == tuple(2 * s // 2 for s in shape[2:])


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_layer(custom):
    jlayer = jnn.HSigmoidLoss(HS_FEAT, HS_CLASSES, is_custom=custom)
    layer = tf.twin(jlayer, lambda: pnn.HSigmoidLoss(
        HS_FEAT, HS_CLASSES, is_custom=custom, device="cpu"))
    rows = HS_CLASSES if custom else HS_CLASSES - 1
    assert tuple(layer.weight.shape) == (rows, HS_FEAT)
    kw = {"label": _labels(17, high=HS_CLASSES)}
    if custom:
        rng = np.random.default_rng(33)
        kw.update(path_table=rng.integers(-1, HS_CLASSES, (N, 3)),
                  path_code=rng.integers(0, 2, (N, 3)))
    x = tf.randn((N, HS_FEAT), 34)
    tf.step_held(tf.port_layer_step(layer, None, [x], False, kw),
                 tf.ref_layer_step(jlayer, None, [x], False, kw), REL,
                 "HSigmoidLoss")
    if custom:
        with pytest.raises(ValueError):
            layer(torch.from_numpy(x), torch.from_numpy(kw["label"]))
