"""The port's vision and common functions (`nn.functional.vision`,
`nn.functional.common`) and the common layers (`nn.common`) against
paddle_tpu's, on the same numpy inputs.

Deterministic functions run forward and backward (the loss ``sum(y *
r)``): outputs and the grads of every float input within 1e-5 of each
tensor's largest |value| (float32, sums in another order; `interpolate`
applies the reference's resize weights, which jax builds in float64).
Covered where the reference differs from torch: `affine_grid`'s and
`grid_sample`'s ``align_corners`` default True, every ``padding_mode``
with either ``align_corners``; `interpolate`'s half-pixel resize
(``jax.image.resize``: nearest floors ``(i + 0.5) * in / out``, linear
and cubic antialiased when downsampling, "area" as linear, Keys' a =
-0.5) and its ``align_corners`` linear path; `pad`'s pair order and
modes on channels-first and channels-last inputs; `cosine_similarity`'s
clamp of the norms' product. The dropouts draw random numbers: held in
distribution against their expected law and the reference's draws,
within 5 standard errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.nn import functional as F

import _torch_fns as tf

REL = 1e-5
SIGMAS = 5.0


@pytest.fixture(autouse=True)
def _state_kept():
    with tf.state_kept():
        yield


X = tf.randn((2, 3, 5, 6), 0)
X_NHWC = np.ascontiguousarray(X.transpose(0, 2, 3, 1))
THETA = (np.eye(2, 3)[None] + 0.3 * tf.randn((2, 2, 3), 1)).astype(
    "float32")


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid(align_corners):
    tf.both(JF.affine_grid, F.affine_grid, [THETA, [2, 3, 4, 5]], [0], REL,
            align_corners=align_corners)


GRID = (tf.randn((2, 4, 3, 2), 2) * 0.8).astype("float32")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(mode, padding_mode, align_corners):
    diff = [0, 1] if mode == "bilinear" else [0]
    tf.both(JF.grid_sample, F.grid_sample, [X, GRID], diff, REL, mode=mode,
            padding_mode=padding_mode, align_corners=align_corners)


def test_grid_sample_default_align_corners_is_true():
    x, g = torch.from_numpy(X), torch.from_numpy(GRID)
    torch.testing.assert_close(F.grid_sample(x, g),
                               F.grid_sample(x, g, align_corners=True))


@pytest.mark.parametrize("kw", [
    dict(output_sizes=[5, 6], kernel_sizes=3, paddings=1),
    dict(output_sizes=[6, 7], kernel_sizes=[2, 3], strides=[2, 1],
         dilations=[1, 2])], ids=["pad", "stride_dilation"])
def test_fold_and_unfold(kw):
    unfold_kw = {k: v for k, v in kw.items() if k != "output_sizes"}
    x = tf.randn((2, 3) + tuple(kw["output_sizes"]), 3)
    tf.both(JF.unfold, F.unfold, [x], [0], REL, **unfold_kw)
    cols = F.unfold(torch.from_numpy(x), **unfold_kw).numpy()
    tf.both(JF.fold, F.fold, [cols], [0], REL, **kw)


def test_temporal_shift():
    tf.both(JF.temporal_shift, F.temporal_shift,
            [tf.randn((6, 8, 2, 3), 4)], [0], REL, seg_num=3,
            shift_ratio=0.25)


INTERP = {
    "nearest_up": dict(size=[9, 13]),
    "nearest_down": dict(scale_factor=0.5),
    "bilinear_up": dict(scale_factor=2, mode="bilinear"),
    "bilinear_down_antialias": dict(size=[3, 4], mode="bilinear"),
    "bilinear_align": dict(size=[8, 11], mode="bilinear",
                           align_corners=True),
    "bicubic_up": dict(size=[7, 10], mode="bicubic"),
    "bicubic_down": dict(size=[3, 3], mode="bicubic"),
    "area": dict(size=[2, 3], mode="area"),
    "one_dim_kept": dict(size=[5, 9], mode="bilinear"),
    "align_one_row": dict(size=[1, 4], mode="bilinear", align_corners=True),
}


@pytest.mark.parametrize("case", list(INTERP))
def test_interpolate(case):
    tf.both(JF.interpolate, F.interpolate, [X], [0], REL, **INTERP[case])


@pytest.mark.parametrize("x,kw", [
    (tf.randn((2, 3, 7), 5), dict(scale_factor=2, mode="linear",
                                  data_format="NCW")),
    (tf.randn((1, 2, 3, 4, 5), 6), dict(size=[4, 6, 3], mode="trilinear",
                                        data_format="NCDHW")),
    (X_NHWC, dict(size=[7, 4], mode="bilinear", data_format="NHWC")),
    (X_NHWC, dict(scale_factor=[2, 1], data_format="NHWC")),
], ids=["linear_1d", "trilinear", "nhwc_bilinear", "nhwc_nearest"])
def test_interpolate_layouts(x, kw):
    tf.both(JF.interpolate, F.interpolate, [x], [0], REL, **kw)


def test_upsample_is_interpolate():
    tf.both(JF.upsample, F.upsample, [X], [0], REL, size=[4, 9],
            mode="bicubic")


PADS = {
    "constant_last2": ([1, 2, 0, 1], dict(value=0.5)),
    "reflect": ([2, 1, 1, 2], dict(mode="reflect")),
    "replicate": ([1, 0, 2, 3], dict(mode="replicate")),
    "circular": ([1, 1, 2, 0], dict(mode="circular")),
    "every_dim": ([0, 0, 1, 0, 1, 1, 2, 0], {}),
    "nhwc": ([1, 2, 3, 0], dict(mode="reflect", data_format="NHWC")),
}


@pytest.mark.parametrize("case", list(PADS))
def test_pad(case):
    pad, kw = PADS[case]
    x = X_NHWC if kw.get("data_format") == "NHWC" else X
    tf.both(JF.pad, F.pad, [x, pad], [0], REL, **kw)


def test_pad_one_dim_of_a_3d_input():
    tf.both(JF.pad, F.pad, [tf.randn((2, 3, 6), 7), [2, 3]], [0], REL,
            mode="replicate", data_format="NCL")


@pytest.mark.parametrize("name,arrays,diff,kw", [
    ("linear", [tf.randn((4, 5), 8), tf.randn((5, 3), 9),
                tf.randn((3,), 10)], [0, 1, 2], {}),
    ("normalize", [X], [0], {}),
    ("normalize", [X], [0], {"p": 1, "axis": -1}),
    ("cosine_similarity", [tf.randn((4, 6), 11), tf.randn((4, 6), 12)],
     [0, 1], {}),
    ("cosine_similarity", [tf.randn((4, 6), 11), tf.randn((1, 6), 12)],
     [0, 1], {"axis": -1, "eps": 0.5}),
    ("label_smooth", [tf.randn((4, 6), 13)], [0], {"epsilon": 0.2}),
    ("pixel_shuffle", [tf.randn((2, 8, 3, 2), 14)], [0],
     {"upscale_factor": 2}),
    ("pixel_shuffle", [tf.randn((2, 3, 2, 8), 14)], [0],
     {"upscale_factor": 2, "data_format": "NHWC"}),
    ("pixel_unshuffle", [tf.randn((2, 2, 6, 4), 15)], [0],
     {"downscale_factor": 2}),
    ("pixel_unshuffle", [tf.randn((2, 6, 4, 2), 15)], [0],
     {"downscale_factor": 2, "data_format": "NHWC"}),
    ("channel_shuffle", [tf.randn((2, 6, 2, 3), 16)], [0], {"groups": 3}),
    ("channel_shuffle", [tf.randn((2, 2, 3, 6), 16)], [0],
     {"groups": 2, "data_format": "NHWC"}),
    ("bilinear", [tf.randn((4, 3), 17), tf.randn((4, 5), 18),
                  tf.randn((2, 3, 5), 19), tf.randn((2,), 20)],
     [0, 1, 2, 3], {}),
], ids=["linear", "normalize", "normalize_p1", "cosine", "cosine_bcast",
        "label_smooth", "pixel_shuffle", "pixel_shuffle_nhwc",
        "pixel_unshuffle", "pixel_unshuffle_nhwc", "channel_shuffle",
        "channel_shuffle_nhwc", "bilinear"])
def test_common_functions(name, arrays, diff, kw):
    tf.both(getattr(JF, name), getattr(F, name), arrays, diff, REL, **kw)


def test_label_smooth_with_a_prior():
    prior = np.full((1, 6), 1 / 6, np.float32) + tf.randn((1, 6), 21) / 50
    got = F.label_smooth(torch.from_numpy(tf.randn((4, 6), 13)),
                         torch.from_numpy(prior), 0.3).numpy()
    want = np.asarray(JF.label_smooth(JTensor(tf.randn((4, 6), 13)),
                                      JTensor(prior), 0.3)._value)
    tf.tl.close_to_scale(got, want, REL)


def test_embedding_one_hot_sequence_mask():
    ids = np.array([[0, 2, 4], [4, 1, 0]])
    w = tf.randn((5, 3), 22)
    tf.both(lambda i, wt, **k: JF.embedding(i, wt, **k),
            lambda i, wt, **k: F.embedding(i, wt, **k), [ids, w], [1], REL,
            padding_idx=4)
    np.testing.assert_array_equal(
        F.one_hot(torch.from_numpy(ids), 6).numpy(),
        np.asarray(JF.one_hot(JTensor(ids), 6)._value))
    assert F.one_hot(torch.from_numpy(ids), 6).dtype == torch.float32
    lengths = np.array([3, 0, 5])
    for kw in ({}, {"maxlen": 7, "dtype": "float32"}):
        got = F.sequence_mask(torch.from_numpy(lengths), **kw)
        want = np.asarray(JF.sequence_mask(JTensor(lengths), **kw)._value)
        np.testing.assert_array_equal(got.numpy(), want)
        assert str(got.dtype).split(".")[1] == str(want.dtype)


def _kept_fraction(out):
    return float((out != 0).mean())


def _fraction_within(frac, p_keep, n, what):
    err = np.sqrt(p_keep * (1 - p_keep) / n)
    assert abs(frac - p_keep) <= SIGMAS * err, (what, frac, p_keep)


def test_dropout_in_distribution():
    """Kept with probability 1 - p (both packages), kept values divided
    by it (``upscale_in_train``) or kept as they are
    (``downscale_in_infer``, which multiplies by 1 - p in inference)."""
    p, x = 0.3, np.abs(tf.randn((50, 80), 23)) + 0.1
    for mode in ("upscale_in_train", "downscale_in_infer"):
        got = F.dropout(torch.from_numpy(x), p, mode=mode).numpy()
        want = np.asarray(JF.dropout(JTensor(x), p, mode=mode)._value)
        scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
        for out, who in ((got, "port"), (want, "reference")):
            _fraction_within(_kept_fraction(out), 1 - p, x.size, who)
            kept = out != 0
            np.testing.assert_allclose(out[kept], x[kept] * scale,
                                       rtol=1e-6)
        inf = F.dropout(torch.from_numpy(x), p, training=False, mode=mode)
        want = JF.dropout(JTensor(x), p, training=False, mode=mode)
        np.testing.assert_allclose(inf.numpy(), np.asarray(want._value),
                                   rtol=1e-6)


@pytest.mark.parametrize("fn,shape,axes", [
    ("dropout", (40, 6, 5), [0]), ("dropout2d", (60, 8, 3, 2), [0, 1]),
    ("dropout3d", (60, 8, 2, 2, 2), [0, 1])])
def test_dropout_axis_shares_the_mask(fn, shape, axes):
    """One draw a position of the named axes, shared along the others."""
    x = np.abs(tf.randn(shape, 24)) + 0.1
    kw = {"axis": axes} if fn == "dropout" else {}
    for out, who in ((getattr(F, fn)(torch.from_numpy(x), 0.4, **kw)
                      .numpy(), "port"),
                     (np.asarray(getattr(JF, fn)(JTensor(x), 0.4, **kw)
                                 ._value), "reference")):
        kept = (out != 0).reshape(shape[:len(axes)] + (-1,))
        assert (kept.all(-1) | (~kept).all(-1)).all(), who
        _fraction_within(kept[..., 0].mean(), 0.6, kept[..., 0].size, who)


def test_alpha_dropout_in_distribution():
    """Dropped values become ``a * (-alpha * scale) + b``; on a standard
    normal input the output keeps mean 0 and variance 1 (within 5
    standard errors), in both packages."""
    p, x = 0.2, tf.randn((200, 100), 25)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = 1 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    got = F.alpha_dropout(torch.from_numpy(x), p).numpy()
    want = np.asarray(JF.alpha_dropout(JTensor(x), p)._value)
    for out, who in ((got, "port"), (want, "reference")):
        dropped = np.isclose(out, a * alpha_p + b, rtol=0, atol=1e-6)
        _fraction_within(1 - dropped.mean(), keep, x.size, who)
        assert abs(out.mean()) <= SIGMAS / np.sqrt(x.size), who
        assert abs(out.var() - 1) <= SIGMAS * np.sqrt(2 / x.size), who
    np.testing.assert_array_equal(
        F.alpha_dropout(torch.from_numpy(x), p, training=False).numpy(), x)


LAYERS = {
    "Identity": ((3, "any"), {}, [X]),
    "Flatten": ((), {}, [X]),
    "Flatten_axes": ((0, 2), {}, [X]),
    "Upsample": ((), {"scale_factor": 2, "mode": "bilinear"}, [X]),
    "UpsamplingBilinear2D": (([7, 9],), {}, [X]),
    "UpsamplingNearest2D": ((), {"scale_factor": 3}, [X]),
    "Pad1D": (([1, 2],), {"mode": "reflect"}, [tf.randn((2, 3, 6), 26)]),
    "Pad2D": (([1, 0, 2, 1],), {"value": -1.0}, [X]),
    "Pad3D": (([1, 1, 0, 2, 1, 0],), {"mode": "replicate"},
              [tf.randn((1, 2, 3, 4, 5), 27)]),
    "ZeroPad2D": (([2, 1, 0, 3],), {}, [X]),
    "PixelShuffle": ((2,), {}, [tf.randn((2, 8, 3, 2), 28)]),
    "PixelUnshuffle": ((2,), {}, [tf.randn((2, 2, 6, 4), 29)]),
    "ChannelShuffle": ((3,), {}, [tf.randn((2, 6, 2, 3), 30)]),
    "CosineSimilarity": ((), {"axis": 2}, [X, tf.randn(X.shape, 31)]),
    "Unfold": (([2, 3],), {"strides": 2, "paddings": 1}, [X]),
    "Dropout2D_eval": ((0.5,), {}, [X]),
    "Dropout3D_eval": ((0.5,), {}, [tf.randn((1, 2, 2, 3, 4), 32)]),
    "AlphaDropout_eval": ((0.5,), {}, [X]),
    "Dropout_eval": ((0.5,), {"mode": "downscale_in_infer"}, [X]),
}


@pytest.mark.parametrize("case", list(LAYERS))
def test_common_layers(case):
    args, kw, arrays = LAYERS[case]
    name = case.split("_")[0]
    jlayer, layer = getattr(jnn, name)(*args, **kw), \
        getattr(pnn, name)(*args, **kw)
    if case.endswith("_eval"):
        jlayer.eval()
        layer.eval()
    got, want = tf.layer_forward(jlayer, layer, *arrays)
    tf.tl.close_to_scale(got, want, REL, case)


def test_bilinear_layer_from_the_reference_weights():
    """Built with its weight drawn (XavierUniform, bias zeros), then the
    reference's carried across: forward and every grad."""
    fresh = pnn.Bilinear(3, 5, 2, device="cpu")
    assert tuple(fresh.weight.shape) == (2, 3, 5)
    assert fresh.weight.abs().max() > 0 and (fresh.bias == 0).all()
    jlayer = jnn.Bilinear(3, 5, 2)
    jlayer.bias.set_value(tf.randn((2,), 33))
    layer = tf.twin(jlayer, lambda: pnn.Bilinear(3, 5, 2, device="cpu"))
    x1, x2 = tf.randn((4, 3), 34), tf.randn((4, 5), 35)
    want = tf.tl.jax_loss_grads(jlayer, lambda o: o.sum(),
                                JTensor(jnp.asarray(x1)),
                                JTensor(jnp.asarray(x2)))
    got = tf.tl.torch_loss_grads(layer, lambda o: o.sum(),
                                 torch.from_numpy(x1), torch.from_numpy(x2))
    tf.tl.close_to_scale(got[1], want[1], REL)
    tf.tl.grads_close(got[2], want[2], REL)


def test_dropout_layers_draw_in_training():
    x = torch.from_numpy(np.abs(tf.randn((30, 8, 3, 3), 36)) + 0.1)
    for layer in (pnn.Dropout(0.5, axis=1), pnn.Dropout2D(0.5),
                  pnn.AlphaDropout(0.5)):
        layer.train()
        out = layer(x)
        assert not torch.equal(out, x) and out.shape == x.shape
