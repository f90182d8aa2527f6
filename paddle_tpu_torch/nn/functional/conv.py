"""The convolutions (``paddle_tpu/nn/functional/conv.py``): `conv1d`,
`conv2d`, `conv3d` and their transposes, weights OIHW (transposes ``[in,
out/groups, *k]``), every padding form of the reference's `_padding`
(an int, per dim, pairs, a flat 2n list, ``'SAME'``, ``'SAME_LOWER'``,
``'VALID'``: the string forms as XLA pads them, the odd pad on the high
side for SAME, explicitly since ``torch``'s ``padding='same'`` refuses
stride > 1) and the channel-last layouts. The reference computes them
with ``lax.conv_general_dilated`` outside any Pallas kernel; here
``torch.nn.functional.conv*d`` on explicitly padded inputs, the bias
added after the product as the reference adds it. A transpose gives
the reference's lhs-dilated conv (:88-136: zeros between the input
elements, per-side padding ``d*(k-1) - p`` with ``output_padding`` on
the high side, the kernel flipped, its groups side by side) as
``torch.nn.functional.conv_transpose*d`` unpadded, its output cropped
by ``p`` (less ``output_padding`` on the high side; a negative crop
pads with zeros).
"""
from __future__ import annotations

import torch

from ...core.dispatch import amp_cast


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _padding(padding, n):
    """The reference's padding forms (``conv.py:24-36``): a string
    (upper-cased), an int, ``n`` ints (one a dim), a flat ``2n`` list
    (low, high a dim) or ``n`` pairs -> the string or ``n`` (low, high)
    pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(p) for p in padding]


def _string_pads(mode, sizes, window, strides):
    """XLA's pads of a string padding (``lax.padtype_to_pads``): VALID
    none; SAME and SAME_LOWER the least total pad that gives
    ``ceil(size / stride)`` outputs, its odd unit on the high side
    (SAME) or the low side (SAME_LOWER)."""
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode not in ("SAME", "SAME_LOWER"):
        raise RuntimeError("Unrecognized padding type: expected 'VALID', "
                           f"'SAME', or 'SAME_LOWER', got {mode}.")
    pads = []
    for size, k, s in zip(sizes, window, strides):
        total = max(0, (-(-size // s) - 1) * s + k - size)
        low = total // 2 if mode == "SAME" else total - total // 2
        pads.append((low, total - low))
    return pads


def _pad_spatial(x, pads, value=0.0):
    """``x`` (channels first) padded with ``value`` by (low, high) a
    spatial dim; a negative pad crops."""
    flat = []
    for low, high in reversed(pads):
        flat += [low, high]
    return torch.nn.functional.pad(x, flat, value=value) if any(flat) else x


def _add_bias(out, bias):
    """The reference adds the bias after the product (a [C] vector on
    the channel dim, channels first here)."""
    if bias is None:
        return out
    return out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))


_CONV = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d,
         3: torch.nn.functional.conv3d}
_CONV_T = {1: torch.nn.functional.conv_transpose1d,
           2: torch.nn.functional.conv_transpose2d,
           3: torch.nn.functional.conv_transpose3d}


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             channel_last):
    x, weight, bias = amp_cast(f"conv{n}d", x, weight, bias)
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    pad = _padding(padding, n)
    if channel_last:
        x = x.movedim(-1, 1)
    if isinstance(pad, str):
        window = [d * (k - 1) + 1 for d, k in zip(dil, weight.shape[2:])]
        pad = _string_pads(pad, x.shape[2:], window, strides)
    out = _CONV[n](_pad_spatial(x, pad), weight, None, strides, 0, dil,
                   groups)
    out = _add_bias(out, bias)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """x ``[N, C, L]`` (``"NLC"``: ``[N, L, C]``); weight ``[O, C/groups,
    k]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format == "NLC")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """x ``[N, C, H, W]`` (``"NHWC"``: channels last); weight OIHW."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format == "NHWC")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """x ``[N, C, D, H, W]`` (``"NDHWC"``: channels last); weight
    OIDHW."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format == "NDHWC")


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, channel_last):
    x, weight, bias = amp_cast(f"conv{n}d_transpose", x, weight, bias)
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    pad, opad = _padding(padding, n), _tuple(output_padding, n)
    if channel_last:
        x = x.movedim(-1, 1)
    ks = weight.shape[2:]
    if isinstance(pad, str):
        # XLA refuses a string padding on an lhs-dilated conv
        if any(s != 1 for s in strides):
            raise ValueError(
                "String padding is not implemented for transposed "
                "convolution using this op. Please either exactly specify "
                "the required padding or use conv_transpose.")
        window = [d * (k - 1) + 1 for d, k in zip(dil, ks)]
        cfg = _string_pads(pad, x.shape[2:], window, strides)
    else:
        cfg = [(dil[i] * (ks[i] - 1) - pad[i][0],
                dil[i] * (ks[i] - 1) - pad[i][1] + opad[i])
               for i in range(n)]
    # the reference's conv of the lhs-dilated input padded by ``cfg``
    # with the flipped kernel is the transposed conv (weight [in,
    # out/g, *k], the groups' outputs side by side) of the input padded
    # by d*(k-1) a side, cropped or zero-padded by the difference
    out = _CONV_T[n](x, weight, None, strides, 0, 0, groups, dil)
    out = _pad_spatial(out, [(low - d * (k - 1), high - d * (k - 1))
                             for (low, high), d, k in zip(cfg, dil, ks)])
    out = _add_bias(out, bias)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """weight ``[C, O/groups, k]``; ``output_size`` is ignored, as in the
    reference."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format == "NLC")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """weight ``[C, O/groups, kh, kw]``; ``output_size`` is ignored."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format == "NHWC")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """weight ``[C, O/groups, kd, kh, kw]``; ``output_size`` is
    ignored."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format == "NDHWC")


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]
