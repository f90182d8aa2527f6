"""Pooling (``paddle_tpu/nn/functional/pooling.py``), as the reference's
``lax.reduce_window`` computes it:

- every padding form of ``_update_padding_nd`` (an int, ``n`` ints,
  ``2n`` flat ints, ``n`` pairs, the ``n + 2`` nested layout form, or
  ``"SAME"`` / ``"VALID"``);
- ``ceil_mode`` pads the high side until a partial window gives an
  output (:95-106), whether or not that window starts in the input;
- max pooling pads with -inf (the least integer for integer inputs):
  the input is padded explicitly, then pooled unpadded;
- average pooling sums in float32; ``exclusive`` (with any padding)
  divides by the count of elements that are not padding, otherwise by
  the window's size (:117-131); ``divisor_override`` is taken and
  ignored, as in the reference (ROADMAP C.3);
- ``return_mask`` gives `max_pool_with_mask`'s indices, flattened over
  the unpadded spatial dims (channels-last computed channels-first and
  moved back);
- the adaptive pools reshape and reduce a dim whose size the output
  divides, and otherwise reduce ``[floor(i * in / out), ceil((i + 1) *
  in / out))`` windows (:204-245), means in float32; the max ones take
  channels first whatever is asked and ignore ``return_mask``, as in
  the reference (ROADMAP C.3).
"""
from __future__ import annotations

import math

import torch

from .common import _at_least_f32
from .conv import _pad_spatial, _tuple

_MAX = {1: torch.nn.functional.max_pool1d, 2: torch.nn.functional.max_pool2d,
        3: torch.nn.functional.max_pool3d}
_AVG = {2: torch.nn.functional.avg_pool2d, 3: torch.nn.functional.avg_pool3d}


def _resolve_str_padding(x, padding, k, s, n, channel_last, ceil_mode):
    """``"VALID"``: no pad (not with ``ceil_mode``); ``"SAME"``: the least
    pad that gives ``ceil(in / stride)`` outputs, split low/high."""
    mode = padding.upper()
    off = 1 if channel_last else 2
    if mode == "VALID":
        if ceil_mode:
            raise ValueError(
                'padding="VALID" does not compose with ceil_mode=True '
                "(reference pooling contract)")
        return [(0, 0)] * n
    if mode == "SAME":
        pads = []
        for i in range(n):
            size = int(x.shape[off + i])
            total = max(0, (-(-size // s[i]) - 1) * s[i] + k[i] - size)
            pads.append((total // 2, total - total // 2))
        return pads
    raise ValueError(
        f'string padding must be "SAME" or "VALID", got {padding!r}')


def _normalize_padding(padding, n, channel_last):
    """Non-string padding -> ``n`` spatial (low, high) pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * n
    p = list(padding)
    nested = bool(p) and isinstance(p[0], (list, tuple))
    if not nested:
        p = [int(q) for q in p]
        if len(p) == n:
            return [(q, q) for q in p]
        if len(p) == 2 * n:
            return [(p[2 * i], p[2 * i + 1]) for i in range(n)]
        raise ValueError(
            f"flat padding {padding!r} must have {n} or {2 * n} entries")
    p = [list(q) if isinstance(q, (list, tuple)) else [int(q), int(q)]
         for q in p]
    if len(p) == n + 2:
        spatial = p[1:-1] if channel_last else p[2:]
        dropped = [p[0], p[-1]] if channel_last else p[:2]
        if any(v != 0 for q in dropped for v in q):
            raise ValueError(
                "non-zero padding on the batch/channel dims is invalid "
                f"(got {padding!r})")
        p = spatial
    elif len(p) != n:
        raise ValueError(f"padding {padding!r} does not match {n} spatial "
                         "dims")
    return [(int(q[0]), int(q[1])) for q in p]


def _window(x, kernel, stride, padding, n, channel_last, ceil_mode):
    """``(k, s, pads)``: the window, the strides and the (low, high) pads
    a spatial dim, the high side extended for ``ceil_mode``."""
    k = _tuple(kernel, n)
    s = k if stride is None else _tuple(stride, n)
    if isinstance(padding, str):
        p = _resolve_str_padding(x, padding, k, s, n, channel_last,
                                 ceil_mode)
    else:
        p = _normalize_padding(padding, n, channel_last)
    if ceil_mode:
        off = 1 if channel_last else 2
        for i in range(n):
            padded = x.shape[off + i] + p[i][0] + p[i][1]
            out = -(-(padded - k[i]) // s[i]) + 1
            extra = max(0, (out - 1) * s[i] + k[i] - padded)
            p[i] = (p[i][0], p[i][1] + extra)
    return k, s, p


def _sum_pool(v, k, s, n):
    """The window sums of ``v`` (channels first, unpadded)."""
    if n == 1:
        return _AVG[2](v.unsqueeze(-2), (1,) + k, (1,) + s,
                       divisor_override=1).squeeze(-2)
    return _AVG[n](v, k, s, divisor_override=1)


def _pool_nd(x, kernel, stride, padding, n, channel_last, op,
             ceil_mode=False, exclusive=True):
    k, s, p = _window(x, kernel, stride, padding, n, channel_last,
                      ceil_mode)
    v = x.movedim(-1, 1) if channel_last else x
    if op == "max":
        if v.is_floating_point():
            out = _MAX[n](_pad_spatial(v, p, -math.inf), k, s)
        else:       # integers: the least value pads, the max is exact
            low = torch.iinfo(v.dtype).min
            out = _MAX[n](_pad_spatial(v.double(), p, float(low)), k, s)
            out = out.to(v.dtype)
    else:
        v32 = _at_least_f32(v)
        total = _sum_pool(_pad_spatial(v32, p, 0.0), k, s, n)
        if exclusive and any(a or b for a, b in p):
            ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v32.dtype,
                              device=v.device)
            out = total / _sum_pool(_pad_spatial(ones, p, 0.0), k, s, n)
        else:
            out = total / float(math.prod(k))
        out = out.to(v.dtype)
    return out.movedim(1, -1) if channel_last else out


def max_pool_with_mask(x, kernel_size, stride=None, padding=0, nd=2,
                       ceil_mode=False):
    """``(out, mask)`` of a channels-first max pool: ``mask`` holds each
    window's argmax (its first largest element) as an int32 index into
    the flattened unpadded spatial dims (``paddle_tpu/nn/functional/
    extra.py:84-133``). ``padding``: an int, ``nd`` ints or ``nd``
    (low, high) pairs."""
    k = _tuple(kernel_size, nd)
    s = _tuple(stride, nd) if stride is not None else k
    if (isinstance(padding, (list, tuple)) and padding
            and isinstance(padding[0], (list, tuple))):
        plo = [int(a) for a, _ in padding]
        phi = [int(b) for _, b in padding]
    else:
        plo = list(_tuple(padding, nd))
        phi = list(plo)
    spatial = x.shape[2:]
    out_sp = []
    for i in range(nd):
        num = spatial[i] + plo[i] + phi[i] - k[i]
        out_sp.append((-(-num // s[i]) if ceil_mode else num // s[i]) + 1)
    pads = [(plo[i], phi[i] + max(0, (out_sp[i] - 1) * s[i] + k[i]
                                   - (spatial[i] + plo[i] + phi[i])))
            for i in range(nd)]
    vp = _pad_spatial(_at_least_f32(x), pads, -math.inf)
    for i in range(nd):            # windows: [N, C, *out_sp, *k]
        vp = vp.unfold(2 + i, k[i], s[i]).narrow(2 + i, 0, out_sp[i])
    flat = vp.reshape(tuple(vp.shape[:2 + nd]) + (-1,))
    out, arg = flat.max(dim=-1)
    idx = torch.zeros_like(arg)
    rest = arg
    for i in reversed(range(nd)):  # window argmax -> unpadded coordinates
        coord = rest % k[i]
        rest = rest // k[i]
        grid = torch.arange(out_sp[i], device=x.device) * s[i]
        shape = [1] * arg.dim()
        shape[2 + i] = -1
        pos = grid.reshape(shape) + coord - plo[i]
        stride_i = math.prod(spatial[i + 1:])
        idx = idx + pos * stride_i
    return out.to(x.dtype), idx.to(torch.int32)


def _maybe_masked(x, kernel_size, stride, padding, nd, channel_last,
                  ceil_mode, return_mask):
    if not return_mask:
        return _pool_nd(x, kernel_size, stride, padding, nd, channel_last,
                        "max", ceil_mode)
    if isinstance(padding, str):
        k = _tuple(kernel_size, nd)
        s = k if stride is None else _tuple(stride, nd)
        padding = _resolve_str_padding(x, padding, k, s, nd, channel_last,
                                       ceil_mode)
    else:
        padding = _normalize_padding(padding, nd, channel_last)
    if channel_last:
        out, mask = max_pool_with_mask(x.movedim(-1, 1), kernel_size, stride,
                                       padding, nd=nd, ceil_mode=ceil_mode)
        return out.movedim(1, -1), mask.movedim(1, -1)
    return max_pool_with_mask(x, kernel_size, stride, padding, nd=nd,
                              ceil_mode=ceil_mode)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _maybe_masked(x, kernel_size, stride, padding, 1,
                         data_format == "NLC", ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _maybe_masked(x, kernel_size, stride, padding, 2,
                         data_format == "NHWC", ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _maybe_masked(x, kernel_size, stride, padding, 3,
                         data_format == "NDHWC", ceil_mode, return_mask)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool_nd(x, kernel_size, stride, padding, 1, data_format == "NLC",
                    "avg", ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 2,
                    data_format == "NHWC", "avg", ceil_mode, exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool_nd(x, kernel_size, stride, padding, 3,
                    data_format == "NDHWC", "avg", ceil_mode, exclusive)


def _adaptive_pool(x, output_size, n, channel_last, op):
    off = 1 if channel_last else 2
    out = x
    for i, size in enumerate(_tuple(output_size, n)):
        ax = off + i
        in_s = out.shape[ax]
        if in_s % size == 0:
            r = out.reshape(tuple(out.shape[:ax]) + (size, in_s // size)
                            + tuple(out.shape[ax + 1:]))
            out = (r.amax(dim=ax + 1) if op == "max"
                   else _at_least_f32(r).mean(dim=ax + 1).to(x.dtype))
        else:
            segs = []
            for j in range(size):
                st, en = (j * in_s) // size, -(-((j + 1) * in_s) // size)
                seg = out.narrow(ax, st, en - st)
                segs.append(seg.amax(dim=ax, keepdim=True) if op == "max"
                            else _at_least_f32(seg).mean(
                                dim=ax, keepdim=True).to(x.dtype))
            out = torch.cat(segs, dim=ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, False, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, data_format == "NHWC", "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, data_format == "NDHWC", "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 1, False, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 2, False, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_pool(x, output_size, 3, False, "max")


__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_pool_with_mask"]
