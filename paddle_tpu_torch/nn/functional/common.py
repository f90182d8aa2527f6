"""The common functions (``paddle_tpu/nn/functional/common.py``).

- `mt_attention_core` is the torch copy of
  ``paddle_tpu/incubate/nn/functional.py:200-222`` ``_mt_attention_core``,
  with its numerics kept exactly: scores in the query dtype divided by
  ``sqrt(head_dim)`` taken in that dtype, masking with
  ``finfo(float32).min / 2``, softmax in float32, then a cast back to the
  query dtype before ``P . V``. The engine's prefill attention runs here
  (the JAX package computes it outside any Pallas kernel too).
- `scaled_dot_product_attention` is ``:258-310``: with ``use_flash`` and
  a shape and mask the gate takes (`kernels.flash_attention_enabled`),
  the general flash kernels (`kernels.flash_attention.flash_attention`:
  the Hopper kernels on a card, their plain version on the CPU);
  otherwise the composition: scores in the query dtype times
  ``1/sqrt(D)``, a causal or boolean mask at ``-1e9``, softmax in float32
  cast back, dropout on the probabilities.
- the dropouts (``:31-69``): `dropout` with the reference's ``axis``
  (one draw shared along the other dims) and ``mode``
  (``upscale_in_train``, ``downscale_in_infer``), `dropout2d`,
  `dropout3d`, `alpha_dropout` (SELU's constants). Random draws come
  from an explicit `torch.Generator`: the argument, or the current one
  of `core.random`; they match the reference in distribution only.
- `linear` (``x @ W + b``, ``W [in, out]``), `embedding`, `one_hot`
  (float32), `label_smooth`, `normalize`, `cosine_similarity` (the
  product of the two norms clamped, not each norm), `bilinear`,
  `sequence_mask`.
- `pad` (``paddle_tpu/ops/manip.py:212-234``): ``2 * ndim`` entries pad
  every dim in order; fewer pad the last (NC*) or the first (N*C) spatial
  dims, each (before, after) pair in dim order; ``reflect``,
  ``replicate`` and ``circular`` gather numpy's ``pad`` indices.
- `unfold` (im2col, ``[N, C*kh*kw, L]``), `pixel_shuffle`,
  `pixel_unshuffle`, `channel_shuffle`.
- `interpolate` / `upsample` (``:145-197``): without ``align_corners``,
  ``jax.image.resize``'s rule (half-pixel centres; ``nearest`` floors
  ``(i + 0.5) * in / out`` in float32; ``linear``, ``bilinear``,
  ``trilinear`` and ``area`` a triangle kernel and ``bicubic`` Keys'
  cubic at a = -0.5, both widened by ``in / out`` when downsampling and
  renormalised at the borders), one weight matrix a resized dim; with
  ``align_corners``, linear interpolation between ``linspace(0, in - 1,
  out)`` neighbours whatever the mode but ``nearest``. ``align_mode``
  is taken and ignored, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as _random
from ...core.dispatch import amp_cast
from ...kernels import flash_attention_enabled
from .conv import _tuple


def _at_least_f32(x):
    """``x`` in float32 for the reference's float32 math; a float64
    ``x`` stays float64 (the reference would round it to float32: a
    documented deviation, ROADMAP C.3)."""
    return x if x.dtype == torch.float64 else x.float()


def _torch_dtype(dtype):
    """A dtype name of the reference (``"int64"``, ``"bfloat16"``) or a
    torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(np.dtype(dtype)) if not isinstance(dtype, str)
                   else dtype)


def mt_attention_core(q, keys, vals, head_dim, extra_logits=None,
                      valid_mask=None):
    """softmax(Q K^T / sqrt(d) [+ extra_logits]) V over head-major
    tensors.

    q ``[B, H, S, D]``; keys/vals ``[B, H, L, D]``; ``extra_logits``
    (broadcastable to ``[B, H, S, L]``) is added to the float32 scores,
    the reference's additive mask; ``valid_mask`` (bool, broadcastable
    to ``[B, H, S, L]``) excludes False positions. Returns ``[B, S,
    H*D]``."""
    # made on the device (a fill), so that a captured graph may hold it
    scale = torch.full((), float(head_dim), dtype=q.dtype,
                       device=q.device).sqrt()
    scores = torch.einsum("bhsd,bhld->bhsl", q, keys) / scale
    s32 = scores.float()
    if extra_logits is not None:
        s32 = s32 + extra_logits.float()
    if valid_mask is not None:
        neg = torch.finfo(torch.float32).min / 2
        s32 = s32.masked_fill(~valid_mask, neg)
    w = torch.softmax(s32, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhsl,bhld->bhsd", w, vals)
    b, h, s, d = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h * d)


def linear(x, weight, bias=None, name=None):
    """``x @ W (+ b)`` with ``W [in, out]`` (AMP: ``linear``, casting
    x, W and b)."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    y = x @ weight
    return y if bias is None else y + bias


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, *, generator=None):
    """Dropout: keep with probability ``1 - p``. ``upscale_in_train``
    divides the kept values by it while training (identity otherwise);
    ``downscale_in_infer`` keeps them as they are while training and
    multiplies by ``1 - p`` in inference. ``axis``: the dims that draw
    their own bits (the mask is shared along the others)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    keep = 1.0 - p
    gen = generator or _random.current_generator(x.device)
    shape = x.shape
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(x.shape)]
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    kept = x / keep if mode == "upscale_in_train" else x
    return torch.where(mask, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One draw a (sample, channel) map."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped value becomes ``-alpha * scale``, then
    ``a * v + b`` keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha, scale = 1.6732632423543772, 1.0507009873554805
    alpha_p = -alpha * scale
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    gen = _random.current_generator(x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return (a * torch.where(mask, x, x.new_full((), alpha_p)) + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` by id; ids equal to ``padding_idx`` look up
    zeros."""
    ids = x.long()
    out = torch.nn.functional.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows (no gradient)."""
    return torch.nn.functional.one_hot(x.long(), num_classes).float()


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    norm = (x.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = (x1 * x2).sum(dim=axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


_PAD_MODES = {"constant": "constant", "reflect": "reflect",
              "replicate": "edge", "circular": "wrap"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    p = [int(q) for q in (pad.tolist() if isinstance(pad, torch.Tensor)
                          else pad)]
    if len(p) == 2 * x.dim():
        widths = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    else:
        n_spatial = len(p) // 2
        widths = [(0, 0)] * x.dim()
        if data_format.startswith("N") and data_format.endswith("C"):
            dims = list(range(1, 1 + n_spatial))
        else:
            dims = list(range(x.dim() - n_spatial, x.dim()))
        for i, d in enumerate(dims):
            widths[d] = (p[2 * i], p[2 * i + 1])
    np_mode = _PAD_MODES[mode]
    if np_mode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[d]), (lo, hi), mode=np_mode)
            x = x.index_select(d, torch.from_numpy(idx).to(x.device))
    return x


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C, H, W]`` -> ``[N, C*kh*kw, L]``, channels outer,
    then the kernel's rows and columns (the reference's order)."""
    return torch.nn.functional.unfold(
        x, _tuple(kernel_sizes, 2), dilation=_tuple(dilations, 2),
        padding=_tuple(paddings, 2), stride=_tuple(strides, 2))


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(m, n, kernel):
    """``jax.image.resize``'s ``[m, n]`` weights of one dim resized from
    ``m`` to ``n`` (``compute_weight_mat`` with antialiasing, float64)."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = kernel(np.abs(sample[None, :] - np.arange(m)[:, None])
               / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


def _nearest_index(m, n):
    """``jax.image.resize``'s nearest source rows (float32 offsets)."""
    off = (np.arange(n, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(m) / np.float32(n)
    return np.floor(off.astype(np.float32)).astype(np.int64)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    channel_last = data_format.endswith("C")
    n_sp = x.dim() - 2
    first = 1 if channel_last else 2
    spatial = x.shape[first:first + n_sp]
    if size is not None:
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out_spatial = tuple(int(s.item() if isinstance(s, torch.Tensor)
                                else s) for s in sizes)
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        out_spatial = tuple(int(s * f) for s, f in zip(spatial, sf))
    method = {"nearest": "nearest", "bilinear": "linear",
              "linear": "linear", "trilinear": "linear",
              "bicubic": "cubic", "area": "linear"}[mode]
    out = x
    for i, (m, n) in enumerate(zip(spatial, out_spatial)):
        d = first + i
        if method == "nearest":
            if m != n:
                idx = torch.from_numpy(_nearest_index(m, n))
                out = out.index_select(d, idx.to(x.device))
        elif not align_corners:
            if m != n:
                w = _resize_weights(m, n, _triangle if method == "linear"
                                    else _keys_cubic)
                w = torch.from_numpy(w).to(device=x.device, dtype=x.dtype)
                out = torch.tensordot(out, w, dims=([d], [0])).movedim(-1, d)
        else:
            pos = (np.zeros((1,), np.float64) if n == 1
                   else np.linspace(0.0, m - 1, n))
            lo = np.floor(pos).astype(np.int64)
            hi = np.minimum(lo + 1, m - 1)
            shape = [1] * out.dim()
            shape[d] = -1
            w_hi = torch.from_numpy(pos - lo).to(device=x.device,
                                                 dtype=x.dtype).reshape(shape)
            out = (out.index_select(d, torch.from_numpy(lo).to(x.device))
                   * (1 - w_hi)
                   + out.index_select(d, torch.from_numpy(hi).to(x.device))
                   * w_hi)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
        return x.reshape(n, c, h, w)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(n, h, w, c)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] . W[o] . x2[b] (+ bias[o])``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_flash=True,
                                 generator=None):
    """Attention over ``[B, S, H, D]`` tensors (paddle layout) -> ``[B,
    Sq, H, D]``. ``attn_mask``: bool (True = attend) or additive,
    broadcastable to ``[B, H, Sq, Sk]``. The causal mask is bottom-right
    aligned. Dropout applies only when ``training``. With ``use_flash``
    and what the flash gate takes, the flash kernels run (AMP: the gray
    op ``flash_attention``, in the dtype its inputs have); otherwise the
    composition (AMP: ``sdpa``, casting q, k and v, not the mask)."""
    # B2's entry is read from the package when called, so that a caller
    # that wraps ``nn.functional.flash_attention`` (to count its calls)
    # is the one that runs
    from . import flash_attention as flash

    eff_p = dropout_p if training else 0.0
    if use_flash and flash_attention_enabled(query, key, attn_mask, eff_p):
        return flash(query, key, value, is_causal=is_causal,
                     attn_mask=attn_mask, dropout_p=eff_p,
                     generator=generator)
    query, key, value = amp_cast("sdpa", query, key, value)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (
        1.0 / math.sqrt(query.shape[-1]))
    neg = scores.new_full((), -1e9)      # a fill: no copy from the host
    if is_causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((s_q, s_k), dtype=torch.bool,
                         device=scores.device).tril(s_k - s_q)
        scores = torch.where(tri, scores, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg)
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, generator=generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2)


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: position < length (``maxlen`` defaults to the
    largest length)."""
    m = maxlen or int(lengths.max())
    mask = torch.arange(m, device=lengths.device) < lengths[..., None]
    return mask.to(_torch_dtype(dtype))


__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "normalize",
           "cosine_similarity", "pad", "unfold", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "bilinear",
           "scaled_dot_product_attention", "mt_attention_core",
           "sequence_mask"]
