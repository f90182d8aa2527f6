"""The vision functions (``paddle_tpu/nn/functional/vision.py``).

- `affine_grid` (:16-32): ``theta [N, 2, 3]`` over the pixel centres of
  ``[-1, 1]``; ``align_corners`` defaults to True there (torch's to
  False), with the corner pixels at -1 and 1, otherwise their centres
  ``(2 i + 1) / size - 1``. float32 out.
- `grid_sample` (:35-101): ``x [N, C, H, W]`` at ``grid [N, Ho, Wo, 2]``
  (x, y) in ``[-1, 1]``, bilinear or nearest (``round`` halves to even);
  ``padding_mode`` ``"zeros"`` (outside taps count zero), ``"border"``
  (clamped), ``"reflection"`` (about the corner pixels with
  ``align_corners``, else about the half-pixel borders, then clamped);
  ``align_corners`` defaults to True.
- `fold` (col2im, the reference's scatter-add of ``[N, C*kh*kw, L]``,
  padding cropped) and `temporal_shift` (TSM: a ``shift_ratio`` of the
  channels one step back in time, as many one step forward, zeros at the
  ends; ``data_format`` taken and unused, as in the reference).
"""
from __future__ import annotations

import torch

from .conv import _tuple


def affine_grid(theta, out_shape, align_corners=True, name=None):
    n, c, h, w = (int(s) for s in out_shape)
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")            # [H, W]
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [H, W, 3]
    return torch.einsum("nij,hwj->nhwi", theta.float(), base.float())


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode must be 'bilinear' or 'nearest', got "
                         f"{mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"padding_mode must be 'zeros', 'border' or "
                         f"'reflection', got {padding_mode!r}")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2

    def reflect_corners(v, size):
        span = float(size - 1)
        if span <= 0.0:
            return torch.zeros_like(v)
        t = torch.remainder(v, 2.0 * span)
        return span - (t - span).abs()

    def reflect_half(v, size):
        m = torch.remainder((v + 0.5).abs(), 2.0 * size)
        t = float(size) - (m - float(size)).abs()
        return torch.clamp(t - 0.5, 0.0, float(size) - 1.0)

    if padding_mode == "reflection":
        reflect = reflect_corners if align_corners else reflect_half
        fx, fy = reflect(fx, w), reflect(fy, h)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        vals = x[batch, :, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        vals = vals.permute(0, 3, 1, 2)                  # [N, C, Ho, Wo]
        if padding_mode == "zeros":
            inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            vals = vals * inside[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return sample(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    wx = (fx - x0).to(x.dtype)[:, None]
    wy = (fy - y0).to(x.dtype)[:, None]
    return (sample(x0, y0) * (1 - wx) * (1 - wy)
            + sample(x0 + 1, y0) * wx * (1 - wy)
            + sample(x0, y0 + 1) * (1 - wx) * wy
            + sample(x0 + 1, y0 + 1) * wx * wy)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: ``[N, C*kh*kw, L]`` -> ``[N, C, H, W]``, overlapping taps
    summed."""
    return torch.nn.functional.fold(
        x, _tuple(output_sizes, 2), _tuple(kernel_sizes, 2),
        dilation=_tuple(dilations, 2), padding=_tuple(paddings, 2),
        stride=_tuple(strides, 2))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], 1)
    return torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)


__all__ = ["affine_grid", "grid_sample", "fold", "temporal_shift"]
