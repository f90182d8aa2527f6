"""The normalisations (``paddle_tpu/nn/functional/norm.py``), each in
float32 whatever the input's dtype and cast back (a float64 input stays
float64, ROADMAP C.3).

- `layer_norm` (:19-39) over the last ``len(normalized_shape)`` dims.
- `rms_norm` (:42-52) over the last dim.
- `batch_norm` (:55-107): the channel on dim 1 for an ``"NC*"``
  ``data_format``, else last. Running statistics serve when
  ``use_global_stats`` says so, else when not ``training``; otherwise the
  batch's mean and its BIASED variance normalise (gradients flow through
  both) and update the buffers in place, outside autograd, with the
  reference's momentum convention ``running = m * running + (1 - m) *
  batch`` (m = 0.9 by default): the reverse of torch's, whose own update
  would also take the unbiased variance. So `torch.nn.functional.
  batch_norm` normalises with no running statistics (the reference's
  XLA batch norm is no Pallas kernel either) and the update reads the
  batch's ``var_mean``.
- `instance_norm` (:110-132), `group_norm` (:135-170; channels first or
  last) and `local_response_norm` (:173-188: ``alpha`` not divided by
  ``size``, the window ``size // 2`` below and the rest above) compose
  their statistics.
"""
from __future__ import annotations

import torch

from ...core.dispatch import amp_cast
from .common import _at_least_f32


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the last ``len(normalized_shape)`` dims in float32,
    cast back to x's dtype; ``weight``/``bias`` may be None."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    return torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon).to(x.dtype)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    x, weight = amp_cast("rms_norm", x, weight)
    v = _at_least_f32(x)
    out = v * torch.rsqrt(v.square().mean(dim=-1, keepdim=True) + epsilon)
    if weight is not None:
        out = out * weight.to(v.dtype)
    return out.to(x.dtype)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.to(out.dtype).reshape(shape)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    # AMP: ``batch_norm`` casts the running statistics too where they are
    # read, not where the batch's update writes them
    if use_stats:
        x, running_mean, running_var, weight, bias = amp_cast(
            "batch_norm", x, running_mean, running_var, weight, bias)
    else:
        x, weight, bias = amp_cast("batch_norm", x, weight, bias)
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    v = _at_least_f32(x).movedim(ch_axis, 1)
    w = None if weight is None else weight.to(v.dtype)
    b = None if bias is None else bias.to(v.dtype)
    if use_stats:
        out = torch.nn.functional.batch_norm(
            v, running_mean.to(v.dtype), running_var.to(v.dtype), w, b,
            False, 0.0, epsilon)
    else:
        out = torch.nn.functional.batch_norm(v, None, None, w, b, True, 0.0,
                                             epsilon)
        with torch.no_grad():
            dims = [d for d in range(v.dim()) if d != 1]
            var, mean = torch.var_mean(v, dim=dims, correction=0)
            running_mean.copy_(momentum * running_mean
                               + (1 - momentum) * mean)
            running_var.copy_(momentum * running_var
                              + (1 - momentum) * var)
    return out.movedim(1, ch_axis).to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each sample's channel normalised over its spatial dims (the
    running statistics and ``use_input_stats`` are taken and unused, as
    in the reference)."""
    x, weight, bias = amp_cast("instance_norm", x, weight, bias)
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    spatial = [d for d in range(1, x.dim()) if d != ch_axis]
    v = _at_least_f32(x)
    var, mean = torch.var_mean(v, dim=spatial, keepdim=True, correction=0)
    out = (v - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    return _affine(out, weight, bias, shape).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    v = _at_least_f32(x)
    n = x.shape[0]
    shape = [1] * x.dim()
    if data_format == "NCHW" or x.dim() == 2:
        c = x.shape[1]
        g = v.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
        dims = list(range(2, g.dim()))
        shape[1] = c
    else:
        c = x.shape[-1]
        g = v.reshape((n,) + tuple(x.shape[1:-1])
                      + (num_groups, c // num_groups))
        dims = list(range(1, g.dim() - 2)) + [g.dim() - 1]
        shape[-1] = c
    var, mean = torch.var_mean(g, dim=dims, keepdim=True, correction=0)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, shape).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    ch_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    v = _at_least_f32(x)
    sq = v.square()
    c, half = x.shape[ch_axis], size // 2
    pads = [0, 0] * x.dim()
    pads[2 * (x.dim() - 1 - ch_axis)] = half
    pads[2 * (x.dim() - 1 - ch_axis) + 1] = size - half - 1
    padded = torch.nn.functional.pad(sq, pads)
    acc = sum(padded.narrow(ch_axis, i, c) for i in range(size))
    return (v / (k + alpha * acc) ** beta).to(x.dtype)


__all__ = ["layer_norm", "rms_norm", "batch_norm", "instance_norm",
           "group_norm", "local_response_norm"]
