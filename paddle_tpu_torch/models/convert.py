"""Move weights between ``paddle_tpu`` and the port: GPT, BERT, ViT,
the encoder-decoder `nn.Transformer`, `incubate.nn.FusedMultiTransformer`
and `incubate.distributed.models.moe.MoELayer`.

`load_paddle_tpu_state_dict` loads a ``paddle_tpu`` state dict into the
port's model; `export_paddle_tpu_state_dict` is its inverse (the port's
parameters as numpy arrays under the reference's names).
`load_layer_state_dict` loads any reference `Layer`'s state dict,
parameters and persistable buffers (a batch norm's ``_mean`` and
``_variance``, a spectral norm's ``weight_u``/``weight_v``), into the
port's layer of the same structure (ResNet, the layers of `nn`).

The port keeps ``paddle_tpu``'s parameter names and layouts (``Linear``
weights stay ``[in, out]``, GPT's qkv columns stay pair-major, the fused
BERT layers keep ``qkv_weight [3, H, D, M]`` and ``ffn._ln1_scale``, ViT's
patch embedding its OIHW conv weight, `FusedMultiTransformer` one list a
weight kind, ``qkv_weights.0`` ..., and `MoELayer` ``gate.weight [M, E]``
with stacked experts ``experts.w1 [E, M, F]`` or listed ones
``experts.0.*``), so the conversion is a checked copy: every parameter
of the model must be in the state dict with its exact shape, and
nothing else may be, apart from GPT's per-layer ``qkv_layout``
markers. A tied parameter (BERT's
MLM decoder is its word embedding) is one tensor, listed once under its
first name in both packages, and is copied once.

A GPT ``qkv_layout`` marker (value 1) says the qkv columns are
pair-major. A state dict without it holds head-major columns
(``[q(H*d)|k|v]``, the layout of checkpoints saved before pair-major,
``gpt.py:766-795``); this loader refuses it instead of computing wrong
attention.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of its own dtype: float16 and
    float32 as they are, and the ``ml_dtypes`` bfloat16 the reference's
    bfloat16 parameters export as (numpy has no bfloat16 of its own) by
    its bits, without importing ``ml_dtypes``."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _gpt_layers(names) -> set:
    """Indices of the GPT decoder layers among parameter names."""
    return {int(n.split(".")[2]) for n in names if n.startswith("gpt.h.")}


def load_paddle_tpu_state_dict(model, arrays: dict):
    """Copy ``arrays`` (``paddle_tpu`` ``state_dict()`` as numpy arrays,
    keyed by name: float32, float16 or ``ml_dtypes`` bfloat16) into
    ``model`` (any of the families above), cast to the model's dtype on
    the model's device, so a float32 reference model loads into a
    float16 or bfloat16 port model and back. Returns ``model``."""
    arrays = dict(arrays)
    params = dict(model.named_parameters())
    for i in sorted(_gpt_layers(params)):
        key = f"gpt.h.{i}.attn.qkv_layout"
        marker = arrays.pop(key, None)
        if marker is None:
            raise ValueError(
                f"state dict has no '{key}' marker: its qkv columns are "
                "head-major, and this loader only takes pair-major "
                "checkpoints (repack them with paddle_tpu's "
                "repack_qkv_weight_to_pair_major first)")
        if int(np.asarray(marker)) != 1:
            raise ValueError(f"'{key}' = {int(np.asarray(marker))}: unknown "
                             "qkv layout (1 = pair-major)")
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise ValueError(f"state dict does not match the model: missing "
                         f"{missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != model "
                                 f"{tuple(p.shape)}")
            p.copy_(_tensor(a).to(device=p.device, dtype=p.dtype))
    return model


def export_paddle_tpu_state_dict(model_or_params) -> dict:
    """The port's parameters as numpy arrays under ``paddle_tpu``'s names,
    plus GPT's per-layer ``qkv_layout`` markers (1 = pair-major), so that
    `load_paddle_tpu_state_dict` (or paddle_tpu's ``set_state_dict``)
    takes them back. ``model_or_params``: a model, or a name -> tensor
    dict (a train step's params). bfloat16 values come out as float32
    (numpy has no bfloat16)."""
    params = (model_or_params if isinstance(model_or_params, dict)
              else dict(model_or_params.named_parameters()))
    layers = _gpt_layers(params)
    out = {}
    for name, t in params.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    for i in layers:
        out[f"gpt.h.{i}.attn.qkv_layout"] = np.asarray(1, np.int32)
    return out


def load_layer_state_dict(layer, arrays: dict):
    """Copy ``arrays`` (a reference `Layer`'s ``state_dict()`` as numpy
    arrays, keyed by name) into ``layer``'s parameters and persistable
    buffers, each cast to its own dtype on its own device, by name: every
    entry of ``layer.state_dict()`` must be there with its exact shape
    and nothing else may be (the convolutions' OIHW and `Linear`'s ``[in,
    out]`` are the reference's layouts). Returns ``layer``."""
    own = layer.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(arrays))
    unexpected = sorted(set(arrays) - set(own))
    if missing or unexpected:
        raise ValueError(f"state dict does not match the layer: missing "
                         f"{missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, target in own.items():
            a = np.asarray(arrays[name])
            if tuple(a.shape) != tuple(target.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} != layer "
                                 f"{tuple(target.shape)}")
            target.copy_(_tensor(a).to(device=target.device,
                                       dtype=target.dtype))
    return layer


__all__ = ["load_paddle_tpu_state_dict", "export_paddle_tpu_state_dict",
           "load_layer_state_dict"]
