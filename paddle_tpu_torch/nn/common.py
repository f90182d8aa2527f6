"""`Linear` and `Embedding` with paddle_tpu's parameter layouts
(``paddle_tpu/nn/common.py``), so that a ``paddle_tpu`` state dict loads
key for key (`models.convert`). `Dropout` lives in `nn.layer`. Their
parameters start uninitialised; the models draw them from a seeded
generator."""
from __future__ import annotations

import torch
from torch import nn

from .norm import LayerNorm


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W [in, out]`` (paddle_tpu's layout,
    ``paddle_tpu/nn/functional/common.py:23``), instead of
    ``nn.Linear``'s ``[out, in]``."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return x @ self.weight + self.bias


class Embedding(nn.Module):
    """Rows of ``weight [num_embeddings, embedding_dim]`` by id
    (``paddle_tpu/nn/functional/common.py:76-87``)."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


@torch.no_grad()
def init_weights(model, seed, std):
    """The models' random init, from a generator seeded with ``seed`` on
    the model's device: weights of every `Linear` and `Embedding` normal
    ``(0, std)``, their biases zero, LayerNorm scales one and shifts
    zero. A layer that holds raw parameters (the fused layers, the
    convolutions) lists its matrices in ``_init_normal`` (paths below
    it, as ``qkv_weights.0``); they are drawn by the same rule, and its
    biases and LayerNorm scales keep the zeros and ones they were built
    with."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (Linear, Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
        for name in getattr(mod, "_init_normal", ()):
            mod.get_parameter(name).normal_(0.0, std, generator=gen)
        if isinstance(mod, Linear):
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


__all__ = ["Linear", "Embedding", "init_weights"]
