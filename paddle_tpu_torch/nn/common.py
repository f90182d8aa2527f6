"""`Linear` and `Embedding` with paddle_tpu's parameter layouts and
defaults (``paddle_tpu/nn/common.py:25-67``), so that a ``paddle_tpu``
state dict loads key for key (`models.convert`). Their parameters are
drawn when they are built (`nn.Layer.create_parameter`); the models then
draw theirs again from a seed (`init_weights`). `Dropout` lives in
`nn.layer`."""
from __future__ import annotations

import torch

from .initializer import Normal, XavierUniform
from .layer import Layer
from .norm import LayerNorm


class Linear(Layer):
    """``y = x @ W + b`` with ``W [in, out]`` (paddle_tpu's layout,
    ``paddle_tpu/nn/functional/common.py:23``), instead of
    ``nn.Linear``'s ``[out, in]``. ``W`` XavierUniform, ``b`` zeros,
    unless the attrs say otherwise; ``bias_attr=False``: no bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


@torch.no_grad()
def _zero_row(weight, row):
    weight[row] = 0.0
    return weight


class Embedding(Layer):
    """Rows of ``weight [num_embeddings, embedding_dim]`` by id
    (``paddle_tpu/nn/functional/common.py:76-87``), drawn Normal(0, 1).
    ``padding_idx`` (negative counts from the end): that row starts at
    zero and every id equal to it looks up zeros (so the row gets no
    gradient). ``sparse`` is taken and ignored, as in the reference."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = None if padding_idx is None else (
            padding_idx if padding_idx >= 0
            else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if self._padding_idx is not None:
            if self.weight._init_fn is not None:
                draw, pidx = self.weight._init_fn, self._padding_idx
                self.weight._init_fn = lambda: _zero_row(draw(), pidx)
            else:
                _zero_row(self.weight, self._padding_idx)

    def forward(self, ids):
        ids = ids.long()
        out = torch.nn.functional.embedding(ids, self.weight)
        if self._padding_idx is not None:
            out = out.masked_fill((ids == self._padding_idx)[..., None], 0.0)
        return out

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


@torch.no_grad()
def init_weights(model, seed, std):
    """The models' random init, from a generator seeded with ``seed`` on
    the model's device: weights of every `Linear` and `Embedding` normal
    ``(0, std)``, their biases zero, LayerNorm scales one and shifts
    zero. A layer that holds raw parameters (the fused layers, the
    convolutions) lists its matrices in ``_init_normal`` (paths below
    it, as ``qkv_weights.0``); they are drawn by the same rule, and its
    biases and LayerNorm scales keep the values they were built with."""
    dev = next(iter(model.parameters())).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (Linear, Embedding)):
            mod.weight.normal_(0.0, std, generator=gen)
        for name in getattr(mod, "_init_normal", ()):
            mod.get_parameter(name).normal_(0.0, std, generator=gen)
        if isinstance(mod, Linear) and mod.bias is not None:
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            if mod.weight is not None:
                mod.weight.fill_(1.0)
            if mod.bias is not None:
                mod.bias.zero_()


__all__ = ["Linear", "Embedding", "init_weights"]
