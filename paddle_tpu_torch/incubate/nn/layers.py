"""Fused transformer layers.

Counterpart: ``paddle_tpu/incubate/nn/layers.py``. The parameters keep
the reference's names and layouts (``qkv_weight [3, H, D, M]``,
``linear_weight [M, M]``, ``ffn._ln1_scale`` ...), so a ``paddle_tpu``
state dict loads key for key (`models.convert`). A post-LN layer
(``normalize_before=False``, the default) never reads ``pre_ln_scale``,
``pre_ln_bias``, ``_ln1_scale`` or ``_ln1_bias``; they exist, as in the
reference, and train only through weight decay.

Parameters start uninitialised (matrices) or at their constants (biases
zero, LayerNorm scales one); `nn.init_weights` draws the matrices, by
the names each layer lists in ``_init_normal``.

`FusedMultiTransformer` keeps one ``nn.ParameterList`` a weight kind
(``qkv_weights.0``, ``ln_scales.0`` ...), the reference's names; it is
pre-LN only, and ``nranks > 1`` (heads and FFN split over a ring of
ranks) is a later slice (ROADMAP A12).
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn.layer import Dropout
from ...nn.norm import LayerNorm
from . import functional as IF


def _param(shape, fill, device, dtype):
    """A parameter of ``shape``: uninitialised (``fill`` None) or
    constant."""
    t = torch.empty(shape, device=device, dtype=dtype)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class FusedMultiHeadAttention(nn.Module):
    """Self-attention block of `functional.fused_multi_head_attention`
    (``layers.py:17-65``). ``use_flash`` (True) lets attention take the
    flash branches; False composes it. ``need_weights`` is taken and
    ignored, as in the reference; ``cache``: the functional's
    ``cache_kv``."""

    _init_normal = ("qkv_weight", "linear_weight")

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False, epsilon=1e-5,
                 *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self._epsilon = epsilon
        self.use_flash = True
        kw = dict(device=device, dtype=dtype)
        self.qkv_weight = _param((3, num_heads, self.head_dim, embed_dim),
                                 None, **kw)
        self.qkv_bias = _param((3, num_heads, self.head_dim), 0.0, **kw)
        self.linear_weight = _param((embed_dim, embed_dim), None, **kw)
        self.linear_bias = _param((embed_dim,), 0.0, **kw)
        self.pre_ln_scale = _param((embed_dim,), 1.0, **kw)
        self.pre_ln_bias = _param((embed_dim,), 0.0, **kw)
        self.ln_scale = _param((embed_dim,), 1.0, **kw)
        self.ln_bias = _param((embed_dim,), 0.0, **kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        return IF.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight,
            pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            pre_ln_epsilon=self._epsilon, qkv_bias=self.qkv_bias,
            linear_bias=self.linear_bias, cache_kv=cache,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self._epsilon, training=self.training,
            num_heads=self.num_heads, use_flash=self.use_flash)


class FusedFeedForward(nn.Module):
    """Feed-forward block of `functional.fused_feedforward`
    (``layers.py:68-112``); ``act_dropout_rate`` defaults to
    ``dropout_rate``."""

    _init_normal = ("linear1_weight", "linear2_weight")

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, *, device=None, dtype=None):
        super().__init__()
        self._d_model = d_model
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._act_method = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.linear1_weight = _param((d_model, dim_feedforward), None, **kw)
        self.linear1_bias = _param((dim_feedforward,), 0.0, **kw)
        self.linear2_weight = _param((dim_feedforward, d_model), None, **kw)
        self.linear2_bias = _param((d_model,), 0.0, **kw)
        self._ln1_scale = _param((d_model,), 1.0, **kw)
        self._ln1_bias = _param((d_model,), 0.0, **kw)
        self._ln2_scale = _param((d_model,), 1.0, **kw)
        self._ln2_bias = _param((d_model,), 0.0, **kw)

    def forward(self, src, cache=None):
        """``cache`` is ignored, as in the reference."""
        return IF.fused_feedforward(
            src, self.linear1_weight, self.linear2_weight,
            linear1_bias=self.linear1_bias, linear2_bias=self.linear2_bias,
            ln1_scale=self._ln1_scale, ln1_bias=self._ln1_bias,
            ln2_scale=self._ln2_scale, ln2_bias=self._ln2_bias,
            dropout1_rate=self._act_dropout_rate,
            dropout2_rate=self._dropout_rate,
            activation=self._act_method, ln1_epsilon=self._epsilon,
            ln2_epsilon=self._epsilon,
            pre_layer_norm=self._normalize_before, training=self.training)


class FusedTransformerEncoderLayer(nn.Module):
    """`FusedMultiHeadAttention` then `FusedFeedForward`
    (``layers.py:115-135``). ``attn_dropout_rate`` and
    ``act_dropout_rate`` default to ``dropout_rate``: unlike BERT's
    unfused layers (``act_dropout=0``), this drops activations too."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, dtype=None):
        super().__init__()
        attn_dropout_rate = (dropout_rate if attn_dropout_rate is None
                             else attn_dropout_rate)
        act_dropout_rate = (dropout_rate if act_dropout_rate is None
                            else act_dropout_rate)
        kw = dict(device=device, dtype=dtype)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=attn_dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask,
                                        cache=cache))


class FusedMultiTransformer(nn.Module):
    """N stacked pre-LN transformer blocks in one module, the serving
    stack with CacheKV decoding (``layers.py:138-241``):
    ``forward(src, attn_mask, caches, pre_caches, time_step)`` is
    `functional.fused_multi_transformer` over the layer's weights;
    `gen_cache` makes its caches. ``trans_qkvw``: qkv weights ``[3, H, D,
    M]`` (True) or ``[M, 3, H, D]``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 epsilon=1e-5, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None, *, device=None, dtype=None):
        super().__init__()
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN only")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if nranks and nranks > 1:
            raise NotImplementedError(
                f"FusedMultiTransformer(nranks={nranks}): heads and FFN "
                "split over a ring of ranks are a later slice (ROADMAP A12)")
        num_layers = 1 if num_layers < 0 else num_layers
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.normalize_before = normalize_before
        self._epsilon = epsilon
        self._trans_qkvw = trans_qkvw
        self.name = name
        kw = dict(device=device, dtype=dtype)

        def plist(shape, fill=None):
            return nn.ParameterList([_param(shape, fill, **kw)
                                     for _ in range(num_layers)])

        m, h, d, f = embed_dim, num_heads, self.head_dim, dim_feedforward
        self.ln_scales = plist((m,), 1.0)
        self.ln_biases = plist((m,), 0.0)
        self.qkv_weights = plist((3, h, d, m) if trans_qkvw else (m, 3, h, d))
        self.qkv_biases = plist((3, h, d), 0.0)
        self.linear_weights = plist((h * d, m))
        self.linear_biases = plist((m,), 0.0)
        self.ffn_ln_scales = plist((m,), 1.0)
        self.ffn_ln_biases = plist((m,), 0.0)
        self.ffn1_weights = plist((m, f))
        self.ffn1_biases = plist((f,), 0.0)
        self.ffn2_weights = plist((f, m))
        self.ffn2_biases = plist((m,), 0.0)
        self._init_normal = tuple(
            f"{kind}.{i}" for kind in ("qkv_weights", "linear_weights",
                                       "ffn1_weights", "ffn2_weights")
            for i in range(num_layers))

    def gen_cache(self, batch_size, max_seq_len, dtype=None):
        """One zeroed CacheKV buffer a layer, ``[2, batch, num_heads,
        max_seq_len, head_dim]``, in ``dtype`` (default the weights')
        on the weights' device."""
        w = self.qkv_weights[0]
        return [torch.zeros((2, batch_size, self.num_heads, max_seq_len,
                             self.head_dim), dtype=dtype or w.dtype,
                            device=w.device)
                for _ in range(self.num_layers)]

    def forward(self, src, attn_mask=None, caches=None, pre_caches=None,
                time_step=None):
        return IF.fused_multi_transformer(
            src, list(self.ln_scales), list(self.ln_biases),
            list(self.qkv_weights), list(self.qkv_biases),
            list(self.linear_weights), list(self.linear_biases),
            list(self.ffn_ln_scales), list(self.ffn_ln_biases),
            list(self.ffn1_weights), list(self.ffn1_biases),
            list(self.ffn2_weights), list(self.ffn2_biases),
            pre_layer_norm=self.normalize_before, epsilon=self._epsilon,
            cache_kvs=caches, pre_caches=pre_caches, time_step=time_step,
            attn_mask=attn_mask, dropout_rate=self.dropout_rate,
            activation=self.activation, training=self.training,
            trans_qkvw=self._trans_qkvw)


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``layer_norm(residual + dropout(x + bias))`` (``layers.py:
    244-261``)."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        self.linear_bias = _param((embed_dim,), 0.0, device, dtype)
        self.dropout = Dropout(dropout_rate)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon, device=device,
                            dtype=dtype)

    def forward(self, x, residual):
        return self.ln(residual + self.dropout(x + self.linear_bias))


__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]
