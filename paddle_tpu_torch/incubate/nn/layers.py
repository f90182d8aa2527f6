"""Fused transformer layers.

Counterpart: ``paddle_tpu/incubate/nn/layers.py``. The parameters keep
the reference's names and layouts (``qkv_weight [3, H, D, M]``,
``linear_weight [M, M]``, ``ffn._ln1_scale`` ...), so a ``paddle_tpu``
state dict loads key for key (`models.convert`). A post-LN layer
(``normalize_before=False``, the default) never reads ``pre_ln_scale``,
``pre_ln_bias``, ``_ln1_scale`` or ``_ln1_bias``; they exist, as in the
reference, and train only through weight decay.

Parameters are drawn when the layers are built, each through
`nn.Layer.create_parameter` with the reference's attr arguments
(``qkv_weight_attr`` ...; a list a layer for `FusedMultiTransformer`)
and defaults: matrices XavierUniform, biases zeros, LayerNorm scales
one. `nn.init_weights` draws the matrices again from a seed, by the
names each layer lists in ``_init_normal``.

`FusedMultiTransformer` keeps one `nn.ParameterList` a weight kind
(``qkv_weights.0``, ``ln_scales.0`` ...), the reference's names; it is
pre-LN only, and ``nranks > 1`` (heads and FFN split over a ring of
ranks) is a later slice (ROADMAP A12).
"""
from __future__ import annotations

import torch

from ...nn.container import ParameterList
from ...nn.initializer import Constant
from ...nn.layer import Dropout, Layer
from ...nn.norm import LayerNorm
from . import functional as IF


class FusedMultiHeadAttention(Layer):
    """Self-attention block of `functional.fused_multi_head_attention`
    (``layers.py:17-65``). ``use_flash`` (True) lets attention take the
    flash branches; False composes it. ``need_weights`` is taken and
    ignored, as in the reference; ``cache``: the functional's
    ``cache_kv``."""

    _init_normal = ("qkv_weight", "linear_weight")

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
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
        ones = Constant(1.0)
        self.qkv_weight = self.create_parameter(
            [3, num_heads, self.head_dim, embed_dim], attr=qkv_weight_attr)
        self.qkv_bias = self.create_parameter(
            [3, num_heads, self.head_dim], attr=qkv_bias_attr, is_bias=True)
        self.linear_weight = self.create_parameter(
            [embed_dim, embed_dim], attr=linear_weight_attr)
        self.linear_bias = self.create_parameter(
            [embed_dim], attr=linear_bias_attr, is_bias=True)
        self.pre_ln_scale = self.create_parameter(
            [embed_dim], attr=pre_ln_scale_attr, default_initializer=ones)
        self.pre_ln_bias = self.create_parameter(
            [embed_dim], attr=pre_ln_bias_attr, is_bias=True)
        self.ln_scale = self.create_parameter(
            [embed_dim], attr=ln_scale_attr, default_initializer=ones)
        self.ln_bias = self.create_parameter(
            [embed_dim], attr=ln_bias_attr, is_bias=True)

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


class FusedFeedForward(Layer):
    """Feed-forward block of `functional.fused_feedforward`
    (``layers.py:68-112``); ``act_dropout_rate`` defaults to
    ``dropout_rate``."""

    _init_normal = ("linear1_weight", "linear2_weight")

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self._d_model = d_model
        self._dropout_rate = dropout_rate
        self._act_dropout_rate = (dropout_rate if act_dropout_rate is None
                                  else act_dropout_rate)
        self._act_method = activation
        self._normalize_before = normalize_before
        self._epsilon = epsilon
        ones = Constant(1.0)
        self.linear1_weight = self.create_parameter(
            [d_model, dim_feedforward], attr=linear1_weight_attr)
        self.linear1_bias = self.create_parameter(
            [dim_feedforward], attr=linear1_bias_attr, is_bias=True)
        self.linear2_weight = self.create_parameter(
            [dim_feedforward, d_model], attr=linear2_weight_attr)
        self.linear2_bias = self.create_parameter(
            [d_model], attr=linear2_bias_attr, is_bias=True)
        self._ln1_scale = self.create_parameter(
            [d_model], attr=ln1_scale_attr, default_initializer=ones)
        self._ln1_bias = self.create_parameter(
            [d_model], attr=ln1_bias_attr, is_bias=True)
        self._ln2_scale = self.create_parameter(
            [d_model], attr=ln2_scale_attr, default_initializer=ones)
        self._ln2_bias = self.create_parameter(
            [d_model], attr=ln2_bias_attr, is_bias=True)

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


class FusedTransformerEncoderLayer(Layer):
    """`FusedMultiHeadAttention` then `FusedFeedForward`
    (``layers.py:115-135``). ``attn_dropout_rate`` and
    ``act_dropout_rate`` default to ``dropout_rate``: unlike BERT's
    unfused layers (``act_dropout=0``), this drops activations too."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
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


class FusedMultiTransformer(Layer):
    """N stacked pre-LN transformer blocks in one module, the serving
    stack with CacheKV decoding (``layers.py:138-241``):
    ``forward(src, attn_mask, caches, pre_caches, time_step)`` is
    `functional.fused_multi_transformer` over the layer's weights;
    `gen_cache` makes its caches. ``trans_qkvw``: qkv weights ``[3, H, D,
    M]`` (True) or ``[M, 3, H, D]``."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 ln_scale_attrs=None, ln_bias_attrs=None,
                 qkv_weight_attrs=None, qkv_bias_attrs=None,
                 linear_weight_attrs=None, linear_bias_attrs=None,
                 ffn_ln_scale_attrs=None, ffn_ln_bias_attrs=None,
                 ffn1_weight_attrs=None, ffn1_bias_attrs=None,
                 ffn2_weight_attrs=None, ffn2_bias_attrs=None,
                 epsilon=1e-5, num_layers=-1, nranks=1, trans_qkvw=True,
                 ring_id=-1, name=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN only")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if nranks and nranks > 1:
            raise NotImplementedError(
                f"FusedMultiTransformer(nranks={nranks}): heads and FFN "
                "split over a ring of ranks are a later slice (ROADMAP A12)")
        if num_layers < 0:
            num_layers = (len(qkv_weight_attrs)
                          if isinstance(qkv_weight_attrs, (list, tuple))
                          else 1)
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

        def plist(shape, attrs, is_bias=False, ones=False):
            return ParameterList([self.create_parameter(
                shape, attr=attrs[i] if isinstance(attrs, (list, tuple))
                else attrs, is_bias=is_bias,
                default_initializer=Constant(1.0) if ones else None)
                for i in range(num_layers)])

        m, h, d, f = embed_dim, num_heads, self.head_dim, dim_feedforward
        self.ln_scales = plist([m], ln_scale_attrs, ones=True)
        self.ln_biases = plist([m], ln_bias_attrs, is_bias=True)
        self.qkv_weights = plist([3, h, d, m] if trans_qkvw else [m, 3, h, d],
                                 qkv_weight_attrs)
        self.qkv_biases = plist([3, h, d], qkv_bias_attrs, is_bias=True)
        self.linear_weights = plist([h * d, m], linear_weight_attrs)
        self.linear_biases = plist([m], linear_bias_attrs, is_bias=True)
        self.ffn_ln_scales = plist([m], ffn_ln_scale_attrs, ones=True)
        self.ffn_ln_biases = plist([m], ffn_ln_bias_attrs, is_bias=True)
        self.ffn1_weights = plist([m, f], ffn1_weight_attrs)
        self.ffn1_biases = plist([f], ffn1_bias_attrs, is_bias=True)
        self.ffn2_weights = plist([f, m], ffn2_weight_attrs)
        self.ffn2_biases = plist([m], ffn2_bias_attrs, is_bias=True)
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


class FusedBiasDropoutResidualLayerNorm(Layer):
    """``layer_norm(residual + dropout(x + bias))`` (``layers.py:
    244-261``)."""

    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None,
                 bias_attr=None, epsilon=1e-5, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.linear_bias = self.create_parameter([embed_dim], attr=bias_attr,
                                                 is_bias=True)
        self.dropout = Dropout(dropout_rate)
        self.ln = LayerNorm(embed_dim, epsilon=epsilon,
                            weight_attr=weight_attr, device=device,
                            dtype=dtype)

    def forward(self, x, residual):
        return self.ln(residual + self.dropout(x + self.linear_bias))


__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]
