"""Transformer layers: `MultiHeadAttention` with its incremental-decode
caches, the encoder and decoder layers and stacks, and `Transformer`.

Counterpart: ``paddle_tpu/nn/transformer.py`` (``MultiHeadAttention``
:35-154, ``TransformerEncoderLayer`` :157-199, ``TransformerEncoder``
:202-227, ``TransformerDecoderLayer`` :229-293, ``TransformerDecoder``
:295-324, ``Transformer`` :326-366). Attention takes the reference's
two branches under its own conditions:

- self-attention with no mask, no cache, no ``need_weights`` and a
  shape ``_qkv_direct_enabled`` takes (:95-124) runs one fused ``[h,
  3h]`` projection into `kernels.flash_attention.flash_attention_qkv3`:
  on a card the which-major qkv3 kernels (ROADMAP B5) read that
  projection as it lies; on the CPU their plain version runs;
- everything else runs ``nn.functional.scaled_dot_product_attention``,
  which takes the general flash kernels where its gate does, by lengths
  and mask (a masked BERT, the decoder's causal self-attention under
  `Transformer.generate_square_subsequent_mask` and its cross-attention
  at lengths that are multiples of 128 run the Hopper kernels of ROADMAP
  B2 on a card); an incremental decode step (one query) composes.

``MultiHeadAttention.Cache`` holds the keys and values seen so far
(``gen_cache`` starts it empty; each call appends the step's);
``StaticCache`` holds keys and values computed once (cross-attention
over the encoder's memory). A call with a cache returns ``(out,
cache)``; with ``need_weights``, ``(out, None)``, as the reference
(the weights are not formed on the fused path). The empty ``Cache``
takes the key projection's dtype and device (the reference's is float32
whatever the model's: on a bfloat16 model it would promote the
attention to float32).

Every projection takes the reference's ``weight_attr`` and
``bias_attr`` (`ParamAttr`; ``bias_attr=False``: no biases, and the
qkv-direct branch then adds none, :133-134); the LayerNorms keep their
defaults. Parameters are drawn when the layers are built
(XavierUniform weights, zero biases, unit LayerNorm scales);
`nn.init_weights` draws the models' from a seed. The stacks deep-copy
their layer, as the reference does, so every copy starts from the same
weights.
"""
from __future__ import annotations

import collections
import copy

import torch

from ..core.dispatch import amp_cast
from ..kernels.flash_attention import flash_attention_qkv3, packed_supported
from . import functional as F
from .common import Linear
from .container import LayerList
from .layer import Dropout, Layer
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    """Multi-head attention with separate q/k/v/out projections (``W [in,
    out]``). ``use_flash`` (True, as the reference's sdpa default) lets
    attention take the flash branches; False runs the composition."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.use_flash = True
        kw = dict(device=device, dtype=dtype)
        attrs = (weight_attr, bias_attr)
        self.q_proj = Linear(embed_dim, embed_dim, *attrs, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, *attrs, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, *attrs, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, *attrs, **kw)

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        """q, k, v ``[B, S, H, D]`` and the cache to return (:55-70): a
        `StaticCache` gives k and v as they are; a `Cache` gets this
        call's k and v appended on the sequence dim."""
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k, v = self.compute_kv(key, value)
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def compute_kv(self, key, value):
        """The key and value projections, ``[B, S, H, D]`` each."""
        return self._heads(self.k_proj(key)), self._heads(self.v_proj(value))

    def gen_cache(self, key, value=None, type=None):
        """A `StaticCache` of ``key``'s (and ``value``'s) projections; a
        `Cache` of ``(key, value)`` as given; with no value an empty
        `Cache` (``[B, 0, H, D]``)."""
        if type is None:
            type = self.Cache
        if type == self.StaticCache:
            return self.StaticCache(*self.compute_kv(
                key, value if value is not None else key))
        if value is None:
            w = self.k_proj.weight
            empty = torch.zeros((key.shape[0], 0, self.num_heads,
                                 self.head_dim), dtype=w.dtype,
                                device=w.device)
            return self.Cache(empty, empty)
        return self.Cache(key, value)

    def _qkv_direct_enabled(self, query, key, value, attn_mask, cache=None):
        """The reference's gate of the qkv-direct branch (:95-124) with
        Pallas available: self-attention, no mask, no cache, no
        ``need_weights``, ``0 <= dropout < 1``, ``S % 128 == 0`` and
        ``packed_supported`` (``S <= 2048``, D 64 or 128, even head
        count)."""
        if (key is not None and key is not query) or (
                value is not None and value is not key
                and value is not query):
            return False
        if (attn_mask is not None or cache is not None or self.need_weights
                or not self.use_flash):
            return False
        if self.kdim != self.embed_dim or self.vdim != self.embed_dim:
            return False
        if not 0.0 <= self.dropout < 1.0:
            return False
        s = query.shape[1]
        return s % 128 == 0 and packed_supported(s, s, self.num_heads,
                                                 self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """``[B, S, E]`` -> ``[B, S, E]``, then ``None`` when
        ``need_weights`` and the cache when one is given, as a tuple.
        ``attn_mask``: bool (True = attend) or additive, broadcastable to
        ``[B, H, Sq, Sk]``."""
        if self._qkv_direct_enabled(query, key, value, attn_mask, cache):
            p = self.dropout if self.training else 0.0
            projs = (self.q_proj, self.k_proj, self.v_proj)
            w = torch.cat([m.weight for m in projs], dim=1)    # [h, 3h]
            # the reference's white-list ``matmul``, then a gray add of
            # the biases as they are: under O1 float32 biases promote qkv
            # back to float32 (:132-135)
            qkv = torch.matmul(*amp_cast("matmul", query, w))
            if all(m.bias is not None for m in projs):
                qkv = qkv + torch.cat([m.bias for m in projs])
            out = flash_attention_qkv3(qkv, self.num_heads, is_causal=False,
                                       dropout_p=p)
            return self.out_proj(out)
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, use_flash=self.use_flash)
        b, s = out.shape[0], out.shape[1]
        outs = [self.out_proj(out.reshape(b, s, self.embed_dim))]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return outs[0] if len(outs) == 1 else tuple(outs)


class TransformerEncoderLayer(Layer):
    """Post-LN (``normalize_before=False``) or pre-LN encoder block:
    self-attention and a two-layer feed-forward, each with dropout and a
    residual. ``attn_dropout``/``act_dropout`` default to ``dropout``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        attrs = (weight_attr, bias_attr)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        """``src`` ``[B, S, E]``; with a ``cache`` (`gen_cache`),
        ``(out, new cache)``."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        """An empty `MultiHeadAttention.Cache` for ``src``'s batch."""
        return self.self_attn.gen_cache(src)


def _clones(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it (:205-207)."""
    return LayerList([layer if i == 0 else copy.deepcopy(layer)
                      for i in range(num_layers)])


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer``, then ``norm`` if
    given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(encoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        """With ``cache`` (a list, one a layer), ``(out, new caches)``."""
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, new_cache = layer(output, src_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention (``tgt_mask``), cross-attention over ``memory``
    (``memory_mask``) and a two-layer feed-forward, each with dropout and
    a residual, post-LN or pre-LN. ``attn_dropout``/``act_dropout``
    default to ``dropout``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None):
        super().__init__(dtype=dtype, device=device)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        attrs = (weight_attr, bias_attr)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(
            d_model, nhead, dropout=attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, *attrs, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, *attrs, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """With ``cache`` (`gen_cache`: the self-attention's `Cache` and
        the cross-attention's `StaticCache`), ``(out, new cache)``."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                static_cache))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and the
        cross-attention's keys and values of ``memory``."""
        incremental_cache = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static_cache = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental_cache, static_cache


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer``, then ``norm`` if
    given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _clones(decoder_layer, num_layers)
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """With ``cache`` (a list, one a layer), ``(out, new caches)``."""
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = layer(output, memory, tgt_mask,
                                          memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        """One `TransformerDecoderLayer.gen_cache` a layer; ``do_zip``:
        transposed, ``[(incremental caches), (static caches)]``."""
        cache = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            cache = list(zip(*cache))
        return cache


class Transformer(Layer):
    """The encoder-decoder Transformer (Vaswani et al. 2017; the defaults
    are its base model): ``forward(src, tgt, src_mask, tgt_mask,
    memory_mask)`` runs the encoder over ``src`` and the decoder over
    ``tgt`` and the encoder's memory. Pre-LN stacks end in a LayerNorm.
    The layers take embeddings, not tokens."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype, device=device)
        kw = dict(device=device, dtype=dtype)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            encoder_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            encoder_norm = (LayerNorm(d_model, **kw) if normalize_before
                            else None)
            self.encoder = TransformerEncoder(encoder_layer,
                                              num_encoder_layers,
                                              encoder_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            decoder_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr, **kw)
            decoder_norm = (LayerNorm(d_model, **kw) if normalize_before
                            else None)
            self.decoder = TransformerDecoder(decoder_layer,
                                              num_decoder_layers,
                                              decoder_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    def generate_square_subsequent_mask(self, length):
        """The causal mask ``[length, length]``, float32 on the model's
        device: 0 on and below the diagonal, -inf above it."""
        dev = next(iter(self.parameters())).device
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=dev).tril()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return torch.where(keep, zero, zero - float("inf"))


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
