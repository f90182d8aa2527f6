"""Transformer layers: `MultiHeadAttention` and `TransformerEncoderLayer`.

Counterpart: ``paddle_tpu/nn/transformer.py`` (``MultiHeadAttention``
:35-154, ``TransformerEncoderLayer`` :157-199). Attention takes the
reference's two branches under its own conditions:

- self-attention with no mask and a shape ``_qkv_direct_enabled`` takes
  (:95-124) runs one fused ``[h, 3h]`` projection into
  `kernels.flash_attention.flash_attention_qkv3`: on a card the
  which-major qkv3 kernels (ROADMAP B5) read that projection as it lies;
  on the CPU their plain version runs;
- everything else runs ``nn.functional.scaled_dot_product_attention``,
  which takes the general flash kernels where its gate does (a masked
  BERT on a card runs the Hopper kernels of ROADMAP B2).

The incremental-decode caches (``Cache``/``StaticCache``, ``gen_cache``),
``need_weights`` and the decoder layers are a later slice (ROADMAP A13)
and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention_qkv3, packed_supported
from . import functional as F
from .common import Linear
from .layer import Dropout
from .norm import LayerNorm


def _later(what):
    return NotImplementedError(f"{what} is a later slice (ROADMAP A13)")


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections (``W [in,
    out]``). ``use_flash`` (True, as the reference's sdpa default) lets
    attention take the flash branches; False runs the composition."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, *, device=None, dtype=None):
        super().__init__()
        if need_weights:
            raise _later("MultiHeadAttention(need_weights=True)")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.use_flash = True
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _qkv_direct_enabled(self, query, key, value, attn_mask):
        """The reference's gate of the qkv-direct branch (:95-124) with
        Pallas available: self-attention, no mask, ``0 <= dropout < 1``,
        ``S % 128 == 0`` and ``packed_supported`` (``S <= 2048``, D 64 or
        128, even head count)."""
        if (key is not None and key is not query) or (
                value is not None and value is not key
                and value is not query):
            return False
        if attn_mask is not None or not self.use_flash:
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
        """``[B, S, E]`` -> ``[B, S, E]``. ``attn_mask``: bool (True =
        attend) or additive, broadcastable to ``[B, H, Sq, Sk]``."""
        if cache is not None:
            raise _later("MultiHeadAttention(cache=...)")
        p = self.dropout if self.training else 0.0
        if self._qkv_direct_enabled(query, key, value, attn_mask):
            projs = (self.q_proj, self.k_proj, self.v_proj)
            w = torch.cat([m.weight for m in projs], dim=1)    # [h, 3h]
            qkv = query @ w + torch.cat([m.bias for m in projs])
            out = flash_attention_qkv3(qkv, self.num_heads, is_causal=False,
                                       dropout_p=p)
            return self.out_proj(out)
        key = query if key is None else key
        value = key if value is None else value
        b, s = query.shape[0], query.shape[1]
        q = self.q_proj(query).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, key.shape[1], self.num_heads,
                                     self.head_dim)
        v = self.v_proj(value).reshape(b, value.shape[1], self.num_heads,
                                       self.head_dim)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, use_flash=self.use_flash)
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-LN (``normalize_before=False``) or pre-LN encoder block:
    self-attention and a two-layer feed-forward, each with dropout and a
    residual. ``attn_dropout``/``act_dropout`` default to ``dropout``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, layer_norm_eps=1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise _later("TransformerEncoderLayer(cache=...)")
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer"]
