"""Fused transformer functionals.

Counterpart: ``paddle_tpu/incubate/nn/functional.py`` (:21-180). The
attention core runs the port's kernels under the reference's conditions:

- `fused_multi_head_attention` with no mask and no cache, at ``S % 128
  == 0`` and a shape `packed_supported` takes, shuffles ``qkv_weight [3,
  H, D, M]`` (and the bias) pair-major and runs the projection straight
  into `flash_attention_qkv` (B1 on a card). Otherwise it unpacks q, k
  and v and runs `nn.functional.scaled_dot_product_attention` (a masked
  batch: B2 on a card). ``use_flash=False`` (a knob of the port, as
  `nn.MultiHeadAttention.use_flash`) composes the attention instead;
- `_ln_maybe_fused` is the reference's entry of the fused (residual +)
  LayerNorm kernels (B6, `kernels.fused_ln`), with the reference's gate
  minus ``pallas_available`` (a CPU tensor runs the plain version). As in
  the reference, no layer calls it;
- `fused_feedforward`, `fused_bias_dropout_residual_layer_norm`,
  `fused_matmul_bias` and `fused_linear` are plain compositions, as the
  reference leaves them to XLA.

The incremental-decode cache (``cache_kv``) and `fused_multi_transformer`
(serving) are a later slice (ROADMAP A13) and raise.
"""
from __future__ import annotations

from ...kernels import fused_ln as _fl
from ...kernels.flash_attention import flash_attention_qkv, packed_supported
from ...nn import functional as F


def _later(what):
    return NotImplementedError(f"{what} is a later slice (ROADMAP A13)")


def _ln_maybe_fused(x, weight, bias, eps, residual=None):
    """LayerNorm of ``x`` (plus ``residual`` when given) over the last
    dim: through the fused kernels (`kernels.fused_ln`) when both affine
    parameters are given and the shape passes `fused_ln.supported`, else
    the composition ``layer_norm(residual + x)``."""
    m = int(x.shape[-1])
    if (weight is not None and bias is not None
            and _fl.supported(tuple(x.shape), m)):
        return _fl.fused_add_layer_norm(x, residual, weight, bias, eps)
    out = x if residual is None else residual + x
    return F.layer_norm(out, out.shape[-1:], weight, bias, eps)


def _pair_major_weight(qkv_weight):
    """``[3, H, D, M]`` -> ``[M, 3HD]`` with pair-major columns
    (``[pair: q|k|v]``, :83-86)."""
    three, h, d, m = qkv_weight.shape
    return (qkv_weight.reshape(3, h // 2, 2, d, m).permute(4, 1, 0, 2, 3)
            .reshape(m, 3 * h * d))


def _pair_major_bias(qkv_bias):
    """``[3, H, D]`` -> ``[3HD]`` in the same column order (:89-91)."""
    three, h, d = qkv_bias.shape
    return (qkv_bias.reshape(3, h // 2, 2, d).permute(1, 0, 2, 3)
            .reshape(3 * h * d))


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm=False, pre_ln_scale=None,
                               pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None,
                               linear_bias=None, cache_kv=None,
                               attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5,
                               training=True, num_heads=None, name=None,
                               use_flash=True):
    """x: ``[B, S, M]``; qkv_weight: ``[3, H, D, M]``; linear_weight:
    ``[M, M]``. Self-attention block: (pre-LN,) the qkv projection,
    attention with in-kernel dropout ``attn_dropout_rate``, the output
    projection, dropout ``dropout_rate``, the residual, (post-LN)."""
    if cache_kv is not None:
        raise _later("fused_multi_head_attention(cache_kv=...)")
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    three, h, d, m = qkv_weight.shape
    b, s = x.shape[0], x.shape[1]
    attn_p = attn_dropout_rate if training else 0.0
    if (use_flash and attn_mask is None and 0.0 <= attn_p < 1.0
            and s % 128 == 0 and packed_supported(s, s, h, d)):
        qkv = x @ _pair_major_weight(qkv_weight)               # [B,S,3HD]
        if qkv_bias is not None:
            qkv = qkv + _pair_major_bias(qkv_bias)
        ctx = flash_attention_qkv(qkv, h, is_causal=False, dropout_p=attn_p)
    else:
        qkv = x @ qkv_weight.reshape(3 * h * d, m).T
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(3 * h * d)
        qkv = qkv.reshape(b, s, 3, h, d)
        ctx = F.scaled_dot_product_attention(
            qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], attn_mask=attn_mask,
            dropout_p=attn_p, training=training, use_flash=use_flash)
    out = ctx.reshape(b, s, h * d) @ linear_weight
    if linear_bias is not None:
        out = out + linear_bias
    if training and dropout_rate > 0:
        out = F.dropout(out, dropout_rate, training=True)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln_scale, ln_bias,
                           ln_epsilon)
    return out


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True, name=None):
    """x: ``[B, S, M]``; linear1: ``[M, F]``; linear2: ``[F, M]``.
    Feed-forward block: (pre-LN with ln1,) linear1, activation, dropout1,
    linear2, dropout2, the residual, (post-LN with ln2)."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], ln1_scale, ln1_bias, ln1_epsilon)
    h = x @ linear1_weight
    if linear1_bias is not None:
        h = h + linear1_bias
    h = getattr(F, activation)(h)
    if training and dropout1_rate > 0:
        h = F.dropout(h, dropout1_rate, training=True)
    out = h @ linear2_weight
    if linear2_bias is not None:
        out = out + linear2_bias
    if training and dropout2_rate > 0:
        out = F.dropout(out, dropout2_rate, training=True)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, out.shape[-1:], ln2_scale, ln2_bias,
                           ln2_epsilon)
    return out


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y + bias``, either operand transposed over its last two
    dims."""
    out = (x.transpose(-1, -2) if transpose_x else x) @ (
        y.transpose(-1, -2) if transpose_y else y)
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """A linear layer through `fused_matmul_bias`."""
    return fused_matmul_bias(x, weight, bias, False, transpose_weight)


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True,
                                           mode="upscale_in_train",
                                           name=None):
    """``layer_norm(residual + dropout(x + bias))``. Only the
    ``upscale_in_train`` dropout is ported; ``downscale_in_infer`` is a
    later slice (ROADMAP A14) and raises."""
    if mode != "upscale_in_train":
        raise NotImplementedError(
            f"dropout mode {mode!r} is a later slice (ROADMAP A14)")
    h = x if bias is None else x + bias
    if training and dropout_rate > 0:
        h = F.dropout(h, dropout_rate, training=True)
    h = residual + h
    return F.layer_norm(h, h.shape[-1:], ln_scale, ln_bias, ln_epsilon)


def fused_multi_transformer(*args, **kwargs):
    """Serving's fused stack (``functional.py:225``): a later slice."""
    raise _later("fused_multi_transformer")


__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "fused_matmul_bias", "fused_linear",
           "fused_bias_dropout_residual_layer_norm",
           "fused_multi_transformer"]
