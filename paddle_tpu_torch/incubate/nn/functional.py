"""Fused transformer functionals.

Counterpart: ``paddle_tpu/incubate/nn/functional.py`` (:21-180). The
attention core runs the port's kernels under the reference's conditions:

- `fused_multi_head_attention` with no mask and no cache, at ``S % 128
  == 0`` and a shape `packed_supported` takes, shuffles ``qkv_weight [3,
  H, D, M]`` (and the bias) pair-major and runs the projection straight
  into `flash_attention_qkv` (B1 on a card). Otherwise it unpacks q, k
  and v and runs `nn.functional.scaled_dot_product_attention` (a masked
  batch: B2 on a card). ``use_flash=False`` (a knob of the port, as
  `nn.MultiHeadAttention.use_flash`) composes the attention instead.
  With ``cache_kv`` (``[2, B, L, H, D]``: the keys and values seen so
  far) the step's keys and values are appended to it and attention runs
  over all of them; the updated cache is not returned, as in the
  reference (:104-106);
- `fused_multi_transformer` (:225-404) is the serving stack: N pre-LN
  (or post-LN) blocks from flat weight lists, qkv weights ``[3, H, D,
  M]`` (``trans_qkvw=False``: ``[M, 3, H, D]``) contracted by einsum,
  attention composed (`nn.functional.mt_attention_core`, float32
  softmax, as the reference composes it outside any Pallas kernel), in
  three modes: no cache; prefill (``cache_kvs``, one ``[2, B, H,
  max_len, D]`` a layer, and ``pre_caches``, a prefix of C positions
  each): the prompt's keys and values written at ``[0, C + S)``, causal
  attention over them unless ``attn_mask`` is given; decode
  (``time_step``, seq_len 1): the step's keys and values written at
  ``time_step``, attention over ``[0, time_step]`` (plus ``attn_mask``
  over the cache axis). The caches are updated in place and returned
  (the JAX package returns new arrays: under ``jit`` with donated
  buffers, the same in-place update);
- `_ln_maybe_fused` is the reference's entry of the fused (residual +)
  LayerNorm kernels (B6, `kernels.fused_ln`), with the reference's gate
  minus ``pallas_available`` (a CPU tensor runs the plain version). As in
  the reference, no layer calls it;
- `fused_feedforward`, `fused_bias_dropout_residual_layer_norm`,
  `fused_matmul_bias` and `fused_linear` are plain compositions, as the
  reference leaves them to XLA.

Every product the reference computes with ``ops.matmul`` (the
projections of `fused_multi_head_attention` and `fused_feedforward`,
`fused_matmul_bias`) is the port's `ops.matmul`, so it casts under
`amp.auto_cast` as the reference's does.
"""
from __future__ import annotations

import torch

from ...kernels import fused_ln as _fl
from ...kernels.flash_attention import flash_attention_qkv, packed_supported
from ... import ops
from ...nn import functional as F


def _dropout_mode(mode):
    """Only the ``upscale_in_train`` dropout is ported; another mode
    raises (ROADMAP A14)."""
    if mode != "upscale_in_train":
        raise NotImplementedError(
            f"dropout mode {mode!r} is a later slice (ROADMAP A14)")


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
    projection, dropout ``dropout_rate``, the residual, (post-LN).
    ``cache_kv``: keys and values ``[2, B, L, H, D]`` that this call's
    attend after (its own are appended)."""
    residual = x
    if pre_layer_norm:
        x = F.layer_norm(x, x.shape[-1:], pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    three, h, d, m = qkv_weight.shape
    b, s = x.shape[0], x.shape[1]
    attn_p = attn_dropout_rate if training else 0.0
    if (use_flash and cache_kv is None and attn_mask is None
            and 0.0 <= attn_p < 1.0 and s % 128 == 0
            and packed_supported(s, s, h, d)):
        qkv = ops.matmul(x, _pair_major_weight(qkv_weight))    # [B,S,3HD]
        if qkv_bias is not None:
            qkv = qkv + _pair_major_bias(qkv_bias)
        ctx = flash_attention_qkv(qkv, h, is_causal=False, dropout_p=attn_p)
    else:
        qkv = ops.matmul(x, qkv_weight.reshape(3 * h * d, m).T)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias.reshape(3 * h * d)
        qkv = qkv.reshape(b, s, 3, h, d)
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        if cache_kv is not None:
            k = torch.cat([cache_kv[0], k], dim=1)
            v = torch.cat([cache_kv[1], v], dim=1)
        ctx = F.scaled_dot_product_attention(
            qkv[:, :, 0], k, v, attn_mask=attn_mask, dropout_p=attn_p,
            training=training, use_flash=use_flash)
    out = ops.matmul(ctx.reshape(b, s, h * d), linear_weight)
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
    h = ops.matmul(x, linear1_weight)
    if linear1_bias is not None:
        h = h + linear1_bias
    h = getattr(F, activation)(h)
    if training and dropout1_rate > 0:
        h = F.dropout(h, dropout1_rate, training=True)
    out = ops.matmul(h, linear2_weight)
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
    dims (the product is `ops.matmul`, cast under AMP)."""
    out = ops.matmul(x, y, transpose_x=transpose_x, transpose_y=transpose_y)
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
    _dropout_mode(mode)
    h = x if bias is None else x + bias
    if training and dropout_rate > 0:
        h = F.dropout(h, dropout_rate, training=True)
    h = residual + h
    return F.layer_norm(h, h.shape[-1:], ln_scale, ln_bias, ln_epsilon)


def _mt_qkv(h, w, b):
    """One fused-MT layer's projection (:207-222): ``[B, S, M]`` x ``[3,
    H, D, M]`` (plus ``b [3, H, D]``) -> q, k, v ``[B, H, S, D]``, as one
    product over the three parts."""
    three, heads, d, m = w.shape
    qkv = h @ w.reshape(three * heads * d, m).T
    if b is not None:
        qkv = qkv + b.reshape(three * heads * d)
    return qkv.reshape(*h.shape[:2], three, heads, d).permute(2, 0, 3, 1, 4)


def _check_time_step(x, cache_kvs, time_step):
    """The reference's validations (:261-276): decode needs caches and
    one token, and ``time_step`` inside the cache (read on the host: one
    small copy)."""
    if cache_kvs is None:
        raise ValueError("fused_multi_transformer: time_step requires "
                         "cache_kvs")
    if x.shape[1] != 1:
        raise ValueError(
            "fused_multi_transformer: decode stage (time_step set) expects "
            f"seq_len 1, got {x.shape[1]}")
    t = torch.as_tensor(time_step, device=x.device).reshape(())
    max_len = cache_kvs[0].shape[3]
    if int(t) >= max_len:
        raise ValueError(f"fused_multi_transformer: time_step {int(t)} is "
                         f"out of range for cache max_seq_len {max_len}")
    return t


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases,
                            linear_weights, linear_biases, ffn_ln_scales,
                            ffn_ln_biases, ffn1_weights, ffn1_biases,
                            ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, pre_caches=None,
                            time_step=None, attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False,
                            mode="upscale_in_train", trans_qkvw=True,
                            ring_id=-1, name=None):
    """N blocks from flat weight lists (the functional form of
    `layers.FusedMultiTransformer`). Returns ``out``, or with
    ``cache_kvs`` ``(out, cache_kvs)`` (updated in place). ``time_step``:
    an int or a tensor of one element. ``attn_mask``: additive, on the
    float32 scores (broadcastable to ``[B, H, S, L]``)."""
    use_cache = cache_kvs is not None
    decode = time_step is not None
    t = _check_time_step(x, cache_kvs, time_step) if decode else None
    if training and dropout_rate > 0:
        _dropout_mode(mode)
    out = x
    for i in range(len(qkv_weights)):
        residual = out
        h = (F.layer_norm(out, out.shape[-1:], ln_scales[i], ln_biases[i],
                          epsilon) if pre_layer_norm else out)
        qkv_w = qkv_weights[i]
        if not trans_qkvw:
            qkv_w = qkv_w.permute(1, 2, 3, 0)          # [M,3,H,D] -> [3,H,D,M]
        head_dim = qkv_w.shape[2]
        q, k, v = _mt_qkv(h, qkv_w, None if qkv_biases is None
                          else qkv_biases[i])
        if not use_cache:
            attn = F.mt_attention_core(q, k, v, head_dim,
                                       extra_logits=attn_mask)
        elif decode:
            cache = cache_kvs[i]
            # the step's keys and values at column t: [2, B, H, 1, D]
            cache.index_copy_(3, t.reshape(1).long(),
                              torch.stack([k, v]).to(cache.dtype))
            valid = torch.arange(cache.shape[3], device=t.device) <= t
            attn = F.mt_attention_core(
                q, cache[0].to(h.dtype), cache[1].to(h.dtype), head_dim,
                extra_logits=attn_mask, valid_mask=valid[None, None, None])
        else:
            cache = cache_kvs[i]
            c, s = 0, k.shape[2]
            if pre_caches is not None:
                prev = pre_caches[i]
                c = prev.shape[3]
                k = torch.cat([prev[0].to(k.dtype), k], dim=2)
                v = torch.cat([prev[1].to(v.dtype), v], dim=2)
            cache[:, :, :, :c + s] = torch.stack([k, v]).to(cache.dtype)
            valid = None
            if attn_mask is None:
                # causal over the C + S keys: query i sees the whole
                # prefix and the keys j - c <= i
                qi = torch.arange(s, device=k.device)[:, None]
                kj = torch.arange(c + s, device=k.device)[None, :]
                valid = (kj - c <= qi)[None, None]
            attn = F.mt_attention_core(q, k, v, head_dim,
                                       extra_logits=attn_mask,
                                       valid_mask=valid)
        attn = fused_matmul_bias(attn, linear_weights[i],
                                 None if linear_biases is None
                                 else linear_biases[i])
        if training and dropout_rate > 0:
            attn = F.dropout(attn, dropout_rate, training=True)
        out = residual + attn
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], ln_scales[i],
                               ln_biases[i], epsilon)
        residual = out
        h = (F.layer_norm(out, out.shape[-1:], ffn_ln_scales[i],
                          ffn_ln_biases[i], epsilon)
             if pre_layer_norm else out)
        h = fused_matmul_bias(h, ffn1_weights[i], None if ffn1_biases is None
                              else ffn1_biases[i])
        h = getattr(F, activation)(h)
        if training and dropout_rate > 0:
            h = F.dropout(h, dropout_rate, training=True)
        h = fused_matmul_bias(h, ffn2_weights[i], None if ffn2_biases is None
                              else ffn2_biases[i])
        out = residual + h
        if not pre_layer_norm:
            out = F.layer_norm(out, out.shape[-1:], ffn_ln_scales[i],
                               ffn_ln_biases[i], epsilon)
    return (out, cache_kvs) if use_cache else out


__all__ = ["fused_multi_head_attention", "fused_feedforward",
           "fused_matmul_bias", "fused_linear",
           "fused_bias_dropout_residual_layer_norm",
           "fused_multi_transformer"]
