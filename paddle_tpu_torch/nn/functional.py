"""Functional pieces the GPT and BERT slices need.

- `mt_attention_core` is the torch copy of
  ``paddle_tpu/incubate/nn/functional.py:200-222`` ``_mt_attention_core``,
  with its numerics kept exactly: scores in the query dtype divided by
  ``sqrt(head_dim)`` taken in that dtype, masking with
  ``finfo(float32).min / 2``, softmax in float32, then a cast back to the
  query dtype before ``P . V``. The engine's prefill attention runs here
  (the JAX package computes it outside any Pallas kernel too).
- `scaled_dot_product_attention` is ``paddle_tpu/nn/functional/
  common.py:258-310``: with ``use_flash`` and a shape and mask the gate
  takes (`kernels.flash_attention_enabled`), the general flash kernels
  (`kernels.flash_attention.flash_attention`: the Hopper kernels on a
  card, their plain version on the CPU); otherwise the composition:
  scores in the query dtype times ``1/sqrt(D)``, a causal or boolean
  mask at ``-1e9``, softmax in float32 cast back, dropout on the
  probabilities.
- `gelu` (exact erf by default, ``activation.py:31``) and `relu`.
- `layer_norm` (``nn/functional/norm.py:19-39``): statistics and affine
  in float32 whatever the input dtype, the result cast back.
- `dropout` (``common.py:31``, upscale_in_train) and `cross_entropy`
  (``nn/functional/loss.py:27-93``, hard labels to the fused
  softmax-CE of `kernels.fused_ce` on the reference's conditions).
  Random draws come from an explicit `torch.Generator`: the argument,
  or the current one of `core.random`.
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random
from ..kernels import flash_attention_enabled
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_ce import softmax_ce_logits


def gelu(x, approximate=False):
    """GELU, exact (erf) unless ``approximate`` (tanh)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    return torch.relu(x)


def mt_attention_core(q, keys, vals, head_dim, valid_mask=None):
    """softmax(Q K^T / sqrt(d)) V over head-major tensors.

    q ``[B, H, S, D]``; keys/vals ``[B, H, L, D]``; ``valid_mask``
    (bool, broadcastable to ``[B, H, S, L]``) excludes False positions.
    Returns ``[B, S, H*D]``."""
    # made on the device (a fill), so that a captured graph may hold it
    scale = torch.full((), float(head_dim), dtype=q.dtype,
                       device=q.device).sqrt()
    scores = torch.einsum("bhsd,bhld->bhsl", q, keys) / scale
    s32 = scores.float()
    if valid_mask is not None:
        neg = torch.finfo(torch.float32).min / 2
        s32 = s32.masked_fill(~valid_mask, neg)
    w = torch.softmax(s32, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhsl,bhld->bhsd", w, vals)
    b, h, s, d = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(b, s, h * d)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last ``len(normalized_shape)`` dims in float32,
    cast back to x's dtype; ``weight``/``bias`` may be None."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return torch.nn.functional.layer_norm(
        x.float(), tuple(normalized_shape),
        None if weight is None else weight.float(),
        None if bias is None else bias.float(), epsilon).to(x.dtype)


def dropout(x, p=0.5, training=True, generator=None):
    """Inverted dropout (upscale_in_train): keep with probability
    ``1 - p`` and divide the kept values by it. Identity when not
    training or ``p == 0``."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    gen = generator or _random.current_generator(x.device)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_flash=True,
                                 generator=None):
    """Attention over ``[B, S, H, D]`` tensors (paddle layout) -> ``[B,
    Sq, H, D]``. ``attn_mask``: bool (True = attend) or additive,
    broadcastable to ``[B, H, Sq, Sk]``. The causal mask is bottom-right
    aligned. Dropout applies only when ``training``. With ``use_flash``
    and what the flash gate takes, the flash kernels run; otherwise the
    composition."""
    eff_p = dropout_p if training else 0.0
    if use_flash and flash_attention_enabled(query, key, attn_mask, eff_p):
        return flash_attention(query, key, value, is_causal=is_causal,
                               attn_mask=attn_mask, dropout_p=eff_p,
                               generator=generator)
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * (
        1.0 / math.sqrt(query.shape[-1]))
    neg = scores.new_full((), -1e9)      # a fill: no copy from the host
    if is_causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((s_q, s_k), dtype=torch.bool,
                         device=scores.device).tril(s_k - s_q)
        scores = torch.where(tri, scores, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, neg)
        else:
            scores = scores + attn_mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(query.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, generator=generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2)


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy with the reference's semantics and float32
    math. Hard labels with softmax over the last axis, no class weights
    and no smoothing take the fused path (`kernels.fused_ce`), as in the
    reference (``loss.py:55-63``); ``ignore_index`` rows count zero and
    leave the mean's denominator. Only the unfused branches cast the
    input to float32; the fused one keeps it in its own dtype."""
    axis = axis % input.dim()

    def logp():
        x = input.float()
        if use_softmax:
            return torch.log_softmax(x, dim=axis)
        return torch.log(x.clamp(min=1e-30))

    n_cls = input.shape[axis]
    if soft_label:
        soft = label.float()
        if label_smoothing > 0.0:
            soft = (1 - label_smoothing) * soft + label_smoothing / n_cls
        loss = -(soft * logp()).sum(dim=axis)
        if weight is not None:
            loss = loss * weight[soft.argmax(dim=axis)]
        return _reduce(loss, reduction)
    ids = label
    if ids.dim() == input.dim() and ids.shape[axis] == 1:
        ids = ids.squeeze(axis)
    ids = ids.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    if (use_softmax and weight is None and label_smoothing == 0.0
            and axis == input.dim() - 1):
        loss = softmax_ce_logits(input.reshape(-1, input.shape[-1]),
                                 safe.reshape(-1)).reshape(ids.shape)
        loss = torch.where(valid, loss, torch.zeros_like(loss))
        if reduction == "mean":
            return loss.sum() / valid.float().sum().clamp(min=1.0)
        return _reduce(loss, reduction)
    lp = logp()
    picked = lp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0.0:
        loss = (-(1 - label_smoothing) * picked
                - label_smoothing * lp.mean(dim=axis))
    else:
        loss = -picked
    if weight is not None:
        loss = loss * weight[safe].float()
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe].float(),
                                torch.zeros_like(loss)).sum()
        else:
            denom = valid.float().sum().clamp(min=1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


__all__ = ["gelu", "relu", "layer_norm", "mt_attention_core", "dropout",
           "scaled_dot_product_attention", "cross_entropy"]
