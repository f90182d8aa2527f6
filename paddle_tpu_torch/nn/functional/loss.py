"""The losses (``paddle_tpu/nn/functional/loss.py``), line by line.

- `cross_entropy` (:27-93): softmax cross-entropy with the reference's
  semantics and float32 math. Hard labels with softmax over the last
  axis, no class weights and no smoothing take the fused path
  (`kernels.fused_ce`; the reference's is fused by XLA, not a Pallas
  kernel), as in the reference (:55-63); ``ignore_index`` rows count
  zero and leave the mean's denominator.
- `softmax_with_cross_entropy` keeps the class axis (size 1) and can
  return the softmax; `nll_loss` gathers on dim 1, its weighted mean
  over the picked weights of the valid rows.
- The reductions and parameters are the reference's, not torch's:
  `kl_div`'s ``"mean"`` averages every element (``"batchmean"`` divides
  by the batch); `smooth_l1_loss` is ``0.5 d^2`` below ``delta`` and
  ``delta (d - delta / 2)`` above; `binary_cross_entropy` clamps ``p`` to
  ``[1e-12, 1 - 1e-7]`` in float32; `triplet_margin_loss` adds
  ``epsilon`` to each ``|u - v|^p`` term; `log_loss` (no reduction),
  `dice_loss` (one-hot of the last dim's labels, the mean over the
  batch) and `square_error_cost` (no reduction) as written there.
"""
from __future__ import annotations

import torch

from ...core.dispatch import amp_cast
from ...kernels.fused_ce import softmax_ce_logits
from .activation import softmax as _softmax
from .common import _at_least_f32


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy with the reference's semantics and float32
    math. Hard labels with softmax over the last axis, no class weights
    and no smoothing take the fused path (`kernels.fused_ce`), as in the
    reference (``loss.py:55-63``); ``ignore_index`` rows count zero and
    leave the mean's denominator. Only the unfused branches cast the
    input to float32; the fused one keeps it in its own dtype. AMP:
    ``cross_entropy`` casts the input only."""
    (input,) = amp_cast("cross_entropy", input)
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, _softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    (input,) = amp_cast("nll_loss", input)
    x = _at_least_f32(input)
    ids = label.long()
    valid = ids != ignore_index
    safe = torch.where(valid, ids, torch.zeros_like(ids))
    loss = -x.gather(1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = ((weight[safe] * valid).sum() if weight is not None
                 else valid.sum().clamp(min=1))
        return loss.sum() / denom
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label = amp_cast("bce", input, label)
    p = torch.clamp(_at_least_f32(input), 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit, label = amp_cast("bce_logits", logit, label)
    z, y = _at_least_f32(logit), _at_least_f32(label)
    softplus_negabs = torch.log1p(torch.exp(-z.abs()))
    if pos_weight is not None:
        # (1 - y) z + (1 + (pw - 1) y) (log(1 + exp(-|z|)) + max(-z, 0))
        w = 1 + (pos_weight - 1) * y
        base = (1 - y) * z + w * (softplus_negabs + torch.clamp(-z, min=0))
    else:
        # max(z, 0) - z y + log(1 + exp(-|z|))
        base = torch.clamp(z, min=0) - z * y + softplus_negabs
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def kl_div(input, label, reduction="mean", name=None):
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input, torch.clamp(margin - input,
                                                      min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    norms = torch.linalg.vector_norm(input1, dim=-1) * \
        torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(-1) / torch.clamp(norms, min=1e-8)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return ((u - v).abs() ** p + epsilon).sum(-1) ** (1.0 / p)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def dice_loss(input, label, epsilon=1e-5, name=None):
    y = torch.nn.functional.one_hot(label.squeeze(-1).long(),
                                    input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = 2 * (input * y).sum(dims)
    union = input.sum(dims) + y.sum(dims)
    return (1 - (inter + epsilon) / (union + epsilon)).mean()


__all__ = ["cross_entropy", "softmax_with_cross_entropy", "nll_loss",
           "mse_loss", "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "log_loss", "dice_loss"]
