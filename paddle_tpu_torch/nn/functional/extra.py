"""The long tail of ``nn.functional`` (``paddle_tpu/nn/functional/
extra.py``): distances and padding, in-place activations, unpooling,
the remaining losses, CTC, the beam-search backtrace, sampled class
centres, sparse attention, and `diag_embed` (the reference takes it
from ``ops/creation.py:155``, A4; the port keeps its own copy here).
`max_pool_with_mask` lives in `pooling`, which calls it.

- `pairwise_distance` (:29): ``||x - y + eps||_p`` over the last dim, in
  float32; `zeropad2d` (:39) pads ``[left, right, top, bottom]``.
- `elu_`, `softmax_` and `tanh_` (:58-77) write into ``x`` and return
  it (softmax in float32).
- `max_unpool1d/2d/3d` (:136-178) scatter each value to its flat index
  of the output, zeros elsewhere (an index past the output is dropped);
  the output size is ``(in - 1) * stride - 2 * padding + kernel`` unless
  ``output_size`` says.
- The losses (:191-280) in float32 with the reference's reductions:
  `multi_margin_loss` weights every term by the target class's weight
  and divides by the class count; `npair_loss` adds ``l2_reg / 4`` of
  the mean squared norms; `sigmoid_focal_loss` divides by
  ``normalizer`` and sums by default.
- `hsigmoid_loss` (:282): the per-sample loss ``[N, 1]``, summed binary
  cross-entropies along a class's root-to-leaf path, on the default
  complete binary tree (the class's heap leaf ``label + num_classes``
  halved level by level; a node id below 0 is no node) or a custom one
  (``path_table`` node ids, negative = padding, and ``path_code``).
- `margin_cross_entropy` (:348): ``cos(m1 * acos(x_y) + m2) - m3`` for
  the target logit, times ``scale``, softmax cross-entropy. It computes
  on this process's logits; a ``group`` of more than one rank raises
  naming A12 (the reference computes locally whatever the group).
- `ctc_loss` (:377): ``log_probs [T, B, C]`` are log-softmaxed here
  first, as the reference does (:387); the negative log-likelihood of
  each row comes from ``torch.nn.functional.ctc_loss`` (no reduction),
  then ``norm_by_times`` divides by the input length and ``"mean"``
  divides each loss by its label length (at least 1) before averaging
  (:429-434). A row no alignment fits costs ``inf`` (the reference's
  -1e30 floor gives about 1e30).
- `gather_tree` (:448): ``ids, parents [T, B, W]`` -> the full beam
  paths, following the parents back from the last step.
- `class_center_sample` (:468): every positive class first (ascending,
  a stable sort), then negatives in random order from the port's
  generator (the reference's draws match in distribution only), the
  first ``num_samples`` kept; labels remapped to their positions.
- `sparse_attention` (:500): dense attention masked to the per-row CSR
  ``(offset, columns)`` pattern, ``key_padding_mask`` and ``attn_mask``
  (0 = masked), in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import random as _random
from .pooling import max_pool_with_mask  # noqa: F401


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


# -------------------------------------------------- distances and padding
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    d = (x - y + epsilon).float()
    return torch.linalg.vector_norm(d, ord=p, dim=-1,
                                    keepdim=keepdim).to(x.dtype)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    left, right, top, bottom = (int(v) for v in padding)
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """``x``'s last dim on the ``offset`` diagonal of the ``(dim1,
    dim2)`` planes of a new tensor (``ops/creation.py:155-174``)."""
    n = x.shape[-1] + abs(offset)
    out = x.new_zeros(tuple(x.shape[:-1]) + (n, n))
    idx = torch.arange(x.shape[-1], device=x.device)
    if offset >= 0:
        out[..., idx, idx + offset] = x
    else:
        out[..., idx - offset, idx] = x
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [d for d in range(nd) if d not in (nd - 2, nd - 1)]
        first, second = sorted([d1, d2])
        perm.insert(first, nd - 2)
        perm.insert(second, nd - 1)
        out = out.permute(*np.argsort(perm).tolist())
    return out


# ------------------------------------------------- in-place activations
def elu_(x, alpha=1.0, name=None):
    return torch.nn.functional.elu_(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(torch.softmax(x.float(), dim=axis))


def tanh_(x, name=None):
    return x.tanh_()


# ------------------------------------------------------------ unpooling
def _to_tuple(v, n):
    return (int(v),) * n if isinstance(v, int) else tuple(int(s) for s in v)


def _max_unpool(x, indices, kernel_size, stride, padding, output_size, nd):
    k = _to_tuple(kernel_size, nd)
    s = _to_tuple(stride, nd) if stride is not None else k
    p = _to_tuple(padding, nd)
    in_sp = x.shape[2:]
    if output_size is not None:
        out_sp = tuple(int(o) for o in output_size[-nd:])
    else:
        out_sp = tuple((in_sp[i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    n, c = x.shape[:2]
    flat = math.prod(out_sp)
    # an index past the output is dropped, as the reference's scatter
    # drops it: it lands in one spare slot, cut off after
    idx = indices.reshape(n, c, -1).long().clamp(max=flat)
    base = x.new_zeros((n, c, flat + 1)).scatter(2, idx, x.reshape(n, c, -1))
    return base[..., :flat].reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 1)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 2)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, kernel_size, stride, padding,
                       output_size, 3)


# --------------------------------------------------------------- losses
def soft_margin_loss(input, label, reduction="mean", name=None):
    v = torch.log1p(torch.exp(-label.float() * input.float()))
    return _reduce(v, reduction).to(input.dtype)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",
                                 name=None):
    xf, yf = input.float(), label.float()
    loss = -(yf * torch.nn.functional.logsigmoid(xf)
             + (1 - yf) * torch.nn.functional.logsigmoid(-xf))
    if weight is not None:
        loss = loss * weight.float()
    return _reduce(loss.mean(dim=-1), reduction).to(input.dtype)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    xf = input.float()
    n, c = xf.shape
    y = label.long()
    correct = xf.gather(1, y[:, None])
    m = torch.clamp(margin - correct + xf, min=0.0) ** p
    if weight is not None:
        m = m * weight[y][:, None].float()
    m = m.scatter(1, y[:, None], 0.0)
    return _reduce(m.sum(dim=1) / c, reduction).to(input.dtype)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    dist = distance_function or pairwise_distance
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    v = torch.clamp(d_pos.float() - d_neg.float() + margin, min=0.0)
    return _reduce(v, reduction).to(d_pos.dtype)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    xf, yf = logit.float(), label.float()
    p = torch.sigmoid(xf)
    ce = -(yf * torch.nn.functional.logsigmoid(xf)
           + (1 - yf) * torch.nn.functional.logsigmoid(-xf))
    p_t = p * yf + (1 - p) * (1 - yf)
    a_t = alpha * yf + (1 - alpha) * (1 - yf)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer.float()
    return _reduce(loss, reduction).to(logit.dtype)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    af, pf = anchor.float(), positive.float()
    l2 = ((af * af).sum(1) + (pf * pf).sum(1)).mean() * l2_reg * 0.25
    sim = af @ pf.T
    y = labels.reshape(-1)
    same = (y[:, None] == y[None, :]).float()
    tgt = same / same.sum(dim=1, keepdim=True)
    xent = (-tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    return (xent + l2).to(anchor.dtype)


def _path_bce(logit, codes):
    """``-(code * log sigmoid(z) + (1 - code) * log sigmoid(-z))``."""
    ls = torch.nn.functional.logsigmoid
    return -(codes * ls(logit) + (1 - codes) * ls(-logit))


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    if (path_table is None) != (path_code is None):
        raise ValueError(
            "hsigmoid_loss: path_table and path_code must be given together")
    w = weight.float()
    b = None if bias is None else bias.float().reshape(-1)
    xf = input.float()
    if path_table is not None:
        nodes = path_table.long()
        valid = (nodes >= 0).float()                       # [N, L]
        node = nodes.clamp(0, w.shape[0] - 1)
        logit = torch.einsum("nd,nld->nl", xf, w[node])
        if b is not None:
            logit = logit + b[node]
        ce = _path_bce(logit, path_code.float())
        return (ce * valid).sum(dim=-1, keepdim=True).to(input.dtype)
    depth = int(math.ceil(math.log2(max(num_classes, 2))))
    cur = label.reshape(-1).long() + num_classes           # heap leaf
    loss = 0.0
    for _ in range(depth):
        code = (cur % 2).float()                           # 1: right child
        cur = cur // 2
        node_id = cur - 1
        node = node_id.clamp(0, w.shape[0] - 1)
        logit = (xf * w[node]).sum(dim=-1)
        if b is not None:
            logit = logit + b[node]
        loss = loss + _path_bce(logit, code) * (node_id >= 0).float()
    return loss[:, None].to(input.dtype)


def _group_ranks(group):
    """Ranks of ``group`` (1 for None or a process-local group)."""
    if group is None or group is False:
        return 1
    if hasattr(group, "nranks"):
        return int(group.nranks)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size(group)
    return 1


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    if _group_ranks(group) > 1:
        raise NotImplementedError(
            "margin_cross_entropy over a group of more than one rank (the "
            "class dim sharded across ranks) waits for A12; the logits "
            "here are this process's")
    xf = logits.float().clamp(-1.0, 1.0)
    y = label.reshape(-1).long()
    theta = torch.arccos(xf.gather(1, y[:, None]))
    target = torch.cos(margin1 * theta + margin2) - margin3
    onehot = torch.nn.functional.one_hot(y, xf.shape[-1]).float()
    logp = torch.log_softmax((xf * (1 - onehot) + target * onehot) * scale,
                             dim=-1)
    loss = _reduce(-logp.gather(1, y[:, None])[:, 0], reduction)
    if return_softmax:
        return loss.to(logits.dtype), logp.exp().to(logits.dtype)
    return loss.to(logits.dtype)


# ------------------------------------------------------------------ CTC
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    lp = torch.log_softmax(log_probs.float(), dim=-1)
    in_len = input_lengths.to(lp.device).long()
    lab_len = label_lengths.to(lp.device).long()
    loss = torch.nn.functional.ctc_loss(
        lp, labels.to(lp.device).long(), in_len, lab_len, blank=blank,
        reduction="none", zero_infinity=False)
    if norm_by_times:
        loss = loss / in_len.clamp(min=1).float()
    if reduction == "mean":
        return (loss / lab_len.clamp(min=1).float()).mean()
    return _reduce(loss, reduction)


# ------------------------------------- beam search, sampling, attention
def gather_tree(ids, parents):
    parent = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:])
    out = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        out[t] = ids[t].gather(1, parent)
        parent = parents[t].long().gather(1, parent)
    return torch.stack(out)


def class_center_sample(label, num_classes, num_samples, group=None,
                        name=None):
    y = label.long()
    n_pos = int(torch.unique(y).numel())
    if n_pos > num_samples:
        raise ValueError(
            f"class_center_sample: {n_pos} distinct positive classes "
            f"exceed num_samples={num_samples}; raise num_samples")
    gen = _random.current_generator(y.device)
    rand = torch.rand((num_classes,), generator=gen, device=y.device)
    pos = torch.zeros((num_classes,), dtype=torch.bool, device=y.device)
    pos[y.reshape(-1)] = True
    order = torch.argsort(torch.where(pos, -1.0, rand), stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(num_classes, device=y.device)
    return inv[y].to(label.dtype), order[:num_samples].to(label.dtype)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    b, h, s, d = query.shape
    off = sparse_csr_offset.long().expand(b, h, -1)
    cols = sparse_csr_columns.long().expand(b, h, -1)
    nnz = cols.shape[-1]
    j = torch.arange(nnz, device=query.device).expand(b, h, nnz)
    rows = torch.searchsorted(off[..., 1:].contiguous(), j.contiguous(),
                              right=True).clamp(max=s - 1)
    valid = j < off[..., -1:]
    flat = torch.where(valid, rows * s + cols, s * s)       # s*s: dropped
    mask = torch.zeros((b, h, s * s + 1), dtype=torch.bool,
                       device=query.device)
    mask.scatter_(2, flat, True)
    mask = mask[..., :s * s].reshape(b, h, s, s)
    scores = torch.einsum("bhqd,bhkd->bhqk", query.float(),
                          key.float()) / math.sqrt(d)
    neg = scores.new_full((), -1e30)
    scores = torch.where(mask, scores, neg)
    if key_padding_mask is not None:
        scores = torch.where((key_padding_mask != 0)[:, None, None, :],
                             scores, neg)
    if attn_mask is not None:
        scores = torch.where((attn_mask != 0)[None, None], scores, neg)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        value.float()).to(query.dtype)


__all__ = ["pairwise_distance", "zeropad2d", "diag_embed", "elu_",
           "softmax_", "tanh_", "max_unpool1d", "max_unpool2d",
           "max_unpool3d", "soft_margin_loss", "multi_label_soft_margin_loss",
           "multi_margin_loss", "triplet_margin_with_distance_loss",
           "sigmoid_focal_loss", "npair_loss", "hsigmoid_loss",
           "margin_cross_entropy", "ctc_loss", "gather_tree",
           "class_center_sample", "sparse_attention"]
