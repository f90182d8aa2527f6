"""Mixture-of-Experts on one card: GShard top-k gating with capacity, the
dense dispatch and combine, and all experts' FFN in batched products.

Counterpart: ``paddle_tpu/distributed/moe.py``. The dispatch is the
reference's dense formulation (one-hot ``[g, s, e, c]`` capacity
matrices contracted with the tokens), not an index scatter, so every
shape is static and a step captures as one CUDA graph.

Numerics kept from the reference:

- `top_k_gating` softmaxes in float32 and picks the top k with the lower
  expert index first on a tie, as ``lax.top_k`` does (a stable sort;
  ``torch.topk`` on CUDA promises no order); capacity is ``max(1,
  int(capacity_factor * k * s / e))``; tokens past an expert's capacity
  are dropped, the first choices placed before the second;
- `stacked_expert_ffn` adds ``b1`` in float32 before the activation and
  the cast back; its default activation is the tanh GELU (``jax.nn.gelu``
  approximates by default). On bfloat16 inputs the products come out of
  the matmul rounded to bfloat16 (accumulated in float32 inside it); the
  reference keeps them in float32 (``preferred_element_type``), for which
  torch's autograd has no batched product (ROADMAP C.3).

The expert-parallel exchange (``ep_exchange``, ``ep_return``,
``moe_ffn_ep`` over an ``ep`` group, the reference's all-to-all in
``shard_map``) is a later slice (ROADMAP A12): with ``axis_name=None``
they are the identity and the dense block, as in the reference; with a
group they raise.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from .topology import EP_AXIS


def gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate=True)


def _top_k(gates, k):
    """The k largest along the last dim, the lower index first on a tie
    (``lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_gating(logits, k=2, capacity=None, capacity_factor=1.25,
                 jitter_eps=0.0, key=None):
    """GShard-style top-k gating with per-expert capacity (:27-65).

    logits ``[g, s, e]``. Returns ``(combine [g, s, e, c] float32,
    dispatch [g, s, e, c] bool, aux_loss)``: the load-balancing loss
    (GShard §2.4) is the mean gate times the share of first choices,
    summed over experts, times e. ``key``: a `torch.Generator` for the
    uniform jitter in ``[-jitter_eps, jitter_eps)``."""
    g, s, e = logits.shape
    if capacity is None:
        capacity = max(1, int(capacity_factor * (k * s) / e))
    if jitter_eps and key is not None:
        noise = torch.rand(logits.shape, generator=key, device=logits.device,
                           dtype=logits.dtype)
        logits = logits + jitter_eps * (2 * noise - 1)
    gates = torch.softmax(logits.float(), dim=-1)
    topv, topi = _top_k(gates, k)                       # [g, s, k]
    topw = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    combine = gates.new_zeros((g, s, e, capacity))
    prev_counts = torch.zeros((g, 1, e), dtype=torch.int64,
                              device=logits.device)     # tokens placed
    aux_me = gates.mean(dim=1)                          # [g, e]
    for j in range(k):
        mask_j = torch.nn.functional.one_hot(topi[..., j], e)   # [g, s, e]
        if j == 0:
            aux_ce = mask_j.float().mean(dim=1)
        pos_j = torch.cumsum(mask_j, dim=1) - 1 + prev_counts
        prev_counts = prev_counts + mask_j.sum(dim=1, keepdim=True)
        keep = (pos_j < capacity) & (mask_j > 0)
        pos_oh = torch.nn.functional.one_hot(
            pos_j.clamp(0, capacity - 1), capacity).float()     # [g,s,e,c]
        combine = combine + (topw[..., j][..., None, None]
                             * keep[..., None].float() * pos_oh)
    dispatch = combine > 0
    aux_loss = (aux_me * aux_ce).sum(-1).mean() * e
    return combine, dispatch, aux_loss


def moe_dispatch(x, dispatch):
    """Tokens to expert slots: ``[g, s, m]`` x ``[g, s, e, c]`` -> ``[e,
    g, c, m]``."""
    return torch.einsum("gsec,gsm->egcm", dispatch.to(x.dtype), x)


def moe_combine(expert_out, combine):
    """The weighted way back: ``[e, g, c, m]`` x ``[g, s, e, c]`` -> ``[g,
    s, m]``."""
    return torch.einsum("gsec,egcm->gsm", combine.to(expert_out.dtype),
                        expert_out)


def stacked_expert_ffn(x, w1, b1, w2, b2, activation=gelu_tanh):
    """All experts in one batched product pair: x ``[e, g, c, m]``, w1
    ``[e, m, f]``, b1 ``[e, f]``, w2 ``[e, f, m]``, b2 ``[e, m]``."""
    h = torch.einsum("egcm,emf->egcf", x, w1).float()
    h = activation(h + b1.float()[:, None, None, :]).to(x.dtype)
    o = torch.einsum("egcf,efm->egcm", h, w2).float()
    return (o + b2[:, None, None, :].float()).to(x.dtype)


def _no_ep(what, axis_name):
    return NotImplementedError(
        f"{what}(axis_name={axis_name!r}): the expert-parallel exchange "
        "over an 'ep' group is a later slice (ROADMAP A12); axis_name=None "
        "runs every expert here")


def ep_exchange(dispatched, axis_name=EP_AXIS):
    """The all-to-all to the experts' ranks: the identity without a
    group (``axis_name=None``)."""
    if axis_name is None:
        return dispatched
    raise _no_ep("ep_exchange", axis_name)


def ep_return(expert_out, axis_name=EP_AXIS):
    """The inverse all-to-all: the identity without a group."""
    if axis_name is None:
        return expert_out
    raise _no_ep("ep_return", axis_name)


def moe_ffn_ep(x, gate_w, w1, b1, w2, b2, k=2, capacity_factor=1.25,
               activation=gelu_tanh, axis_name=EP_AXIS):
    """The MoE-FFN block (:115-139): x ``[g, s, m]``, gate_w ``[m, E]``
    and every expert's weights. Returns ``(y [g, s, m], aux_loss)``.
    Only ``axis_name=None`` (all experts here) is ported."""
    if axis_name is not None:
        raise _no_ep("moe_ffn_ep", axis_name)
    logits = torch.einsum("gsm,me->gse", x.float(), gate_w.float())
    combine, dispatch, aux = top_k_gating(logits, k=k,
                                          capacity_factor=capacity_factor)
    expert_out = stacked_expert_ffn(moe_dispatch(x, dispatch), w1, b1, w2,
                                    b2, activation)
    return moe_combine(expert_out, combine), aux


__all__ = ["top_k_gating", "moe_dispatch", "moe_combine",
           "stacked_expert_ffn", "ep_exchange", "ep_return", "moe_ffn_ep",
           "gelu_tanh"]
