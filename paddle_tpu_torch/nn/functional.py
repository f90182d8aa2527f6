"""Functional pieces the GPT slice needs.

`mt_attention_core` is the torch copy of
``paddle_tpu/incubate/nn/functional.py:200-222`` ``_mt_attention_core``,
with its numerics kept exactly: scores in the query dtype divided by
``sqrt(head_dim)`` taken in that dtype, masking with
``finfo(float32).min / 2``, softmax in float32, then a cast back to the
query dtype before ``P . V``. The engine's prefill attention runs here
(the JAX package computes it outside any Pallas kernel too).
"""
from __future__ import annotations

import torch


def mt_attention_core(q, keys, vals, head_dim, valid_mask=None):
    """softmax(Q K^T / sqrt(d)) V over head-major tensors.

    q ``[B, H, S, D]``; keys/vals ``[B, H, L, D]``; ``valid_mask``
    (bool, broadcastable to ``[B, H, S, L]``) excludes False positions.
    Returns ``[B, S, H*D]``."""
    scale = torch.tensor(float(head_dim), dtype=q.dtype,
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


__all__ = ["mt_attention_core"]
