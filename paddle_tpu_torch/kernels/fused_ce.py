"""Fused softmax cross-entropy for the LM head (dtype-disciplined).

Counterpart: ``paddle_tpu/kernels/fused_ce.py``, an XLA composition (a
``jax.custom_vjp``), not a Pallas kernel; here it is plain torch ops in a
`torch.autograd.Function`. The forward keeps ``[T, V]`` in the logits
dtype and reduces to a per-row float32 max and lse; only the logits and
the lse are saved. The backward recomputes ``exp(z - lse) - onehot`` in
the logits dtype instead of saving the softmax.

Forward:  ``m = max(z); lse = log(sum(exp(z - m))) + m``; ``loss = lse -
z[label]`` (float32 ``[T]``).
Backward: ``dz = (exp(z - lse) - onehot) * g``, built in the logits dtype.
"""
from __future__ import annotations

import torch


class _SoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        m = logits.amax(dim=-1, keepdim=True)
        # exp in place on the float32 copy: one [T, V] float32 buffer
        sumexp = (logits - m).float().exp_().sum(dim=-1)
        lse = torch.log(sumexp) + m[:, 0].float()
        picked = logits.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked.float()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        # p in the logits dtype; the one-hot subtraction and the scaling
        # run in place on it (no second [T, V] buffer)
        p = torch.exp((logits.float() - lse[:, None]).to(logits.dtype))
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, labels] -= 1
        p.mul_(g[:, None].to(p.dtype))
        return p, None


def softmax_ce_logits(logits, labels):
    """Per-row loss of ``logits [T, V]`` (any float dtype) against integer
    ``labels [T]``: float32 ``[T]``, differentiable in ``logits``."""
    return _SoftmaxCE.apply(logits, labels.long())


__all__ = ["softmax_ce_logits"]
