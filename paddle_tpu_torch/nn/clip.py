"""Gradient clipping: by value, by norm, by global norm.

Counterpart: ``paddle_tpu/nn/clip.py``. Each clip has the eager form
(``clip(params_grads)`` over ``(param, grad)`` pairs, :79-96; a pair
whose grad is None or whose param says ``need_clip = False`` passes
through) and the functional form (``apply_functional`` over a name ->
grad dict) for compiled train steps; `clip_grad_norm_` (:106) clips
``p.grad`` in place.

Norms are summed in float32; each grad is multiplied in float32 and cast
back to its dtype. Every scale stays a device tensor, so clipping costs
no host synchronisation and runs inside a captured step.
`ClipGradByGlobalNorm.scale` gives the scale alone, which the Adam
kernel applies to each grad as it reads it
(`kernels.multi_tensor_adam`).
"""
from __future__ import annotations

import torch


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError

    def apply_functional(self, grads: dict) -> dict:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each grad element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip_one(self, g):
        return torch.clamp(g, self.min, self.max)

    def __call__(self, params_grads):
        return [(p, self._clip_one(g) if _clipped(p, g) else g)
                for p, g in params_grads]

    def apply_functional(self, grads):
        return {k: self._clip_one(g) for k, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip_one(self, g):
        norm = torch.sqrt(g.float().square().sum())
        return _scaled(g, torch.clamp(
            self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0))

    def __call__(self, params_grads):
        return [(p, self._clip_one(g) if _clipped(p, g) else g)
                for p, g in params_grads]

    def apply_functional(self, grads):
        return {k: self._clip_one(g) for k, g in grads.items()}


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad scaled by ``min(clip_norm / max(||all grads||, 1e-12),
    1)``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """The float32 global L2 norm of a name -> grad dict (or of a
        list of grads)."""
        values = grads.values() if isinstance(grads, dict) else grads
        return torch.sqrt(sum(g.float().square().sum() for g in values))

    def scale(self, grads) -> torch.Tensor:
        """The float32 device scale every grad is multiplied by."""
        return torch.clamp(
            self.clip_norm / torch.clamp(self.global_norm(grads), min=1e-12),
            max=1.0)

    def __call__(self, params_grads):
        clippable = [g for p, g in params_grads if _clipped(p, g)]
        if not clippable:
            return params_grads
        scale = self.scale(clippable)
        return [(p, _scaled(g, scale) if _clipped(p, g) else g)
                for p, g in params_grads]

    def apply_functional(self, grads: dict) -> dict:
        scale = self.scale(grads)
        return {k: _scaled(g, scale) for k, g in grads.items()}


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place so that their joint ``norm_type``
    norm is at most ``max_norm``; returns that norm before clipping (a
    float32 device tensor)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max().float()
                             for p in params]).max()
    else:
        total = sum(p.grad.float().abs().pow(norm_type).sum()
                    for p in params) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for p in params:
        p.grad.copy_(_scaled(p.grad, scale))
    return total


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]
