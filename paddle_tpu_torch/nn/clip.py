"""Gradient clipping by global norm, functional form.

Counterpart: ``paddle_tpu/nn/clip.py:64-110``
(``ClipGradByGlobalNorm.apply_functional``): over a name -> grad dict,
``scale = min(clip_norm / max(||g||, 1e-12), 1)`` with the norm summed in
float32, each grad multiplied in float32 and cast back to its dtype. The
scale stays a device tensor: clipping costs no host synchronisation.
"""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def global_norm(grads: dict) -> torch.Tensor:
        """The float32 global L2 norm of a name -> grad dict."""
        return torch.sqrt(sum(g.float().square().sum()
                              for g in grads.values()))

    def apply_functional(self, grads: dict) -> dict:
        scale = torch.clamp(
            self.clip_norm / torch.clamp(self.global_norm(grads), min=1e-12),
            max=1.0)
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


__all__ = ["ClipGradByGlobalNorm"]
