"""Adam and AdamW, float32 update math whatever the parameter dtype.

Counterpart: ``paddle_tpu/optimizer/optimizers.py:51-101``. `Adam` folds
``weight_decay`` into the gradient (L2); `AdamW` decays decoupled,
``p * (1 - lr*wd)`` before the update. Both use ``_adam_core``: bias
correction ``m / (1 - beta1**t)``, ``v / (1 - beta2**t)`` with the
powers in float32, and eps outside the square root.
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    _slot_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _adam_core(self, g, slots, step):
        g32 = g.float()
        m = self._beta1 * slots["moment1"] + (1 - self._beta1) * g32
        v = self._beta2 * slots["moment2"] + (1 - self._beta2) * g32.square()
        # the powers in float32, as the reference's f32 step counter gives
        t = np.float32(step)
        bc1 = float(np.float32(1) - np.float32(self._beta1) ** t)
        bc2 = float(np.float32(1) - np.float32(self._beta2) ** t)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + self._epsilon)
        return upd, {"moment1": m, "moment2": v}

    def _update_rule(self, p, g, slots, lr, step):
        if self._weight_decay:
            g = g + self._weight_decay * p.to(g.dtype)
        upd, slots = self._adam_core(g, slots, step)
        return (p.float() - lr * upd).to(p.dtype), slots


class AdamW(Adam):
    """Decoupled weight decay, applied to every parameter (the functional
    path of the reference has no per-parameter exclusion)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)

    def _update_rule(self, p, g, slots, lr, step):
        upd, slots = self._adam_core(g, slots, step)
        p32 = p.float()
        if self._weight_decay:
            p32 = p32 * (1 - lr * self._weight_decay)
        return (p32 - lr * upd).to(p.dtype), slots


__all__ = ["Adam", "AdamW"]
