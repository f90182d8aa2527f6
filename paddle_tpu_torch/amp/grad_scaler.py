"""Dynamic loss scaling, eager form.

Counterpart: ``paddle_tpu/amp/grad_scaler.py``, with its constructor and
API: `scale`, `unscale_`, `step`, `update`, `minimize`,
`get_loss_scaling`, `is_enable`, `is_use_dynamic_loss_scaling`,
`state_dict` / `load_state_dict`. The grads are unscaled in float32 and
cast back to their dtype; a non-finite one skips the optimizer's step,
and the scale shrinks after ``decr_every_n_nan_or_inf`` such steps (not
below 1) and grows after ``incr_every_n_steps`` good ones. As in the
reference (:55-70), the eager form reads its found-inf flag on the host
once a step.

Inside a train step the same bookkeeping runs on the device instead
(`distributed.spmd.make_scaler_step`, state from `scaler_state`), with
no host read: `distributed.SpmdTrainStep(scaler=GradScaler(...))`.
"""
from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        finite = None
        for p in optimizer._parameter_list or []:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            ok = torch.isfinite(g).all()
            finite = ok if finite is None else finite & ok
            p.grad.copy_(g)
        self._found_inf = finite is not None and not bool(finite)
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, loss):
        loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        if not self._enable or not self._dynamic:
            self._unscaled = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)


__all__ = ["GradScaler"]
