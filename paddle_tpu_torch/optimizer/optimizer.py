"""Optimizer base, functional form.

Counterpart: ``paddle_tpu/optimizer/optimizer.py:200-252``
(``init_state`` / ``apply_gradients``): the per-parameter update rule
``_update_rule(p, g, slots, lr, step) -> (new_p, new_slots)`` runs over
name -> tensor dicts. Slots are stored in ``slot_dtype`` (float32 by
default; bfloat16 halves Adam's state) and the math runs in float32:
stored slots are cast up before the rule and the results cast back to
their storage dtype. Gradients are cast to the parameter's dtype first
(``:240``).

torch has no buffer donation, so `apply_gradients` updates ``params``
and the slots IN PLACE and returns the same dicts: one copy of the
training state stays live, as the reference's donated step keeps one.

What this slice leaves out raises `NotImplementedError` naming its
ROADMAP item: LR schedulers and the eager ``step()`` over a parameter
list (A6).
"""
from __future__ import annotations

import numbers

import torch


class Optimizer:
    _slot_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(
                "LR schedulers are a later slice (ROADMAP A6); pass a float "
                "learning_rate")
        if parameters is not None:
            raise NotImplementedError(
                "the eager step() over a parameter list is a later slice "
                "(ROADMAP A6); use init_state/apply_gradients")
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip

    def init_state(self, params: dict, slot_dtype=None) -> dict:
        """``{"step": 0, "slots": {name: {slot: zeros}}}``, float slots
        allocated directly in ``slot_dtype`` (default float32)."""
        dt = slot_dtype or torch.float32
        return {"step": 0,
                "slots": {k: {n: torch.zeros_like(v, dtype=dt)
                              for n in self._slot_names}
                          for k, v in params.items()}}

    def _update_rule(self, p, g, slots, lr, step):
        raise NotImplementedError

    @torch.no_grad()
    def apply_gradients(self, params: dict, grads: dict, state: dict):
        """One update of every parameter with a gradient, in place.
        Returns ``(params, state)``, the same dicts."""
        step = state["step"] + 1
        lr = self._learning_rate
        if self._grad_clip is not None:
            grads = self._grad_clip.apply_functional(
                {k: g for k, g in grads.items() if g is not None})
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            stored = state["slots"][k]
            slots_in = {n: (s.float() if s.dtype in (torch.bfloat16,
                                                     torch.float16) else s)
                        for n, s in stored.items()}
            new_p, slots = self._update_rule(p, g.to(p.dtype), slots_in, lr,
                                             step)
            p.copy_(new_p)
            for n, v in slots.items():
                stored[n].copy_(v)
        state["step"] = step
        return params, state


__all__ = ["Optimizer"]
