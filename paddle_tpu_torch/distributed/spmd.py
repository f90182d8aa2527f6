"""The train step on one device.

Counterpart: ``paddle_tpu/distributed/spmd.py`` ``SpmdTrainStep`` (:303)
at data-parallel degree 1, and ``gpt_loss_fn`` (:878). The reference
compiles forward, backward and update into one XLA program over sharded
name -> array dicts; here the same contract runs eagerly:

- ``init(dtype, slot_dtype)`` hands back the model's own parameter
  tensors (cast copies only where ``dtype`` differs) and builds the
  optimizer state;
- ``step(params, opt_state, batch, key) -> (loss, params, opt_state)``
  runs the loss through ``torch.func.functional_call`` with the dict's
  tensors, differentiates it with ``torch.autograd`` and applies the
  optimizer (a parameter the loss does not read gets a zero gradient).
  ``key`` seeds this step's generator (`core.random`): every
  dropout mask and flash seed of the step is drawn from it. torch has no
  donation, so params and opt_state are updated in place and returned.
- ``amp="bfloat16"`` is the reference's O2 cast (:488-499): float32
  masters, the forward in bfloat16, float32 gradients.

What this slice leaves out raises `NotImplementedError` naming its
ROADMAP item: a device mesh and recompute (A12), in-step introspection
(A11), a loss scaler (A6).
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..core import random as _random
from ..device import resolve_dtype
from ..nn.functional import cross_entropy


class SpmdTrainStep:
    def __init__(self, model, loss_fn, optimizer, mesh=None, amp=None,
                 recompute=False, scaler=None, introspect=False):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data/tensor parallel training) is a later "
                "slice (ROADMAP A12); this step runs on the model's device")
        if recompute:
            raise NotImplementedError(
                "recompute (activation checkpointing) is a later slice "
                "(ROADMAP A12)")
        if scaler is not None:
            raise NotImplementedError(
                "a loss scaler (amp.GradScaler) is a later slice (ROADMAP "
                "A6)")
        if introspect:
            raise NotImplementedError(
                "in-step introspection is a later slice (ROADMAP A11)")
        self.model = model
        self.optimizer = optimizer
        self._loss_fn = loss_fn
        amp = {"bf16": "bfloat16"}.get(amp, amp)
        self.amp = None if amp is None else resolve_dtype(amp)
        self._names = [n for n, _ in model.named_parameters()]

    def init(self, dtype=None, slot_dtype=None):
        """``(params, opt_state)``: the model's own parameter tensors
        (detached, sharing their storage, so the in-place update trains
        the model itself and no second copy stays resident; a float
        parameter is cast to a new tensor only where ``dtype`` differs
        from its own) and the optimizer state with slots stored in
        ``slot_dtype``."""
        dt = None if dtype is None else resolve_dtype(dtype)
        params = {}
        for n, p in self.model.named_parameters():
            v = p.detach()
            params[n] = (v.to(dt) if dt is not None and v.is_floating_point()
                         else v)
        sd = None if slot_dtype is None else resolve_dtype(slot_dtype)
        return params, self.optimizer.init_state(params, slot_dtype=sd)

    def loss_and_grads(self, params, batch, key):
        """The loss (float32 scalar) and a name -> gradient dict (each in
        its parameter's dtype) of one batch."""
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self._names}
        if self.amp is not None:
            state = {n: (v.to(self.amp) if v.is_floating_point() else v)
                     for n, v in leaves.items()}
        else:
            state = leaves
        dev = next(iter(leaves.values())).device
        with _random.rng_guard(_random.step_generator(key, dev)):
            loss = self._loss_fn(self.model, state, batch).float()
        # a parameter the loss never reads (a post-LN fused layer's
        # pre_ln_scale, ffn._ln1_*) gets a zero gradient, as jax.grad
        # gives it in the reference: AdamW's decoupled decay still moves it
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        return loss.detach(), dict(zip(self._names, grads))

    def __call__(self, params, opt_state, batch, key):
        loss, grads = self.loss_and_grads(params, batch, key)
        params, opt_state = self.optimizer.apply_gradients(params, grads,
                                                           opt_state)
        return loss, params, opt_state


def gpt_loss_fn(model, state, batch):
    """Next-token LM loss of the GPT family: mean cross-entropy of the
    logits of ``batch["input_ids"]`` against ``batch["labels"]``."""
    logits = functional_call(model, state, (batch["input_ids"],))
    if isinstance(logits, tuple):
        logits = logits[0]
    return cross_entropy(logits, batch["labels"], reduction="mean")


__all__ = ["SpmdTrainStep", "gpt_loss_fn"]
