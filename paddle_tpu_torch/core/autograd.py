"""Grad mode, saved-tensor hooks, backward and ``grad`` over
``torch.autograd``.

Counterpart: ``paddle_tpu/core/autograd.py``. The reference records a
tape of ``jax.vjp`` closures and walks it; the port's tensors carry
torch's graph, so each entry here is torch's with the reference's
contract:

- grad mode: `no_grad`, `enable_grad` (torch's, context managers and
  decorators), `set_grad_enabled(flag)` (sets the mode; returns None, as
  the reference), `is_grad_enabled` (:34-62);
- `saved_tensors_hooks(pack, unpack)` (:77-135) is
  ``torch.autograd.graph.saved_tensors_hooks``: every tensor an op
  saves for its backward goes through ``pack`` at forward time and
  ``unpack`` when the backward reads it;
- `run_backward(tensors, grad_tensors, retain_graph)`: a missing root
  gradient is ones of the root's shape, for any root (torch's own wants
  one for a non-scalar); roots that need no grad are skipped;
- `grad(outputs, inputs, grad_outputs, retain_graph, create_graph,
  allow_unused)` (:303-340): the gradients as a list, needing no grad;
  ``.grad`` untouched. An input that no output reaches (or that needs no
  grad) raises unless ``allow_unused``, which gives None for it.
  ``create_graph=True`` raises `NotImplementedError`, as the
  reference's does.
"""
from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
saved_tensors_hooks = torch.autograd.graph.saved_tensors_hooks

_UNUSED = ("One of the differentiated tensors appears to not have been used "
           "in the graph; set allow_unused=True to return None for it.")


def set_grad_enabled(enabled: bool):
    """Switch grad mode on this thread."""
    torch.set_grad_enabled(bool(enabled))


def _listed(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _root_grads(tensors, grad_tensors):
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    return [torch.ones_like(t) if g is None else g
            for t, g in zip(tensors, _listed(grad_tensors))]


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from ``tensors``: grads accumulate into the leaves that
    require them (``.grad``)."""
    tensors = _listed(tensors)
    pairs = [(t, g) for t, g in zip(tensors, _root_grads(tensors,
                                                         grad_tensors))
             if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs],
                                retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """Gradients of ``outputs`` with respect to ``inputs`` (leaves or
    intermediates), a list in the order of ``inputs``."""
    if create_graph:
        raise NotImplementedError(
            "create_graph=True: higher-order gradients are not supported "
            "eagerly (as in the reference)")
    outputs, inputs = _listed(outputs), _listed(inputs)
    roots = [(t, g) for t, g in zip(outputs, _root_grads(outputs,
                                                         grad_outputs))
             if t.requires_grad]
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    found = [None] * len(inputs)
    if roots and live:
        got = torch.autograd.grad(
            [t for t, _ in roots], [inputs[i] for i in live],
            [g for _, g in roots], retain_graph=bool(retain_graph),
            allow_unused=True)
        for i, g in zip(live, got):
            found[i] = g
    if not allow_unused and any(g is None for g in found):
        raise RuntimeError(_UNUSED)
    return found


__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "saved_tensors_hooks", "run_backward", "grad"]
