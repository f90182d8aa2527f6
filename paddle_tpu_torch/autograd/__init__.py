"""``paddle.autograd``: `backward`, `grad`, `PyLayer`, the grad-mode
switches and `saved_tensors_hooks`.

Counterpart: ``paddle_tpu/autograd/__init__.py:20-124``. `PyLayer` runs
its subclass's ``forward(ctx, *args)`` and ``backward(ctx, *grads)``
through one ``torch.autograd.Function``: ``forward`` runs without
recording, its outputs need grad when grad mode is on and a tensor
input needs it, and ``backward`` returns one gradient for each tensor
input, in order (None for one gives it no gradient).
`PyLayerContext.save_for_backward` saves through torch, so the
saved-tensor hooks active at that point pack the tensors and
``saved_tensor()`` unpacks them.
"""
from __future__ import annotations

import torch

from ..core import autograd as _engine
from ..core.autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                             saved_tensors_hooks, set_grad_enabled)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from ``tensors`` (a tensor or a list); missing gradients
    are ones."""
    _engine.run_backward(tensors, grad_tensors, retain_graph)


class PyLayerContext:
    """``ctx`` of a `PyLayer`: `save_for_backward` / `saved_tensor`, and
    any attribute ``forward`` sets for ``backward``."""

    def __init__(self, fn_ctx=None):
        self._fn_ctx = fn_ctx
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._fn_ctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return tuple(self._fn_ctx.saved_tensors)


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer call: ``args`` after the layer class and its keyword
    arguments."""

    @staticmethod
    def forward(fn_ctx, layer, kwargs, *args):
        ctx = PyLayerContext(fn_ctx)
        fn_ctx.pylayer = (layer, ctx, [isinstance(a, torch.Tensor)
                                       for a in args])
        return layer.forward(ctx, *args, **kwargs)

    @staticmethod
    def backward(fn_ctx, *grads):
        layer, ctx, is_tensor = fn_ctx.pylayer
        got = layer.backward(ctx, *grads)
        got = list(got) if isinstance(got, (tuple, list)) else [got]
        out = []
        for t in is_tensor:
            out.append(got.pop(0) if t and got else None)
        return (None, None, *out)


class PyLayer:
    """A custom op: subclass with static ``forward(ctx, *args, **kwargs)``
    and ``backward(ctx, *grads)``; call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _PyLayerFunction.apply(cls, kwargs, *args)


__all__ = ["backward", "grad", "PyLayer", "PyLayerContext", "no_grad",
           "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "saved_tensors_hooks"]
