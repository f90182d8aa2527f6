"""`Parameter`: a trainable tensor with the reference's attributes.

Counterpart: ``paddle_tpu/core/tensor.py:213-244`` (``Parameter``). A
``torch.nn.Parameter`` subclass, so every torch module, optimizer and
``functional_call`` takes it as a parameter, carrying:

- ``name`` (the `ParamAttr`'s, or None);
- ``trainable``, which is ``requires_grad`` (``stop_gradient``, its
  negation, is the Tensor surface's: `core.tensor`);
- ``optimize_attr`` (``{"learning_rate": scale}``: the eager optimizer
  step multiplies its rate by it), ``regularizer`` (its ``_coeff`` is
  the parameter's weight decay) and ``need_clip`` (False: gradient
  clipping passes its grad through);
- under `nn.LazyGuard`, the recorded initializer that `initialize`
  draws.

The attributes live in the instance's ``__dict__``. ``copy.deepcopy``
(the encoder and decoder stacks copy their layer) and pickling keep them
and the class; ``Module.to`` converts a parameter in place, so they stay
there too. Ops on a parameter give plain tensors, as on any
``nn.Parameter``.
"""
from __future__ import annotations

import copy

import torch
from torch import nn


def _rebuild_parameter(data, requires_grad, state):
    """The unpickler's constructor (`Parameter.__reduce_ex__`)."""
    p = Parameter(data, requires_grad)
    p.__dict__.update(state)
    return p


class Parameter(nn.Parameter):
    """``Parameter(data, requires_grad=True, name=None)``; the attributes
    start at the reference's defaults (rate scale 1, no regularizer,
    clipped)."""

    def __new__(cls, data=None, requires_grad=True, name=None):
        return super().__new__(cls, data, requires_grad)

    def __init__(self, data=None, requires_grad=True, name=None):
        self.name = name
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self._init_fn = None

    # torch's tensors have a read-only ``name``; a parameter's is its own
    @property
    def name(self):
        return self.__dict__.get("_name")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def initialize(self):
        """Draw the initializer recorded under `nn.LazyGuard` (the
        tensor on ``meta`` becomes the drawn one on its device, this
        object kept); without one, nothing. Returns the parameter."""
        if self._init_fn is not None:
            fn, self._init_fn = self._init_fn, None
            drawn = Parameter(fn(), self.requires_grad)
            drawn.__dict__.update(self.__dict__)
            torch.utils.swap_tensors(self, drawn)
        return self

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        state = {k: v for k, v in self.__dict__.items() if k != "_init_fn"}
        return _rebuild_parameter, (self.data, self.requires_grad, state)


__all__ = ["Parameter"]
