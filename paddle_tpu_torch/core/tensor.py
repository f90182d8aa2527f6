"""The port's Tensor: ``torch.Tensor`` itself, with the reference's names
that torch lacks.

Counterpart: ``paddle_tpu/core/tensor.py:30-210``. The reference wraps a
``jax.Array`` in a class of its own; the port's tensors are torch's, so
that every layer, kernel wrapper and optimizer keeps calling torch with
no wrapper in the way (a ``torch.Tensor`` subclass with
``__torch_function__`` would cost a Python call on every op of every
layer, and the eager paths are host-bound). At import this module adds
to ``torch.Tensor``, once, only the names it lacks (`ADDED`):
``stop_gradient``, ``clear_grad`` / ``clear_gradient``,
``retain_grads``, ``astype`` / ``cast``, ``set_value``, ``place`` and
``persistable``. Every name torch already has keeps torch's meaning;
where the reference's differs, that is a documented deviation (ROADMAP
C.3), each held by ``tests/test_torch_tensor.py``:

- ``shape`` is a ``torch.Size`` (the reference: a list); ``dtype`` a
  torch dtype (the reference: a numpy dtype); ``size`` is torch's method
  (the reference's property is ``numel()``); ``is_leaf`` is torch's
  property (the reference's is a method); ``name`` is torch's read-only
  attribute, None on a plain tensor (a `Parameter`'s is its own);
- ``numpy()`` refuses a tensor that requires grad (``detach()``
  first) or lives on the card (``cpu()`` first);
- ``backward(gradient)`` takes no ``grad_tensor=`` keyword, and a
  non-scalar root needs its gradient (`autograd.backward` fills ones
  as the reference does);
- ``to`` takes torch dtypes and devices (a place: ``to(place.device)``;
  a dtype name: ``astype``); ``copy_(src, non_blocking)``'s second
  argument is torch's; ``copy_``, ``fill_`` and ``zero_`` on a leaf
  that requires grad need ``torch.no_grad()`` (``set_value`` does
  that itself);
- ``retain_grads`` keeps a non-leaf's grad (``retain_grad``); the
  reference's sets a flag its engine never reads, so there an
  intermediate's grad stays None.
"""
from __future__ import annotations

import numpy as np
import torch

from .dtype import convert_dtype
from .parameter import Parameter
from .place import place_of

Tensor = torch.Tensor


def _get_stop_gradient(self):
    return not self.requires_grad


def _set_stop_gradient(self, value):
    self.requires_grad_(not value)


def clear_grad(self, set_to_zero=False):
    """Drop the grad, or with ``set_to_zero`` zero it in place."""
    if set_to_zero and self.grad is not None:
        self.grad.zero_()
    else:
        self.grad = None


def retain_grads(self):
    """Keep this non-leaf's grad after a backward (a leaf keeps its
    own; a tensor that needs no grad has none)."""
    if self.requires_grad and not self.is_leaf:
        self.retain_grad()


def astype(self, dtype):
    """A copy in ``dtype`` (a reference name or a torch dtype),
    differentiable."""
    return self.to(convert_dtype(dtype))


def set_value(self, value):
    """Replace the values in place, kept in this tensor's dtype and on
    its device, outside autograd (a new shape replaces the storage)."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(np.ascontiguousarray(value))
    value = torch.as_tensor(value).detach().to(self.device, self.dtype)
    with torch.no_grad():
        if value.shape == self.shape:
            self.copy_(value)
        else:
            self.data = value.clone()
    return self


def _place(self):
    return place_of(self.device)


def _get_persistable(self):
    return self.__dict__.get("_persistable", isinstance(self, Parameter))


def _set_persistable(self, value):
    self.__dict__["_persistable"] = bool(value)


#: the names this module adds to ``torch.Tensor``
ADDED = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "clear_grad": clear_grad,
    "clear_gradient": clear_grad,
    "retain_grads": retain_grads,
    "astype": astype,
    "cast": astype,
    "set_value": set_value,
    "place": property(_place),
    "persistable": property(_get_persistable, _set_persistable),
}


def _install():
    for name, value in ADDED.items():
        if name not in vars(torch.Tensor):
            if hasattr(torch.Tensor, name):
                raise RuntimeError(f"torch.Tensor already has {name!r}: the "
                                   "port adds only names torch lacks")
            setattr(torch.Tensor, name, value)


_install()

__all__ = ["Tensor", "Parameter", "ADDED", "clear_grad", "retain_grads",
           "astype", "set_value"]
