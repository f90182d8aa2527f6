"""The op dispatch's AMP hook: where an op names itself and its float
tensor arguments are cast.

Counterpart: ``paddle_tpu/core/dispatch.py:37-60`` (``set_amp_hook``,
``_maybe_autocast``) and the name every op passes to ``apply_op``
(:160-211). The reference runs every op through ``apply_op(name, fn,
tensor_args)``; the port's layers call torch directly, and where the
reference calls ``apply_op`` under a name the AMP lists hold, the port's
function calls `amp_cast(name, *tensor_args)` with exactly those
``tensor_args`` and computes on what it returns.

- `set_amp_hook(hook)`: ``hook(op_name) -> dtype or None``, installed by
  `amp` (its ``amp_dtype_for_op``).
- `amp_state()`: this thread's AMP state (``enabled``, ``dtype``,
  ``level``, ``custom_white``, ``custom_black``), the one record of
  whether AMP is on; `amp.auto_cast` sets it and `amp.amp_state` is
  this function.
- `amp_cast(name, *tensors)`: with AMP off the tensors as given, at the
  cost of one read of a thread-local; with it on, each floating tensor
  whose dtype is not the hook's answer becomes ``t.to(dtype)``, a
  differentiable cast, so a float32 parameter's grad comes back in
  float32, as in the reference. Non-tensors (None, numbers) pass.

The reference's static recorder hook (:26-35) and its
``FLAGS_check_nan_inf`` watcher (:67-105) need ``static/`` and
``utils/flags``: ROADMAP A14.
"""
from __future__ import annotations

import threading

import torch

_tls = threading.local()
_amp_hook = None


def set_amp_hook(hook):
    """Install ``hook(op_name) -> dtype | None`` (None removes it)."""
    global _amp_hook
    _amp_hook = hook


def amp_state():
    """This thread's AMP state dict (made, AMP off, on first use)."""
    st = getattr(_tls, "amp", None)
    if st is None:
        st = _tls.amp = {"enabled": False, "dtype": torch.bfloat16,
                         "level": "O1", "custom_white": set(),
                         "custom_black": set()}
    return st


def amp_cast(name, *tensors):
    """``tensors`` as op ``name`` computes on them: cast by the AMP hook
    while AMP is on, else as given. Returns a tuple, one per argument."""
    st = getattr(_tls, "amp", None)
    if st is None or not st["enabled"]:
        return tensors
    hook = _amp_hook
    dtype = None if hook is None else hook(name)
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != dtype else t
                 for t in tensors)


__all__ = ["set_amp_hook", "amp_state", "amp_cast"]
