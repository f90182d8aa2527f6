"""`Layer`, the port's module base, with `HookRemoveHelper`, `LazyGuard`
and `Dropout`.

Counterpart: ``paddle_tpu/nn/layer.py:27-367`` and ``nn/common.py``'s
``Dropout``. `Layer` is a ``torch.nn.Module``, so the port's models,
``torch.func.functional_call``, `distributed.SpmdTrainStep`, CUDA-graph
capture, `models.convert` and `framework.io` take it as any module. It
adds the reference's construction and traversal, where the reference's
methods share torch's names each takes both call forms:

- ``create_parameter(shape, attr, dtype, is_bias, default_initializer)``
  (`framework.param_attr.build_parameter`: drawn at once, on the layer's
  ``device``, the card unless it was built with ``device="cpu"``),
  ``add_parameter``, ``add_sublayer``, ``register_buffer(name, tensor,
  persistable=True)`` (torch's ``persistent=``; a buffer that is not
  persistable stays out of ``state_dict``);
- ``named_parameters(prefix, include_sublayers)`` and ``parameters()``
  (a list, as the reference's), ``named_sublayers`` / ``sublayers``
  (pre-order, the layer first with ``include_self``), ``named_buffers``
  / ``buffers``; torch's keyword forms (``recurse=``,
  ``remove_duplicate=``) pass through;
- ``state_dict()`` in the reference's order: every parameter, then every
  persistable buffer, each by its structured name; torch's recursive
  form ``state_dict(destination=, prefix=, keep_vars=)`` fills the
  caller's dict. Values are detached tensors (``keep_vars=True``: the
  parameters themselves). ``set_state_dict`` copies in place, cast to
  each target's dtype, raises ``ValueError`` on a shape mismatch and
  returns ``(missing, unexpected)``;
- ``to(device=None, dtype=None, blocking=None)`` with the reference's
  dtype names (floating tensors only are cast), ``astype``,
  ``full_name``, ``apply`` (the layer first, then its sublayers);
- ``register_forward_pre_hook`` / ``register_forward_post_hook``: a hook
  may return new inputs or a new output; each returns a
  `HookRemoveHelper`.

`LazyGuard`: layers built inside it hold their parameters on ``meta``;
``param.initialize()`` draws each on its device.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from ..device import DTYPES, resolve_dtype
from . import functional as F

_layer_name_counters: dict = {}


def _auto_name(cls_name):
    idx = _layer_name_counters.get(cls_name, 0)
    _layer_name_counters[cls_name] = idx + 1
    return f"{cls_name.lower()}_{idx}"


class HookRemoveHelper:
    """The handle of a registered hook: ``remove()`` unregisters it."""

    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class LazyGuard:
    """Inside, `create_parameter` records each parameter's initializer
    and builds it on ``meta``; ``param.initialize()`` draws it."""

    def __enter__(self):
        from ..framework.param_attr import _LAZY_INIT
        _LAZY_INIT[0] = True
        return self

    def __exit__(self, *exc):
        from ..framework.param_attr import _LAZY_INIT
        _LAZY_INIT[0] = False
        return False


def _named_sublayers(module, prefix, include_self, seen):
    if id(module) in seen:
        return
    seen.add(id(module))
    if include_self:
        yield prefix, module
    for name, sub in module._modules.items():
        if sub is not None:
            yield from _named_sublayers(
                sub, f"{prefix}.{name}" if prefix else name, True, seen)


def _dtype_arg(dtype):
    """A dtype name of the reference (``"bfloat16"``) as a torch dtype."""
    return resolve_dtype(dtype) if isinstance(dtype, str) else dtype


class Layer(nn.Module):
    """The module base (module docstring). ``dtype``: the default of the
    parameters it creates (float32); ``device``: where they are drawn
    (None: the card)."""

    def __init__(self, name_scope=None, dtype=None, *, device=None):
        super().__init__()
        self._dtype = resolve_dtype(dtype or "float32")
        self._device = device
        self._full_name = _auto_name(name_scope or type(self).__name__)

    # -- construction ------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        from ..framework.param_attr import build_parameter

        return build_parameter(
            shape, self._dtype if dtype is None else resolve_dtype(dtype),
            attr=attr, is_bias=is_bias,
            default_initializer=default_initializer,
            device=self._device if device is None else device)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.from_numpy(np.array(tensor))
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # -- traversal ---------------------------------------------------------
    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def parameters(self, include_sublayers=True, *, recurse=None):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        return super().named_buffers(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        return _named_sublayers(self, prefix, include_self,
                                set() if layers_set is None else layers_set)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._full_name

    # -- state dict --------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix=None,
                   keep_vars=False):
        dest = OrderedDict() if destination is None else destination
        base = (structured_name_prefix if prefix is None
                else prefix).rstrip(".")
        for name, p in self.named_parameters(base, include_sublayers):
            dest[name] = p if keep_vars else p.detach()
        seen = set()
        mods = (self.named_sublayers(base, include_self=True)
                if include_sublayers else [(base, self)])
        for mname, mod in mods:
            for bname, b in mod._buffers.items():
                if b is None or id(b) in seen or \
                        bname in mod._non_persistent_buffers_set:
                    continue
                seen.add(id(b))
                dest[f"{mname}.{bname}" if mname else bname] = \
                    b if keep_vars else b.detach()
        return dest

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict(keep_vars=True)
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.array(src))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(src.shape)} vs layer {tuple(target.shape)}")
            target.copy_(src.detach().to(device=target.device,
                                         dtype=target.dtype))
        unexpected = [name for name in state_dict if name not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # -- device and dtype --------------------------------------------------
    def to(self, *args, **kwargs):
        blocking = kwargs.pop("blocking", None)
        if blocking is not None:
            kwargs.setdefault("non_blocking", not blocking)
        if "dtype" in kwargs:
            kwargs["dtype"] = _dtype_arg(kwargs["dtype"])
        args = tuple(resolve_dtype(a) if isinstance(a, str) and a in DTYPES
                     else a for a in args)
        out = super().to(*args, **kwargs)
        dtype = torch._C._nn._parse_to(*args, **kwargs)[1]
        if dtype is not None:
            for layer in self.sublayers(include_self=True):
                if isinstance(layer, Layer):
                    layer._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)

    # -- hooks -------------------------------------------------------------
    def register_forward_pre_hook(self, hook, **kwargs):
        handle = super().register_forward_pre_hook(hook, **kwargs)
        if kwargs:                       # torch's own call form
            return handle
        return HookRemoveHelper(self._forward_pre_hooks, handle.id)

    def register_forward_post_hook(self, hook):
        handle = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, handle.id)


class Dropout(Layer):
    """Dropout with the reference's ``axis`` and ``mode`` (random bits
    from the current `core.random` generator)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = float(p)
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


__all__ = ["Layer", "HookRemoveHelper", "LazyGuard", "Dropout"]
