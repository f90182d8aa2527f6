"""`nn.utils`: `weight_norm` / `remove_weight_norm`, `spectral_norm`,
`parameters_to_vector` and `vector_to_parameters`.

Counterpart: ``paddle_tpu/nn/utils.py``.

- `weight_norm` (:25-62) turns ``layer.<name>`` into two parameters,
  ``{name}_g`` (the norm over every dim but ``dim``, kept as a
  broadcastable shape; a scalar with ``dim=None``) and ``{name}_v`` (the
  direction), and recomputes ``g * v / ||v||`` (the norm in float32) in
  a forward pre-hook. The weight is then derived state: it leaves the
  layer's parameters and lives as a plain tensor attribute, which
  ``torch.nn.Module`` reads before its parameters; the hook runs
  once when it is registered, so ``layer.weight`` exists before any forward.
  `remove_weight_norm` (:65-75) makes the last weight a parameter again.
- `spectral_norm` (:93-133) keeps ``{name}_orig`` and divides it by its
  largest singular value, estimated each forward by ``n_power_iterations``
  of power iteration in float32 from the same stored ``u`` and ``v``,
  which are not written back (the reference's estimate is re-warmed
  every call the same way). ``u [h]`` and ``v [numel / h]`` are drawn
  from the port's generator (the reference draws them from numpy's), as
  buffers outside the state dict, so they move with the layer.
- `parameters_to_vector` / `vector_to_parameters` (:78-90): the
  parameters flattened into one vector, and written back in place (cast
  to each parameter's dtype).
"""
from __future__ import annotations

import math

import torch

from ..core import random as _random
from ..core.parameter import Parameter


def _norm_except_dim(v, dim):
    """``||v||`` over every dim but ``dim`` (float32, kept dims); over
    the whole tensor, a scalar, for ``dim=-1``."""
    if dim == -1:
        return v.float().square().sum().sqrt()
    axes = [i for i in range(v.dim()) if i != dim]
    return v.float().square().sum(dim=axes, keepdim=True).sqrt()


def _set_derived(layer, name, value):
    """``layer.<name>`` as a plain attribute (not a parameter)."""
    layer.__dict__[name] = value


def weight_norm(layer, name="weight", dim=0):
    w = getattr(layer, name)
    dim = -1 if dim is None else dim
    with torch.no_grad():
        g0 = _norm_except_dim(w, dim).to(w.dtype)
        v0 = w.detach().clone()
    del layer._parameters[name]
    layer.add_parameter(f"{name}_v", Parameter(v0, name=f"{name}_v"))
    layer.add_parameter(f"{name}_g", Parameter(g0, name=f"{name}_g"))

    def hook(mod, inputs):
        g = mod._parameters[f"{name}_g"]
        v = mod._parameters[f"{name}_v"]
        _set_derived(mod, name, g * v / _norm_except_dim(v, dim).to(v.dtype))
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer._weight_norm_handle = (handle, name)
    with torch.no_grad():          # a leaf, so the layer deep-copies
        hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    handle, stored = getattr(layer, "_weight_norm_handle", (None, None))
    if stored != name:
        raise ValueError(f"no weight_norm on {name!r}")
    handle.remove()
    w = layer.__dict__.pop(name)
    del layer._parameters[f"{name}_v"], layer._parameters[f"{name}_g"]
    layer.add_parameter(name, Parameter(w.detach().clone(), name=name))
    del layer._weight_norm_handle
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    w = getattr(layer, name)
    dim = 0 if dim is None else dim
    h = int(w.shape[dim])
    gen = _random.current_generator(w.device)
    layer.register_buffer(f"{name}_u", torch.randn(
        (h,), generator=gen, device=w.device), persistent=False)
    layer.register_buffer(f"{name}_v", torch.randn(
        (w.numel() // h,), generator=gen, device=w.device),
        persistent=False)
    del layer._parameters[name]
    layer.add_parameter(f"{name}_orig",
                        Parameter(w.detach().clone(), name=f"{name}_orig"))

    def hook(mod, inputs):
        wv = mod._parameters[f"{name}_orig"]
        m = wv.movedim(dim, 0).reshape(wv.shape[dim], -1).float()
        uu, vv = getattr(mod, f"{name}_u"), getattr(mod, f"{name}_v")
        for _ in range(n_power_iterations):
            vv = m.T @ uu
            vv = vv / (torch.linalg.vector_norm(vv) + eps)
            uu = m @ vv
            uu = uu / (torch.linalg.vector_norm(uu) + eps)
        sigma = uu @ m @ vv
        _set_derived(mod, name, wv / sigma.to(wv.dtype))
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer._spectral_norm_handle = (handle, name)
    with torch.no_grad():          # a leaf, so the layer deep-copies
        hook(layer, ())
    return layer


def parameters_to_vector(parameters, name=None):
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    for p in parameters:
        n = math.prod(p.shape)
        p.copy_(vec[offset:offset + n].reshape(p.shape).to(p.dtype))
        offset += n


__all__ = ["weight_norm", "remove_weight_norm", "parameters_to_vector",
           "vector_to_parameters", "spectral_norm"]
