"""Tensor creation and random sampling.

Counterpart: ``paddle_tpu/ops/creation.py:17-335``. A creation op given
no tensor to follow makes its result on the expected device
(`device.resolve_device`: ``cuda``, or the CPU after
``set_device("cpu")``, or it raises); ``place=`` (a `core.place.Place`)
names another. Python floats become float32 and ints int64, as in the
reference (:50-51). Random ops draw from `core.random.current_generator`
on the result's device, so ``seed()`` and `rng_guard` govern them; a
nonzero ``seed=`` draws from a generator of its own (:264-265). Torch's
generators and JAX's keys give other numbers from the same seed: the
draws match the reference's in distribution only.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as _dev
from ..core import random as _random
from ..core import dtype as _dtypes
from ..core.dtype import convert_dtype

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye", "diag",
    "diagflat", "meshgrid", "tril", "triu", "tril_indices", "triu_indices",
    "assign", "clone", "numel", "rand", "randn", "randint", "randint_like",
    "randperm", "uniform", "normal", "standard_normal", "bernoulli",
    "multinomial", "poisson", "empty", "complex", "polar", "as_tensor",
    "diag_embed", "clone", "create_parameter", "check_shape",
]


def _device():
    return _dev.resolve_device(None)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _dtype(dtype, default=torch.float32):
    dt = convert_dtype(dtype)
    return default if dt is None else dt


def _v(x):
    return x.item() if isinstance(x, torch.Tensor) else x


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor of ``data`` (a tensor, a nested list, a number or a
    numpy array) on ``place`` or the expected device."""
    dt = convert_dtype(dtype)
    dev = None if place is None else place.device
    if isinstance(data, torch.Tensor):
        out = data.detach().clone()
        out = out.to(device=out.device if dev is None else dev,
                     dtype=dt or out.dtype)
    else:
        had_tensor = _has_tensor(data)
        arr = np.asarray(_host(data))
        if dt is None and arr.dtype == np.float64 and not had_tensor \
                and not isinstance(data, np.ndarray):
            dt = torch.float32      # paddle's default float for py data
        out = torch.tensor(arr, dtype=dt,
                           device=_device() if dev is None else dev)
    return out.requires_grad_(not stop_gradient)


def _has_tensor(data):
    if isinstance(data, torch.Tensor):
        return True
    return isinstance(data, (list, tuple)) and any(_has_tensor(d)
                                                    for d in data)


def _host(data):
    """``data`` with each tensor inside it a numpy array."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    if isinstance(data, (list, tuple)):
        return [_host(d) for d in data]
    return data


as_tensor = to_tensor


def zeros(shape, dtype="float32", name=None):
    return torch.zeros(_shape(shape), dtype=_dtype(dtype), device=_device())


def ones(shape, dtype="float32", name=None):
    return torch.ones(_shape(shape), dtype=_dtype(dtype), device=_device())


def full(shape, fill_value, dtype="float32", name=None):
    shp = _shape(shape)
    dt = convert_dtype(dtype)
    if isinstance(fill_value, torch.Tensor):
        if fill_value.numel() != 1:
            raise ValueError("full: fill_value must be a scalar, got shape "
                             f"{tuple(fill_value.shape)}")
        out = torch.empty(shp, dtype=dt or fill_value.dtype,
                          device=fill_value.device)
        return out.copy_(fill_value.reshape(()))
    return torch.full(shp, fill_value, dtype=dt, device=_device())


def empty(shape, dtype="float32", name=None):
    """Zeros, as the reference's (never uninitialised memory)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _v(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _v(start), _v(end), _v(step)
    if end is None:
        start, end = 0, start
    dt = convert_dtype(dtype)
    if dt is None:
        ints = all(isinstance(v, (int, np.integer)) for v in (start, end, step))
        dt = torch.int64 if ints else torch.float32
    return torch.arange(start, end, step, dtype=dt, device=_device())


def linspace(start, stop, num, dtype="float32", name=None):
    return torch.linspace(_v(start), _v(stop), int(_v(num)),
                          dtype=_dtype(dtype), device=_device())


def logspace(start, stop, num, base=10.0, dtype="float32", name=None):
    return torch.logspace(_v(start), _v(stop), int(_v(num)), base=_v(base),
                          dtype=_dtype(dtype), device=_device())


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(cols), dtype=_dtype(dtype),
                     device=_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``); of a matrix, its diagonal."""
    if x.ndim == 1:
        out = torch.diag(x, offset)
        if padding_value != 0:
            mask = torch.diag(torch.ones_like(x), offset) == 0
            out = torch.where(mask, torch.as_tensor(
                padding_value, dtype=x.dtype, device=x.device), out)
        return out
    return torch.diagonal(x, offset)


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    n = x.shape[-1] + abs(offset)
    out = x.new_zeros(tuple(x.shape[:-1]) + (n, n))
    idx = torch.arange(x.shape[-1], device=x.device)
    if offset >= 0:
        out[..., idx, idx + offset] = x
    else:
        out[..., idx - offset, idx] = x
    nd = out.ndim
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        perm = [d for d in range(nd) if d not in (nd - 2, nd - 1)]
        order = sorted([d1, d2])
        perm.insert(order[0], nd - 2)
        perm.insert(order[1], nd - 1)
        out = out.permute(*np.argsort(perm).tolist())
    return out


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(args[0],
                                                       (list, tuple)) else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.tril_indices(row, col, offset, dtype=_dtype(dtype),
                              device=_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(row, col, offset, dtype=_dtype(dtype),
                              device=_device())


def assign(x, output=None):
    """A copy of ``x`` (a tensor, or data as numpy reads it), or ``x``
    written into ``output``."""
    if isinstance(x, torch.Tensor):
        src = x.detach().clone()
    else:
        src = torch.tensor(np.asarray(x), device=_device())
    if output is None:
        return src
    output.set_value(src)
    return output


def clone(x, name=None):
    return x.clone()


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def complex(real, imag, name=None):
    return torch.complex(real, imag)


def polar(abs_t, angle, name=None):
    return abs_t * torch.exp(1j * angle.to(torch.complex64))


# ---------------------------------------------------------------------------
# random sampling
# ---------------------------------------------------------------------------

def _gen(device):
    return _random.current_generator(device)


def rand(shape, dtype="float32", name=None):
    dev = _device()
    return torch.rand(_shape(shape), generator=_gen(dev), dtype=_dtype(dtype),
                      device=dev)


def randn(shape, dtype="float32", name=None):
    dev = _device()
    return torch.randn(_shape(shape), generator=_gen(dev),
                       dtype=_dtype(dtype), device=dev)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _device()
    return torch.randint(low, high, _shape(shape), generator=_gen(dev),
                         dtype=_dtype(dtype, torch.int64), device=dev)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape), generator=_gen(x.device),
                         dtype=_dtype(dtype, x.dtype), device=x.device)


def randperm(n, dtype="int64", name=None):
    dev = _device()
    return torch.randperm(int(n), generator=_gen(dev),
                          dtype=_dtype(dtype, torch.int64), device=dev)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    dev = _device()
    gen = _random.step_generator(seed, dev) if seed else _gen(dev)
    out = torch.empty(_shape(shape), dtype=_dtype(dtype), device=dev)
    return out.uniform_(min, max, generator=gen)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """Normal draws of ``mean`` and ``std`` (numbers, or tensors that
    broadcast), float32 for numbers."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m = torch.as_tensor(mean, dtype=like.dtype, device=like.device)
        s = torch.as_tensor(std, dtype=like.dtype, device=like.device)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=_gen(like.device), dtype=like.dtype,
                        device=like.device)
        return z * s + m
    dev = _device()
    z = torch.randn(_shape(shape), generator=_gen(dev), device=dev)
    return z * std + mean


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None, *,
                     device=None):
    """A standalone parameter (`framework.param_attr.create_parameter`):
    on ``device``, else the expected device."""
    from ..framework.param_attr import create_parameter as _create

    return _create(shape, dtype, name=name, attr=attr, is_bias=is_bias,
                   default_initializer=default_initializer, device=device)


def check_shape(shape, op_name="", expected_shape_type=(list, tuple,
                                                       torch.Tensor),
                expected_element_type=(int, torch.Tensor),
                expected_tensor_dtype=("int32", "int64")):
    """Validate a shape argument of a creation op (the reference's
    ``paddle.check_shape``): raises TypeError, else returns None."""
    if not isinstance(shape, expected_shape_type):
        raise TypeError(
            f"{op_name}: shape must be one of {expected_shape_type}, "
            f"got {type(shape)}")
    if isinstance(shape, torch.Tensor):
        if _dtypes.dtype_name(shape.dtype) not in expected_tensor_dtype:
            raise TypeError(
                f"{op_name}: shape tensor dtype must be in "
                f"{expected_tensor_dtype}, got {shape.dtype}")
        return
    for item in shape:
        if not isinstance(item, expected_element_type):
            raise TypeError(
                f"{op_name}: shape element must be one of "
                f"{expected_element_type}, got {type(item)}")
        if isinstance(item, torch.Tensor) and \
                _dtypes.dtype_name(item.dtype) not in expected_tensor_dtype:
            raise TypeError(
                f"{op_name}: shape element tensor dtype must be in "
                f"{expected_tensor_dtype}, got {item.dtype}")
