"""Save and load: `save`, `load`.

Counterpart: ``paddle_tpu/framework/io.py`` (``save`` :60, ``load`` :68).
The format is the reference's, so each package reads the other's files:
a pickle of nested dict, list and tuple containers in which every tensor
is a ``_TensorPayload`` (``array`` a numpy ndarray, ``stop_gradient``,
``name``, ``is_parameter``); anything else is pickled as it is.

Two things need care, since the port imports neither ``paddle_tpu`` nor
``ml_dtypes``:

- Writing. The stream must name the reference's payload class
  (``paddle_tpu.framework.io._TensorPayload``) and, for a bfloat16 or
  float8 tensor, the ``ml_dtypes`` scalar type inside the array's numpy
  dtype, exactly as numpy pickles an ``ml_dtypes`` array. The standard
  pickler imports every module it names to check the global, so `save`
  runs the pure-Python pickler with its own ``save_global``, which
  writes those names without importing them.
- Reading. `load` runs its own ``Unpickler.find_class``: either
  package's payload class maps to this module's, an ``ml_dtypes`` type
  to a marker, and numpy's array reconstructors to ones that keep such
  an array's raw bytes (a ``uint16`` or ``uint8`` view) and reinterpret
  them with ``torch.Tensor.view(dtype)``.

`load` returns ``torch.Tensor``s on ``device`` (the CPU by default, as
``torch.load``), a `core.Parameter` with the payload's ``name`` where
``is_parameter`` is set (a plain tensor has no name: its payload's is
None); with
``return_numpy=True`` numpy arrays, a bfloat16 or float8 one as float32
(numpy has no such dtype; the values are exact).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.parameter import Parameter

#: where the reference keeps its payload class; the stream names it
_PAYLOAD_GLOBAL = ("paddle_tpu.framework.io", "_TensorPayload")
_PAYLOAD_MODULES = ("paddle_tpu.framework.io", "paddle_tpu_torch.framework.io")

#: torch dtypes numpy lacks: ml_dtypes' name, numpy's raw view, the
#: integer torch dtype of that view, and numpy's dtype state for the type
_ML_DTYPES = {
    torch.bfloat16: ("bfloat16", np.uint16, torch.int16,
                     (3, "<", None, None, None, 2, 2, 64)),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8,
                          (3, "<", None, None, None, 1, 1, 64)),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8,
                        (3, "<", None, None, None, 1, 1, 64)),
}
_ML_BY_NAME = {v[0]: k for k, v in _ML_DTYPES.items()}


class _TensorPayload:
    """Pickle surrogate for a tensor: ndarray + metadata. Pickled under
    the reference's name, with the reference's four attributes."""

    def __init__(self, array, stop_gradient, name, is_parameter):
        self.array = array
        self.stop_gradient = stop_gradient
        self.name = name
        self.is_parameter = is_parameter


class _Named:
    """A global that the stream names without importing it."""

    __slots__ = ("module", "name")

    def __init__(self, module, name):
        self.module, self.name = module, name


def _numpy_reconstruct():
    """numpy's own array reconstructor (its module moved in numpy 2)."""
    return np.zeros(1).__reduce_ex__(4)[0]


class _MlDtype:
    """Pickles as numpy pickles ``np.dtype(ml_dtypes.<name>)``."""

    def __init__(self, torch_dtype):
        self.torch_dtype = torch_dtype

    def __reduce__(self):
        name, _, _, state = _ML_DTYPES[self.torch_dtype]
        return np.dtype, (_Named("ml_dtypes", name), False, True), state


class _MlArray:
    """A bfloat16 or float8 tensor, pickled as numpy pickles an
    ``ml_dtypes`` array of its values."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __reduce__(self):
        t = self.tensor.contiguous()
        raw = t.view(_ML_DTYPES[t.dtype][2]).numpy().tobytes()
        return (_numpy_reconstruct(), (np.ndarray, (0,), b"b"),
                (1, tuple(t.shape), _MlDtype(t.dtype), False, raw))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing the reference's payload class
    and the ``ml_dtypes`` types by name, without importing them."""

    dispatch = pickle._Pickler.dispatch.copy()

    def save_global(self, obj, name=None):
        if obj is _TensorPayload:
            module, name = _PAYLOAD_GLOBAL
        elif isinstance(obj, _Named):
            module, name = obj.module, obj.name
        else:
            return super().save_global(obj, name)
        if self.proto >= 4:
            self.save(module)
            self.save(name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{name}\n".encode("utf-8"))
        self.memoize(obj)

    dispatch[_Named] = save_global


class _RawDtype:
    """What an ``ml_dtypes`` type and its numpy dtype load as: the torch
    dtype to reinterpret the raw bytes with."""

    def __init__(self, name):
        if name not in _ML_BY_NAME:
            raise pickle.UnpicklingError(
                f"ml_dtypes.{name} has no torch dtype here; known: "
                f"{sorted(_ML_BY_NAME)}")
        self.torch_dtype = _ML_BY_NAME[name]

    def __setstate__(self, state):
        pass


def _dtype(obj, align=False, copy=True):
    if isinstance(obj, _RawDtype):
        return obj
    return np.dtype(obj, align, copy)


class _RawArray:
    """An array of a dtype numpy lacks: raw bytes, shape and order."""

    def __init__(self, dtype: _RawDtype, shape, raw, order="C"):
        self.torch_dtype = dtype.torch_dtype
        self.shape = tuple(int(s) for s in shape)
        self.raw = raw
        self.order = order

    def tensor(self) -> torch.Tensor:
        _, np_raw, torch_raw, _ = _ML_DTYPES[self.torch_dtype]
        bits = np.frombuffer(self.raw, dtype=np_raw).reshape(
            self.shape, order=self.order)
        bits = np.ascontiguousarray(bits).view(
            np.int16 if np_raw == np.uint16 else np.uint8)
        return torch.from_numpy(bits.copy()).view(self.torch_dtype)


class _LoadedArray(np.ndarray):
    """What numpy's ``_reconstruct`` builds on load: an ndarray, unless
    the pickled dtype is an ``ml_dtypes`` one, whose raw bytes are kept
    as a `_RawArray` instead."""

    def __setstate__(self, state):
        if len(state) == 4:
            state = (0, *state)
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _RawDtype):
            self.raw_array = _RawArray(dtype, shape, raw,
                                       "F" if fortran else "C")
            return
        super().__setstate__(state)


def _reconstruct(subtype, shape, typecode):
    return np.ndarray.__new__(_LoadedArray, shape, typecode)


def _frombuffer(buf, dtype, shape, order):
    if isinstance(dtype, _RawDtype):
        return _RawArray(dtype, shape, bytes(buf), order)
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order=order)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module in _PAYLOAD_MODULES:
            return _TensorPayload
        if module == "ml_dtypes" or module.startswith("ml_dtypes."):
            return _RawDtype(name)
        if module.startswith("numpy"):
            if name == "dtype":
                return _dtype
            if name == "_reconstruct" and module.endswith(".multiarray"):
                return _reconstruct
            if name == "_frombuffer" and module.endswith(".numeric"):
                return _frombuffer
        return super().find_class(module, name)


def _raw(a):
    """The `_RawArray` an array loaded as, or None."""
    if isinstance(a, _RawArray):
        return a
    return getattr(a, "raw_array", None)


def _as_numpy(a):
    raw = _raw(a)
    if raw is not None:
        return raw.tensor().float().numpy()
    if isinstance(a, _LoadedArray):
        return a.view(np.ndarray)
    return a


def _as_tensor(a) -> torch.Tensor:
    raw = _raw(a)
    if raw is not None:
        return raw.tensor()
    return torch.from_numpy(np.array(_as_numpy(a), copy=True))


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        array = (_MlArray(t) if t.dtype in _ML_DTYPES
                 else t.contiguous().numpy())
        return _TensorPayload(array, not obj.requires_grad,
                              getattr(obj, "name", None)
                              if isinstance(obj, Parameter) else None,
                              isinstance(obj, torch.nn.Parameter))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return tuple(packed) if isinstance(obj, tuple) else type(obj)(packed)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return _as_numpy(obj.array)
        t = _as_tensor(obj.array).to(device)
        if obj.is_parameter:
            t = Parameter(t, t.is_floating_point(), name=obj.name)
        elif t.is_floating_point():
            t.requires_grad_(not obj.stop_gradient)
        return t
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v, return_numpy, device) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    if isinstance(obj, (np.ndarray, _RawArray)):
        return _as_numpy(obj)
    return obj


def save(obj, path, protocol=4, **kwargs):
    """Pickle ``obj`` to ``path`` in the reference's format: every
    ``torch.Tensor`` inside nested dicts, lists and tuples becomes a
    payload of its values as a numpy array (bfloat16 and float8 as the
    ``ml_dtypes`` arrays the reference holds)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path, return_numpy=False, device="cpu", **kwargs):
    """Read a file of either package's `save`: tensors on ``device`` (a
    `core.Parameter` where the file says so), or numpy arrays with
    ``return_numpy``."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, torch.device(device))


__all__ = ["save", "load"]
