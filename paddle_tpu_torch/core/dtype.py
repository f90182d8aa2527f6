"""The dtype vocabulary: the reference's names over torch dtypes.

Counterpart: ``paddle_tpu/core/dtype.py:13-79``. The table and the
module constants are the reference's, each a torch dtype
(``float16 = torch.float16``); `convert_dtype` takes a name, a torch
dtype or a numpy dtype and gives the torch dtype (the reference gives the
numpy dtype: a dtype of the port's tensors is a torch dtype). The
predicates and `promote_types` answer as the reference's do for every
pair of the table: torch's promotion, but a float8 beside a bool or an
integer is the float8, where torch refuses.
"""
from __future__ import annotations

import numpy as np
import torch

#: the reference's dtype table: name -> torch dtype
_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float8_e4m3fn = torch.float8_e4m3fn
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}


def convert_dtype(dtype):
    """A dtype spec (a name of the table, a torch dtype, a numpy dtype or
    type) -> torch dtype; None stays None. An unknown name raises
    TypeError, as the reference's does."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    """The reference's name of a dtype ('float32', 'bfloat16', ...)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def promote_types(a, b):
    """The dtype two operands of dtypes ``a`` and ``b`` promote to."""
    a, b = convert_dtype(a), convert_dtype(b)
    for x, y in ((a, b), (b, a)):
        if x == torch.float8_e4m3fn and not (y.is_floating_point
                                             or y.is_complex):
            return x
    return torch.promote_types(a, b)


__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float8_e4m3fn", "float32", "float64", "complex64",
           "complex128", "convert_dtype", "dtype_name", "is_floating_point",
           "is_integer", "is_complex", "promote_types"]
