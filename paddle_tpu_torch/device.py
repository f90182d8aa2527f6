"""Device and dtype rules of the port.

Counterparts: ``paddle_tpu/core/place.py`` and ``paddle_tpu/core/dtype.py``.

The rule every entry point follows: work runs on ``cuda`` unless the
caller asks for the CPU with ``device="cpu"`` (or, for every entry
given no device, with ``core.place.set_device("cpu")``). With no ``device``
argument and no GPU, `resolve_device` raises — the port never carries on
quietly on the CPU, where a serving run would be orders of magnitude
slower and its numbers would mean nothing.
"""
from __future__ import annotations

import torch

#: dtype names accepted wherever the port takes a ``dtype`` (the
#: paddle_tpu spellings), mapped to torch dtypes
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

#: dtypes a KV page pool may store: the three float dtypes (B3 reads any
#: of them under any query dtype) plus the 1-byte quantized pages of
#: ``Engine(kv_quant="int8" | "fp8")``, which ride with f32 scales
PAGE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


#: the process's expected device (`core.place.set_device`), or None
_EXPECTED = None


def set_expected_device(device):
    """Set (a `torch.device`) or clear (None) the device `resolve_device`
    gives for ``None``; `core.place.set_device` calls it."""
    global _EXPECTED
    _EXPECTED = None if device is None else torch.device(device)


def expected_device():
    """The device `core.place.set_device` set, or None."""
    return _EXPECTED


def resolve_device(device=None) -> torch.device:
    """``None`` -> the device `core.place.set_device` set, else ``cuda``
    (raises when no GPU is visible); anything else is taken as given
    (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a `torch.device`)."""
    if device is None and _EXPECTED is not None:
        device = _EXPECTED
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: paddle_tpu_torch runs on the "
                "GPU by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype, table=DTYPES) -> torch.dtype:
    """A dtype name from ``table`` (default `DTYPES`; `PAGE_DTYPES` for
    a page pool) or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in table.values():
            raise ValueError(f"unsupported dtype {dtype}; use one of "
                             f"{sorted(table)}")
        return dtype
    try:
        return table[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; use one of "
                         f"{sorted(table)}") from None


__all__ = ["DTYPES", "PAGE_DTYPES", "resolve_device", "resolve_dtype",
           "set_expected_device", "expected_device"]
