"""Device and dtype rules of the port.

Counterparts: ``paddle_tpu/core/place.py`` and ``paddle_tpu/core/dtype.py``.

The rule every entry point follows: work runs on ``cuda`` unless the
caller asks for the CPU with ``device="cpu"``. With no ``device``
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
}

#: dtypes a KV page pool may store: the model dtypes plus the 1-byte
#: quantized pages of ``Engine(kv_quant="int8" | "fp8")``, which ride
#: with f32 scales
PAGE_DTYPES = {
    **DTYPES,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); anything
    else is taken as given (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a
    `torch.device`)."""
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


__all__ = ["DTYPES", "PAGE_DTYPES", "resolve_device", "resolve_dtype"]
