"""Per-step FLOPs accounting and MFU (the roofline plane).

Counterpart: ``paddle_tpu/observability/costs.py``. There XLA's
``cost_analysis()`` of a compiled executable gives its FLOPs. Here
`count_flops` counts a call's operations with `torch.utils.flop_counter.
FlopCounterMode`, which sees PyTorch's operators only: a hand-written
kernel launched through ctypes (the paged-attention kernel, the flash
kernels) adds nothing to it. The serving engine's decode step is
therefore priced by `gpt_decode_flops`, its products in closed form
plus the attention's columns, read when ``stats()`` asks and never on
the step's path; the tests hold the products against `count_flops` of
the step's body.

- `count_flops(fn, *args, **kwargs)`: ``(result, operations)`` of one
  call under the counter (``aten.bmm`` with the formula `bmm_flop`).
- `gpt_decode_flops(config, w, cols)`: one GPT decode/verify step.

- `record_executable_costs(name, flops, nbytes=None)` publishes the
  ``executable_flops`` (and, given the bytes, ``executable_bytes`` and
  ``executable_arithmetic_intensity``) gauges under ``executable=name``,
  the reference's families.
- `peak_flops_per_sec()` is the MFU denominator: an explicit override,
  else ``PADDLE_TPU_PEAK_FLOPS`` (the reference's variable), else the
  table keyed by ``torch.cuda.get_device_name()``, Hopper only (NVIDIA's
  data sheets: dense bf16/fp16 tensor-core peaks). A card the table does
  not know raises rather than guess; the CPU gets the reference's 1e12
  smoke denominator, which makes no utilization claim.
- `mfu(flops, seconds)` is the formula itself.
"""
from __future__ import annotations

import os
import threading

from .registry import get_registry

#: peak dense bf16/fp16 FLOP/s by device-name substring (lower case),
#: NVIDIA Hopper only: the H100 SXM (80 GB HBM3) and the H200 (989
#: TFLOP/s, their data sheets)
PEAK_FLOPS_TABLE = (("h100 80gb hbm3", 989e12), ("h100 sxm", 989e12),
                    ("h200", 989e12))
#: the CPU's denominator (the reference's smoke value): MFU is not
#: meaningful there
CPU_PEAK_FLOPS = 1e12

_lock = threading.Lock()
#: executable name -> {"flops", "bytes_accessed", "arithmetic_intensity"}
_costs: dict = {}
_peak_cache: dict = {}


def peak_flops_per_sec(override=None, device=None) -> float:
    """Peak FLOP/s of ``device`` (default: the current CUDA device, the
    CPU when no card is visible) for the MFU denominator: ``override`` >
    ``PADDLE_TPU_PEAK_FLOPS`` > `PEAK_FLOPS_TABLE` by the card's name;
    on the CPU `CPU_PEAK_FLOPS`. An unknown card raises."""
    if override:
        return float(override)
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return CPU_PEAK_FLOPS
    with _lock:
        peak = _peak_cache.get(dev.index)
    if peak is not None:
        return peak
    name = torch.cuda.get_device_name(dev).lower()
    peak = next((v for k, v in PEAK_FLOPS_TABLE if k in name), None)
    if peak is None:
        raise ValueError(
            f"no peak FLOP/s for {torch.cuda.get_device_name(dev)!r} in "
            "PEAK_FLOPS_TABLE: pass override= or set PADDLE_TPU_PEAK_FLOPS")
    with _lock:
        _peak_cache[dev.index] = peak
    return peak


def record_executable_costs(name: str, flops, nbytes=None, registry=None):
    """Publish one step's cost under ``executable=name`` and keep it;
    returns the stored entry (``{"flops", "bytes_accessed",
    "arithmetic_intensity"}``), or None when ``flops`` is missing."""
    if flops is None:
        return None
    flops = float(flops)
    nbytes = float(nbytes) if nbytes else 0.0
    entry = {"flops": flops, "bytes_accessed": nbytes,
             "arithmetic_intensity": (flops / nbytes) if nbytes else None}
    with _lock:
        _costs[name] = entry
    reg = registry or get_registry()
    reg.gauge("executable_flops",
              "counted FLOPs per execution of the named step",
              labelnames=("executable",)).set(flops, executable=name)
    if nbytes:
        reg.gauge("executable_bytes",
                  "bytes accessed per execution of the named step",
                  labelnames=("executable",)).set(nbytes, executable=name)
        reg.gauge("executable_arithmetic_intensity",
                  "FLOPs per byte accessed — the step's roofline position",
                  labelnames=("executable",)).set(
                      entry["arithmetic_intensity"], executable=name)
    return entry


def executable_costs(name: str | None = None):
    """The recorded cost entry of one step (None if unknown), or the
    whole ``{name: entry}`` table when ``name`` is omitted."""
    with _lock:
        if name is not None:
            e = _costs.get(name)
            return dict(e) if e else None
        return {k: dict(v) for k, v in _costs.items()}


def mfu(flops, seconds, peak=None):
    """Model-FLOPs utilization of one execution: ``flops / seconds /
    peak_flops_per_sec()``; None when either input is missing."""
    if not flops or not seconds or seconds <= 0:
        return None
    return flops / seconds / (peak or peak_flops_per_sec())


def bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """Operations of ``aten.bmm`` in each of its overloads: ``bmm.dtype``
    (16-bit operands with a float32 output) takes the output dtype as a
    third argument, which the formula some torch versions ship mistakes
    for the output shape."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def count_flops(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), operations)``: one call under
    `FlopCounterMode`; PyTorch's operators only (a ctypes kernel launch
    counts nothing)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: bmm_flop})
    with mode:
        out = fn(*args, **kwargs)
    return out, float(mode.get_total_flops())


def gpt_decode_flops(config, w, cols) -> float:
    """Operations of one GPT decode/verify step of ``len(cols)`` rows of
    ``w`` queries: the products, 2 x ((4 h^2 + 2 h I) a layer + h V) a
    query (qkv and the projection, the MLP's two of width I, the LM
    head), plus the attention, 4 H W D a column and a layer (the scores
    and the weighted sum), row ``r`` reading ``cols[r]`` columns."""
    h, i = config.hidden_size, config.intermediate_size
    layers = config.num_hidden_layers
    products = 2.0 * len(cols) * w * ((4 * h * h + 2 * h * i) * layers
                                      + h * config.vocab_size)
    attention = (4.0 * config.num_attention_heads * w * config.head_dim
                 * float(sum(cols)) * layers)
    return products + attention


def reset_for_test():
    with _lock:
        _costs.clear()
        _peak_cache.clear()


__all__ = ["PEAK_FLOPS_TABLE", "CPU_PEAK_FLOPS", "peak_flops_per_sec",
           "record_executable_costs", "executable_costs", "mfu",
           "bmm_flop", "count_flops", "gpt_decode_flops", "reset_for_test"]
