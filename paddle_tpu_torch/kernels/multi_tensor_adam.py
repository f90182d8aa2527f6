"""Multi-tensor Adam / AdamW update: the Hopper kernel and its plain
version.

Counterpart: no Pallas kernel. The reference's update is XLA's fusion of
``paddle_tpu/optimizer/optimizers.py:55-100`` inside its compiled train
step; here one launch of ``csrc/multi_tensor_adam.cu`` updates every
tensor of a group sharing (param dtype, grad dtype, slot dtype, master),
in float32 registers and in the reference's order (the source's header
note gives the math and the bound).

- `multi_tensor_adam`: the update of a list of `AdamEntry` in place. CPU
  tensors take the plain version; CUDA tensors launch the kernel, one
  launch a group (each counts once as ``multi_tensor_adam``), or the
  wrapper raises. Params, moments and masters must be contiguous; a
  grad that is not is copied first.
- `adam_reference`: the plain version, the per-parameter rule in torch
  ops (its powers ``b^t`` in float32 from the device step count).
- `AdamTables`: an owner's device tables of entries, written once for a
  list of tensors and again only when an address changes (a few kept,
  the oldest dropped); a table a graph captured is held by that graph
  (`kernels.hold`).

Every scalar the update reads is a device tensor: ``lr`` float32, the
step count ``step`` int32 (the count before this update; ``t = step +
1``), and optionally ``found_inf`` int32 (nonzero: nothing is written)
and ``clip_scale`` float32 (each grad multiplied by it and rounded to
its dtype first, as `nn.ClipGradByGlobalNorm` does). The caller advances
the step count.
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build, count_launch, hold, runs_plain

_SOURCE = "multi_tensor_adam"
_NAME = "multi_tensor_adam"
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 65536                   # elements a chunk (csrc kChunk)
_TABLES_KEPT = 4
_fns = None


class AdamEntry(NamedTuple):
    """One tensor's operands: param, grad, the two moments, the float32
    master of a bf16 param (or None) and its weight decay."""
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    master: Optional[torch.Tensor]
    wd: float


# ----------------------------------------------------------- plain version
def weak(x, like):
    """A scalar beside a tensor as JAX types a Python scalar (weakly): in
    ``like``'s dtype, so a bf16 operand rounds it. A number becomes a
    fill on the device (no copy from the host, so a graph can capture
    it); a tensor is cast."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return like.new_full((), x)


def _put(dst, new, skip):
    """``dst`` := ``new`` rounded to its dtype, unless ``skip``."""
    if skip is not None:
        new = torch.where(skip, dst, new.to(dst.dtype))
    dst.copy_(new)


@torch.no_grad()
def adam_reference(entries, lr, step, *, beta1, beta2, epsilon, adamw,
                   found_inf=None, clip_scale=None):
    """The plain version of `multi_tensor_adam`, in place: for each entry
    the reference's rule in torch ops, float32 math, results rounded to
    their storage dtypes."""
    t = (step + 1).float()
    bc1 = 1 - torch.pow(beta1, t)
    bc2 = 1 - torch.pow(beta2, t)
    skip = None if found_inf is None else found_inf != 0
    for e in entries:
        g = e.g
        if clip_scale is not None:
            g = (g.float() * clip_scale).to(g.dtype)
        g = g.to(torch.float32 if e.master is not None else e.p.dtype)
        p32 = e.master if e.master is not None else e.p.float()
        if not adamw and e.wd:
            g = g + weak(e.wd, g) * p32.to(g.dtype)
        g32 = g.float()
        m = beta1 * e.m.float() + (1 - beta1) * g32
        v = beta2 * e.v.float() + (1 - beta2) * g32.square()
        upd = (m / bc1) / (torch.sqrt(v / bc2) + epsilon)
        if adamw and e.wd:
            p32 = p32 * (1 - lr * e.wd)
        p32 = p32 - lr * upd
        if e.master is not None:
            _put(e.master, p32, skip)
        _put(e.p, p32, skip)
        _put(e.m, m, skip)
        _put(e.v, v, skip)


# ---------------------------------------------------------- kernel wrapper
def _kernel_fns():
    """``(adam, upload, error_string)``: the C entry points with their
    argument types declared."""
    global _fns
    if _fns is None:
        lib = _build.load(_SOURCE)
        adam = lib.ptt_multi_tensor_adam
        adam.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                         + [ctypes.c_float] * 5 + [ctypes.c_int,
                                                   ctypes.c_void_p])
        adam.restype = ctypes.c_int
        upload = lib.ptt_mta_upload
        upload.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
        upload.restype = ctypes.c_int
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns = (adam, upload, err_str)
    return _fns


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{_NAME} {what} failed: CUDA error {err} "
                           f"({_kernel_fns()[2](err).decode()})")


def _check(cond, msg):
    if not cond:
        raise ValueError(f"{_NAME}: {msg}")


def _check_entry(e, dev):
    for name in ("p", "g", "m", "v"):
        t = getattr(e, name)
        _check(t.device == dev and t.is_contiguous()
               and t.dtype in _CODES, f"{name} must be a contiguous float32 "
               f"or bfloat16 tensor on {dev}, got {t.dtype} on {t.device}")
        _check(t.numel() == e.p.numel(), f"{name} has {t.numel()} elements, "
               f"the param {e.p.numel()}")
    _check(e.m.dtype == e.v.dtype, "both moments must share a dtype")
    if e.master is not None:
        _check(e.p.dtype == torch.bfloat16 and e.master.device == dev
               and e.master.dtype == torch.float32
               and e.master.is_contiguous()
               and e.master.numel() == e.p.numel(),
               "a master is a contiguous float32 copy of a bfloat16 param")


def _scalar(t, dtype, dev, name):
    _check(t.device == dev and t.dtype == dtype and t.numel() == 1,
           f"{name} must be a one-element {dtype} tensor on {dev}")
    return t.data_ptr()


class _Table:
    """One device table of entries, written by the kernels of
    ``ptt_mta_upload`` (the rows go as their arguments, so the host rows
    are free once launched)."""

    def __init__(self, rows, device):
        self.n = len(rows)
        self.chunks = int(rows[-1, 6] + -(-rows[-1, 5] // _CHUNK))
        self.dev = torch.empty(rows.shape, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _raise_on(_kernel_fns()[1](self.dev.data_ptr(), rows.ctypes.data,
                                   self.n, stream), "table upload")


class AdamTables:
    """An owner's device tables, by the rows they hold; the newest
    `_TABLES_KEPT` are kept."""

    def __init__(self):
        self._tables: collections.OrderedDict = collections.OrderedDict()

    def get(self, entries, device) -> _Table:
        rows = np.zeros((len(entries), 8), np.int64)
        first = 0
        for i, e in enumerate(entries):
            ptrs = [e.p.data_ptr(), e.g.data_ptr(), e.m.data_ptr(),
                    e.v.data_ptr(),
                    0 if e.master is None else e.master.data_ptr()]
            numel = e.p.numel()
            rows[i, :5] = ptrs
            rows[i, 5] = numel
            rows[i, 6] = first
            first += -(-numel // _CHUNK)
            aligned = int(all(q % 16 == 0 for q in ptrs))
            wd = int(np.array([e.wd], np.float32).view(np.uint32)[0])
            rows[i, 7] = wd | (aligned << 32)
        key = rows.tobytes()
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = _Table(rows, device)
            while len(self._tables) > _TABLES_KEPT:
                self._tables.popitem(last=False)
        else:
            self._tables.move_to_end(key)
        return hold(table)


def multi_tensor_adam(entries, lr, step, *, beta1, beta2, epsilon, adamw,
                      found_inf=None, clip_scale=None, tables=None):
    """One Adam (``adamw=False``: L2 decay folded into the grad) or AdamW
    update of every `AdamEntry` in place. ``lr`` float32 and ``step``
    int32 one-element device tensors, ``found_inf`` int32 and
    ``clip_scale`` float32 or None (module docstring). ``tables``: the
    owner's `AdamTables` (a CUDA call needs one)."""
    entries = [e for e in entries if e.p.numel()]
    if not entries:
        return
    if runs_plain(entries[0].p, _NAME):
        adam_reference(entries, lr, step, beta1=beta1, beta2=beta2,
                       epsilon=epsilon, adamw=adamw, found_inf=found_inf,
                       clip_scale=clip_scale)
        return
    dev = entries[0].p.device
    _check(tables is not None, "a CUDA update needs its owner's AdamTables")
    # a grad that is a view into a fused projection's gradient (the qkv
    # kernels' backward) is read through a contiguous copy
    entries = [e if e.g.is_contiguous() else e._replace(g=e.g.contiguous())
               for e in entries]
    groups: dict = {}
    for e in entries:
        _check_entry(e, dev)
        key = (e.p.dtype, e.g.dtype, e.m.dtype, e.master is not None)
        groups.setdefault(key, []).append(e)
    ptrs = (_scalar(lr, torch.float32, dev, "lr"),
            _scalar(step, torch.int32, dev, "step"),
            None if found_inf is None else
            _scalar(found_inf, torch.int32, dev, "found_inf"),
            None if clip_scale is None else
            _scalar(clip_scale, torch.float32, dev, "clip_scale"))
    consts = (float(np.float32(beta1)), float(np.float32(beta2)),
              float(np.float32(1 - beta1)), float(np.float32(1 - beta2)),
              float(np.float32(epsilon)))
    adam = _kernel_fns()[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (pd, gd, sd, master), group in groups.items():
        table = tables.get(group, dev)
        err = adam(table.dev.data_ptr(), table.n, table.chunks, _CODES[pd],
                   _CODES[gd], _CODES[sd], int(master), *ptrs, *consts,
                   int(adamw), stream)
        _raise_on(err, "launch")
        count_launch(_NAME)


def update_bytes(entries) -> int:
    """Bytes the update must move: each operand read once (the param, or
    its master, g, m, v) and each result written once (p, m, v and the
    master)."""
    total = 0
    for e in entries:
        slots = 2 * (e.m.element_size() + e.v.element_size())
        p = (e.p.element_size() + 8 if e.master is not None
             else 2 * e.p.element_size())
        total += e.p.numel() * (p + e.g.element_size() + slots)
    return total


__all__ = ["AdamEntry", "AdamTables", "adam_reference", "multi_tensor_adam",
           "update_bytes", "weak"]
