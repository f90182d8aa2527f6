"""Hand-written Hopper kernels and their plain PyTorch versions.

Every kernel module here pairs a kernel wrapper with a plain PyTorch
version of the same function. The dispatch rule is the same for all:

- a tensor on the CPU goes to the plain version (the CPU tests run it,
  and `chip_smoke.py` holds the kernel against it on the card);
- a tensor on a CUDA device goes to the kernel, or the wrapper raises.
  Nothing falls back on CUDA, so there is no fallback counter.

Each wrapper adds one to its kernel's launch count where it launches the
kernel and nowhere else, so a run can show that its main path went
through the kernel (`kernel_launch_counts`). A CUDA graph replay runs no
Python, so the graph's owner (`jit.capture.CapturedStep`) captures with
its counts left as they were (`launches_uncounted`) and adds the
capture's launches on every replay (`add_launches`): the counts keep
meaning the launches the main path made.
"""
from __future__ import annotations

import contextlib

import torch

#: launches per kernel since the last `reset_kernel_launch_counts`
_LAUNCHES = {"paged_attention": 0, "paged_attention_int8": 0,
             "paged_attention_fp8": 0, "paged_tail_segment": 0,
             "flash_attention_qkv_fwd": 0,
             "flash_attention_qkv_bwd": 0, "flash_attention_fwd": 0,
             "flash_attention_bwd": 0, "flash_attention_qkv3_fwd": 0,
             "flash_attention_qkv3_bwd": 0, "flash_attention_lse_fwd": 0,
             "flash_attention_lse_bwd": 0, "fused_ln_fwd": 0,
             "fused_ln_bwd": 0, "multi_tensor_adam": 0}


def kernel_launch_counts() -> dict:
    """Snapshot of the per-kernel launch counts."""
    return dict(_LAUNCHES)


def reset_kernel_launch_counts():
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name: str):
    """Called by a wrapper right after its kernel launched."""
    _LAUNCHES[name] += 1


def add_launches(delta: dict):
    """Add a captured graph's launches, ``{kernel: n}``, on one replay."""
    for name, n in delta.items():
        _LAUNCHES[name] += n


@contextlib.contextmanager
def launches_uncounted():
    """Launches inside leave the counts as they were: a graph's warm-up
    and capture, whose replays count instead."""
    saved = dict(_LAUNCHES)
    try:
        yield
    finally:
        _LAUNCHES.update(saved)


#: while a graph is captured, the list its owner keeps alive (`hold`)
_HELD: list | None = None


@contextlib.contextmanager
def held_by_capture(refs: list):
    """Buffers a wrapper keeps across calls and a graph captured inside
    reads (`hold`) go to ``refs``, which the graph's owner keeps for the
    graph's life: a later, larger call may replace them in the wrapper's
    cache, and the graph must not read freed memory."""
    global _HELD
    prev, _HELD = _HELD, refs
    try:
        yield
    finally:
        _HELD = prev


def hold(t: torch.Tensor) -> torch.Tensor:
    """A wrapper's cached buffer: kept alive by the capturing owner, if
    a capture is under way. Returns ``t``."""
    if _HELD is not None:
        _HELD.append(t)
    return t


def runs_plain(t: torch.Tensor, kernel: str) -> bool:
    """The dispatch rule: True for a CPU tensor (plain version), False
    for a CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise RuntimeError(f"{kernel}: no kernel for device {t.device}")


def flash_attention_qkv_enabled(qkv, n_heads, attn_mask, dropout_p) -> bool:
    """Gate of the pair-major qkv flash path, the reference's own
    (``paddle_tpu/kernels/__init__.py:188-213`` with Pallas available):
    ``qkv [B, S, 3*H*D]``, no mask, ``0 <= dropout_p < 1``,
    ``S % 128 == 0``, and ``packed_supported`` (``flash_attention.py:
    1183``: ``d in (64, 128)``, even H, ``S <= 2048``). It does not look
    at the device: on the CPU the flash branch runs the plain version."""
    if attn_mask is not None:
        return False
    if not 0.0 <= dropout_p < 1.0:
        return False
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * n_heads):
        return False
    s, d = qkv.shape[1], qkv.shape[-1] // (3 * n_heads)
    return (s % 128 == 0 and s <= 2048 and d in (64, 128)
            and n_heads % 2 == 0)


def _mask_supported(mask, query, key) -> bool:
    """``_mask_fallback_reason`` (``paddle_tpu/kernels/__init__.py:
    100-128``) is None: a mask that needs no gradient, broadcast over
    heads, of shape ``[B|1, 1, Sq|1, Sk]``, ``[1, Sq|1, Sk]`` or
    ``[Sq|1, Sk]`` (`flash_attention.normalize_mask_bias` takes these)."""
    if mask.requires_grad:
        return False
    b, s_q, s_k = query.shape[0], query.shape[1], key.shape[1]
    shape = tuple(mask.shape)
    if len(shape) == 4:
        return (shape[1] == 1 and shape[0] in (1, b)
                and shape[2] in (1, s_q) and shape[3] == s_k)
    if len(shape) == 3:
        return shape[0] == 1 and shape[1] in (1, s_q) and shape[2] == s_k
    if len(shape) == 2:
        return shape[0] in (1, s_q) and shape[1] == s_k
    return False


def flash_attention_enabled(query, key, attn_mask, dropout_p) -> bool:
    """Gate of the general ``[B, S, H, D]`` flash path, the reference's
    own (``paddle_tpu/kernels/__init__.py:131-162`` with Pallas
    available): 4-D query, ``0 <= dropout_p < 1``, a mask the kernels
    stream (`_mask_supported`), and ``S_q % 128 == 0 and S_k % 128 ==
    0`` (``FLAGS_flash_nonmultiple_seq`` is False by default,
    ``utils/flags.py:64``). Where it refuses, the caller composes, as the
    reference does. It does not look at the device."""
    if query.dim() != 4:
        return False
    if not 0.0 <= dropout_p < 1.0:
        return False
    if attn_mask is not None and not _mask_supported(attn_mask, query, key):
        return False
    return query.shape[1] % 128 == 0 and key.shape[1] % 128 == 0


# B4's entry, re-exported as the reference's package does
# (``paddle_tpu/kernels/__init__.py:180``); imported last, since the
# module imports the helpers above
from .flash_attention import flash_attention_with_lse  # noqa: E402

__all__ = ["kernel_launch_counts", "reset_kernel_launch_counts",
           "count_launch", "add_launches", "launches_uncounted",
           "held_by_capture", "hold", "runs_plain", "flash_attention_qkv_enabled",
           "flash_attention_enabled", "flash_attention_with_lse"]
