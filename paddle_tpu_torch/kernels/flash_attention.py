"""Pair-major qkv flash attention: the Hopper kernels and their plain versions.

Counterpart: ``paddle_tpu/kernels/flash_attention.py``. The TPU kernels
``_fwd_qkv_kernel`` (:849, launched by ``_fwd_qkv`` :905) and
``_bwd_qkv_kernel`` (:876, launched by ``_bwd_qkv`` :936) are replaced by
the hand-written CUDA kernels in ``csrc/flash_attention_qkv.cu``; its
header note says how they work and what bounds them.

- `flash_attention_qkv_fwd` / `flash_attention_qkv_bwd`: the kernel
  wrappers (CUDA tensors only).
- `flash_qkv_reference` / `flash_qkv_bwd_reference`: the plain PyTorch
  versions, in float32, computing the same ``(o, lse)`` and ``dqkv``.
- `flash_attention_qkv`: the dispatcher with the contract of
  ``paddle_tpu.kernels.flash_attention.flash_attention_qkv`` (:994),
  differentiable through `_FlashQKV`.

The contract the kernels and plain versions share:

- ``qkv [B, S, 3*H*D]`` is the PAIR-MAJOR fused projection: pair ``p``'s
  q at columns ``6Dp + [0, 2D)``, k at ``6Dp + [2D, 4D)``, v at
  ``6Dp + [4D, 6D)``, head ``h`` of the pair at offset ``hD`` inside
  each (:861-864). ``o [B, S, H*D]`` is in qkv's dtype; ``lse [B, H, S]``
  is float32 (the TPU kernel's 8-row broadcast is a tiling artifact);
  ``dqkv`` is written pair-major into one ``[B, S, 3*H*D]`` tensor.
- Numerics of ``_packed_head_attn`` (:821-837): scale ``1/sqrt(D)``, the
  causal mask at ``-1e30``, the denominator ``l`` summed over the raw
  ``p`` (before dropout), ``o = (p*keep) v / max(l, 1e-30)``,
  ``lse = m + log(max(l, 1e-30))``; ``p*keep`` is rounded to v's dtype
  before the product. Backward (``_packed_head_attn_bwd`` :488-533):
  ``delta = rowsum(dO*O)``, ``p = exp(s - lse)``, ``dv = (p*keep)^T dO``,
  ``dp = (dO v^T)*keep``, ``ds = p*(dp - delta)*scale`` rounded to q's
  dtype, ``dk = ds^T q``, ``dq = ds k``.
- Dropout keeps an element where ``hash_keep_scale`` says so: the
  reference's interpret-mode hash (:90-116) of (seed, (b, pair, head),
  global query row, global key column), bit for bit. Kept elements are
  scaled by ``1/(1-p)``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build, count_launch, runs_plain
from ..core import random as _random

_SOURCE = "flash_attention_qkv"
_FWD = "flash_attention_qkv_fwd"
_BWD = "flash_attention_qkv_bwd"
_MASKED = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF
_fns = None


# ------------------------------------------------------------- dropout hash
def mix32(seed, *ids) -> int:
    """``_mix32`` (:90-98) on Python ints: uint32 hash-combine of a seed
    with block ids."""
    x = int(seed) & _M32
    for t in ids:
        t = int(t) & _M32
        x ^= (t + 0x9E3779B9 + ((x << 6) & _M32) + (x >> 2)) & _M32
    return x


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 tensors ``x < 2**32`` without
    overflowing int64: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep_scale(seed, ids, shape, dropout_p, device=None):
    """``_hash_keep_scale`` (:101-116): the keep/scale tile
    ``{0, 1/(1-p)}`` (float32) of ``shape = (rows, cols)`` for block ids
    ``ids``. torch has no uint32 arithmetic, so the hash runs in int64
    masked to 32 bits after every step; ``u`` and the comparison are
    float32 exactly as in the reference."""
    base = mix32(seed, *ids)
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    x = (base + _mul32(rows, 0x9E3779B1) + _mul32(cols, 0x85EBCA77)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * np.float32(2.0 ** -24)
    keep = torch.tensor(np.float32(1.0 - dropout_p), device=x.device)
    return torch.where(u < keep, torch.ones_like(keep) / keep,
                       torch.zeros_like(keep))


def _keep_tiles(seed, b, n_heads, s, dropout_p, device):
    """Keep/scale tiles of every (batch, head): ``[B, H, S, S]`` float32,
    ids ``(b, pair, head-in-pair)`` over the whole sequence (:865)."""
    seed = int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)
    return torch.stack([torch.stack([
        hash_keep_scale(seed, (bi, hg // 2, hg % 2), (s, s), dropout_p,
                        device) for hg in range(n_heads)])
        for bi in range(b)])


# ----------------------------------------------------------- plain versions
def _heads(qkv, n_heads):
    """Pair-major ``[B, S, 3HD]`` -> head-major float32 q, k, v
    ``[B, H, S, D]``."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    x = qkv.reshape(b, s, n_heads // 2, 3, 2, d)
    return [x[:, :, :, i].reshape(b, s, n_heads, d).permute(0, 2, 1, 3)
            .float() for i in range(3)]


def _scores(q, k, scale, causal):
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = sc.shape[-1]
        tri = torch.ones((s, s), dtype=torch.bool, device=sc.device).tril()
        sc = sc.masked_fill(~tri, _MASKED)
    return sc


def flash_qkv_reference(qkv, n_heads, causal, dropout_p=0.0, seed=None):
    """The plain version of `flash_attention_qkv_fwd`, in float32:
    ``(o [B, S, H*D] in qkv's dtype, lse [B, H, S] float32)``."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    q, k, v = _heads(qkv, n_heads)
    sc = _scores(q, k, 1.0 / math.sqrt(d), causal)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    if dropout_p:
        p = p * _keep_tiles(seed, b, n_heads, s, dropout_p, qkv.device)
    p = p.to(qkv.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, v) / l
    lse = (m + torch.log(l))[..., 0]
    o = o.permute(0, 2, 1, 3).reshape(b, s, n_heads * d)
    return o.to(qkv.dtype), lse


def flash_qkv_bwd_reference(qkv, do, o, lse, n_heads, causal, dropout_p=0.0,
                            seed=None):
    """The plain version of `flash_attention_qkv_bwd`, in float32:
    ``dqkv [B, S, 3*H*D]`` pair-major, in qkv's dtype."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    scale = 1.0 / math.sqrt(d)
    q, k, v = _heads(qkv, n_heads)

    def hm(t):
        return t.reshape(b, s, n_heads, d).permute(0, 2, 1, 3).float()

    dof, of = hm(do), hm(o)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v)
    pd = p
    if dropout_p:
        keep = _keep_tiles(seed, b, n_heads, s, dropout_p, qkv.device)
        pd = p * keep
        dp = dp * keep
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(do.dtype).float(), dof)
    ds = (p * (dp - delta) * scale).to(qkv.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k)
    parts = [t.permute(0, 2, 1, 3).reshape(b, s, n_heads // 2, 2 * d)
             for t in (dq, dk, dv)]
    return torch.stack(parts, dim=3).reshape(b, s, hd3).to(qkv.dtype)


# ---------------------------------------------------------- kernel wrappers
def _kernel_fns():
    """``(fwd, bwd, error_string)``: the C entry points with their
    argument types declared (pointers and the stream as ``c_void_p``)."""
    global _fns
    if _fns is None:
        lib = _build.load(_SOURCE)
        fwd = lib.ptt_flash_qkv_fwd
        fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        bwd = lib.ptt_flash_qkv_bwd
        bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p])
        bwd.restype = ctypes.c_int
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns = (fwd, bwd, err_str)
    return _fns


def _check(cond, kernel, msg):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_qkv(kernel, qkv, n_heads, dropout_p, seed):
    """Shape, dtype and device checks shared by both wrappers; returns
    ``(b, s, d)``."""
    _check(qkv.device.type == "cuda", kernel,
           f"needs CUDA tensors, got {qkv.device}")
    _check(qkv.dim() == 3 and qkv.shape[-1] % (3 * n_heads) == 0, kernel,
           f"qkv must be [B, S, 3*H*D] with H={n_heads}, got "
           f"{tuple(qkv.shape)}")
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    _check(d in (64, 128), kernel, f"head_dim must be 64 or 128, got {d}")
    _check(n_heads % 2 == 0, kernel, f"head count must be even, got "
           f"{n_heads}")
    _check(s % 64 == 0 and s > 0, kernel,
           f"seq_len must be a positive multiple of 64, got {s}")
    _check(qkv.dtype in _DTYPE_CODES, kernel,
           f"dtype must be float32 or bfloat16, got {qkv.dtype}")
    _check(qkv.is_contiguous() and qkv.data_ptr() % 16 == 0, kernel,
           "qkv must be contiguous and 16-byte aligned")
    _check(0.0 <= dropout_p < 1.0, kernel,
           f"dropout_p must lie in [0, 1), got {dropout_p}")
    if dropout_p:
        _check(seed is not None and seed.device == qkv.device
               and seed.dtype == torch.int32 and seed.numel() >= 1, kernel,
               "dropout needs an int32 seed tensor on qkv's device")
    return b, s, d


def _raise_on(err, kernel):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}"
                           f" ({_kernel_fns()[2](err).decode()})")


def flash_attention_qkv_fwd(qkv, n_heads, causal, dropout_p=0.0, seed=None):
    """Launch the forward kernel on ``qkv [B, S, 3*H*D]`` (CUDA,
    contiguous, float32 or bfloat16; D 64 or 128, H even, S a multiple
    of 64). ``seed``: int32 ``[1]`` tensor on the same device, needed
    when ``dropout_p > 0``. Returns ``(o [B, S, H*D], lse [B, H, S])``."""
    b, s, d = _check_qkv(_FWD, qkv, n_heads, dropout_p, seed)
    o = torch.empty((b, s, n_heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, n_heads, s), dtype=torch.float32,
                      device=qkv.device)
    fwd, _, _ = _kernel_fns()
    err = fwd(qkv.data_ptr(), seed.data_ptr() if dropout_p else None,
              o.data_ptr(), lse.data_ptr(), b, s, n_heads, d, int(causal),
              int(dropout_p > 0), float(np.float32(1.0 - dropout_p)),
              float(np.float32(1.0 / math.sqrt(d))), _DTYPE_CODES[qkv.dtype],
              qkv.device.index, torch.cuda.current_stream(qkv.device)
              .cuda_stream)
    _raise_on(err, _FWD)
    count_launch(_FWD)
    return o, lse


def flash_attention_qkv_bwd(qkv, do, o, lse, n_heads, causal, dropout_p=0.0,
                            seed=None):
    """Launch the backward kernels: ``dqkv [B, S, 3*H*D]`` (pair-major,
    qkv's dtype) from the forward's ``qkv``, ``o``, ``lse`` and the
    cotangent ``do [B, S, H*D]`` (qkv's dtype). One call runs the
    ``delta = rowsum(dO*O)`` pre-pass, the dk/dv pass and the dq pass;
    it counts as one launch of the backward."""
    b, s, d = _check_qkv(_BWD, qkv, n_heads, dropout_p, seed)
    for name, t, shape, dt in (("do", do, (b, s, n_heads * d), qkv.dtype),
                               ("o", o, (b, s, n_heads * d), qkv.dtype),
                               ("lse", lse, (b, n_heads, s), torch.float32)):
        _check(t.device == qkv.device and tuple(t.shape) == shape
               and t.dtype == dt and t.is_contiguous(), _BWD,
               f"{name} must be contiguous {dt} {shape} on {qkv.device}, got "
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check(do.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0, _BWD,
           "do and o must be 16-byte aligned")
    delta = torch.empty((b, n_heads, s), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    _, bwd, _ = _kernel_fns()
    err = bwd(qkv.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
              seed.data_ptr() if dropout_p else None, delta.data_ptr(),
              dqkv.data_ptr(), b, s, n_heads, d, int(causal),
              int(dropout_p > 0), float(np.float32(1.0 - dropout_p)),
              float(np.float32(1.0 / math.sqrt(d))), _DTYPE_CODES[qkv.dtype],
              qkv.device.index, torch.cuda.current_stream(qkv.device)
              .cuda_stream)
    _raise_on(err, _BWD)
    count_launch(_BWD)
    return dqkv


# ----------------------------------------------------------------- autograd
class _FlashQKV(torch.autograd.Function):
    """``custom_vjp`` of ``_flash_qkv_p`` (:974-985): forward saves
    ``(qkv, o, lse, seed)``, backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, qkv, seed, n_heads, causal, dropout_p):
        if runs_plain(qkv, _FWD):
            o, lse = flash_qkv_reference(qkv, n_heads, causal, dropout_p,
                                         seed)
        else:
            o, lse = flash_attention_qkv_fwd(qkv, n_heads, causal,
                                             dropout_p, seed)
        ctx.save_for_backward(qkv, o, lse, seed)
        ctx.cfg = (n_heads, causal, dropout_p)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse, seed = ctx.saved_tensors
        n_heads, causal, dropout_p = ctx.cfg
        do = do.to(qkv.dtype).contiguous()
        if runs_plain(qkv, _BWD):
            dqkv = flash_qkv_bwd_reference(qkv, do, o, lse, n_heads, causal,
                                           dropout_p, seed)
        else:
            dqkv = flash_attention_qkv_bwd(qkv, do, o, lse, n_heads, causal,
                                           dropout_p, seed)
        return dqkv, None, None, None, None


def flash_attention_qkv(qkv, n_heads, is_causal=False, dropout_p=0.0,
                        seed=None, generator=None):
    """Flash attention straight off the pair-major fused projection
    ``[B, S, 3*H*D]`` -> ``[B, S, H*D]``, differentiable. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernels (or the
    wrappers raise). ``dropout_p``: in-kernel attention dropout, seeded
    by ``seed`` (an int or an int32 tensor) or, when None, by a draw
    from ``generator`` (default: the current `core.random` generator)."""
    seed_t = None
    if dropout_p > 0.0:
        if seed is None:
            gen = generator or _random.current_generator(qkv.device)
            seed_t = _random.flash_seed(gen)
        else:
            seed_t = torch.as_tensor(seed).reshape(-1)[:1].to(
                device=qkv.device, dtype=torch.int32)
    if not runs_plain(qkv, _FWD):
        qkv = qkv.contiguous()
    return _FlashQKV.apply(qkv, seed_t, int(n_heads), bool(is_causal),
                           float(dropout_p))


__all__ = ["mix32", "hash_keep_scale", "flash_qkv_reference",
           "flash_qkv_bwd_reference", "flash_attention_qkv_fwd",
           "flash_attention_qkv_bwd", "flash_attention_qkv"]
