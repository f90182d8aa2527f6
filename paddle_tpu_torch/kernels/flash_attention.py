"""Flash attention: the Hopper kernels and their plain versions.

Counterpart: ``paddle_tpu/kernels/flash_attention.py``. Three families of
TPU kernels there are replaced by hand-written CUDA kernels here; the
header note of each source says how they work and what bounds them.

B1, the pair-major qkv kernels: ``_fwd_qkv_kernel`` (:849, launched by
``_fwd_qkv`` :905) in ``csrc/flash_attention_qkv.cu``; ``_bwd_qkv_kernel``
(:876, launched by ``_bwd_qkv`` :936) by B2's backward in
``csrc/flash_attention.cu``, over the projection as it lies, its columns
from `qkv_columns`.

- `flash_attention_qkv_fwd` / `flash_attention_qkv_bwd`: the kernel
  wrappers (CUDA tensors only).
- `flash_qkv_reference` / `flash_qkv_bwd_reference`: the plain PyTorch
  versions, in float32, computing the same ``(o, lse)`` and ``dqkv``.
- `flash_attention_qkv`: the dispatcher with the contract of
  ``paddle_tpu.kernels.flash_attention.flash_attention_qkv`` (:994),
  differentiable through `_FlashQKV`.

B5, the which-major qkv3 kernels (the same sources, the layout a
template parameter of the forward and a column rule of the backward):
``_fwd_qkv3_kernel`` (:1018, via ``_fwd_qkv3`` :1071) and
``_bwd_qkv3_kernel`` (:1044, via ``_bwd_qkv3`` :1107).

- `flash_attention_qkv3_fwd` / `flash_attention_qkv3_bwd`: the kernel
  wrappers, reading the ``[q|k|v]`` projection as it lies and writing a
  which-major ``dqkv``.
- `flash_qkv3_reference` / `flash_qkv3_bwd_reference`: the plain
  versions (B1's plain math on the repacked projection).
- `flash_attention_qkv3` (:1167), differentiable through `_FlashQKV3`,
  and `flash_attention_packed` (:1194).

B2, the general ``[B, S, H, D]`` kernels (``csrc/flash_attention.cu``):
``_fwd_kernel`` (:207, via ``_fwd`` :319), ``_merged_bwd_kernel`` (:536,
via ``_bwd_merged`` :575), ``_dq_kernel`` (:375) and ``_dkdv_kernel``
(:427, both via ``_bwd`` :622). One backward covers the last three: the
TPU's merged/split choice is a VMEM artifact.

- `flash_attention_fwd` / `flash_attention_bwd`: the kernel wrappers.
- `flash_reference` / `flash_bwd_reference`: the plain versions.
- `flash_attention`: the entry with the contract of
  ``flash_attention_fwd`` (:1219-1286), differentiable through `_Flash`;
  `normalize_mask_bias` (:173-200) and `pick_block` (:1211-1216) are the
  reference's mask and block rules.

B4, flash attention with a differentiable lse (``_flash_lse`` :767-784:
``_fwd`` :319, then ``_bwd_merged`` :575 with ``has_dlse``, body :536):
B2's kernels, the lse cotangent folded into the backward's delta
pre-pass (``csrc/flash_common.cuh``).

- `flash_attention_lse_fwd` / `flash_attention_lse_bwd`: the kernel
  wrappers, counted under their own names.
- `flash_reference` / `flash_bwd_reference` (``dlse=``): the plain
  versions.
- `flash_attention_with_lse` (:787-815): ``(o, lse)``, both
  differentiable through `_FlashLse`; the chunk kernel of the
  sequence-parallel ring (`distributed.sequence_parallel`).

The contract every kernel and plain version here shares:

- Numerics of ``_packed_head_attn`` / ``_fwd_kernel``: ``s = q.k *
  scale`` in float32 (scale ``1/sqrt(D)`` of the real D), an additive
  bias added (B2), causal positions (bottom-right aligned, ``off = S_k -
  S_q``) and keys past S_k replaced by ``-1e30``; the denominator ``l``
  summed over the raw ``p`` (before dropout), ``o = (p*keep) v /
  max(l, 1e-30)``, ``lse = m + log(max(l, 1e-30))``; ``p*keep`` is
  rounded to v's dtype before the product. Backward
  (``_packed_head_attn_bwd`` :488-533): ``delta = rowsum(dO*O)``,
  ``p = exp(s - lse)``, ``dv = (p*keep)^T dO``, ``dp = (dO v^T)*keep``,
  ``ds = p*(dp - delta)*scale`` rounded to q's dtype, ``dk = ds^T q``,
  ``dq = ds k``. A mask bias gets no gradient (:744-752). B4 adds the lse
  cotangent inside ds, ``p*(dp - delta + dlse)`` (:525-527), as ``delta
  - dlse``.
- ``lse`` is float32 ``[B, H, S_q]`` (the TPU kernels' 8-row broadcast
  is a tiling artifact).
- Dropout keeps an element where ``hash_keep_scale`` says so: the
  reference's interpret-mode hash (:90-116), bit for bit. B1 and B5
  hash (seed, `qkv_drop_ids`) over the whole sequence; B2 hashes (seed,
  (b*H + h, row // bq, col // bk)) at (row % bq, col % bk), with the
  reference's block sizes ``bq``, ``bk`` (`pick_block`). Kept elements
  are scaled by ``1/(1-p)``.
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
_FWD3 = "flash_attention_qkv3_fwd"
_BWD3 = "flash_attention_qkv3_bwd"
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
    return _keep_of(base + _mul32(rows, 0x9E3779B1)
                    + _mul32(cols, 0x85EBCA77), dropout_p)


def _hash24(x):
    """The avalanche of ``_hash_keep_scale`` on int64 ``x = base +
    row*C1 + col*C2`` (not yet reduced mod 2**32): its top 24 bits."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >> 8


def keep_threshold(dropout_p) -> int:
    """The integer keep threshold of the B2 kernels
    (``keep_threshold`` in ``csrc/flash_common.cuh``): ``bits * 2**-24 <
    keep`` exactly when ``bits < ceil(keep * 2**24)``, keep = ``1 - p``
    rounded to float32."""
    return math.ceil(float(np.float32(1.0 - dropout_p)) * 2.0 ** 24)


def _keep_of(x, dropout_p):
    """The keep/scale of ``_hash_keep_scale`` on int64 ``x = base +
    row*C1 + col*C2``: ``u = bits * 2**-24`` compared with keep in
    float32, as the reference does."""
    u = _hash24(x).to(torch.float32) * np.float32(2.0 ** -24)
    keep = torch.tensor(np.float32(1.0 - dropout_p), device=x.device)
    return torch.where(u < keep, torch.ones_like(keep) / keep,
                       torch.zeros_like(keep))


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if torch.is_tensor(seed) else int(seed)


def qkv_drop_ids(b, h):
    """The qkv kernels' dropout ids of head ``h`` of batch row ``b``,
    ``(b, pair, head in pair)``, as ``_fwd_qkv_kernel`` and
    ``_fwd_qkv3_kernel`` hash them (:865, :1031) for head ``2*pair +
    head``; the backward kernel forms the same (``tile_drop`` with
    ``head_ids`` in ``csrc/flash_attention.cu``)."""
    return b, h // 2, h % 2


def _keep_tiles(seed, b, n_heads, s, dropout_p, device):
    """Keep/scale tiles of every (batch, head): ``[B, H, S, S]`` float32,
    ids `qkv_drop_ids` over the whole sequence."""
    seed = _seed_int(seed)
    return torch.stack([torch.stack([
        hash_keep_scale(seed, qkv_drop_ids(bi, hg), (s, s), dropout_p,
                        device) for hg in range(n_heads)])
        for bi in range(b)])


def _block_keep(seed, n_bh, s_q, s_k, bq, bk, dropout_p, device):
    """B2's keep/scale of every score, ``[B*H, S_q, S_k]`` float32: score
    (r, c) of head ``i = b*H + h`` takes the tile of ids ``(i, r // bq,
    c // bk)`` at ``(r % bq, c % bk)`` (``_fwd_kernel`` :256; the merged
    backward's ``(i, 0, 0)``, :563, is the same when one block covers the
    sequence)."""
    x = torch.full((n_bh, 1, 1), _seed_int(seed) & _M32, dtype=torch.int64,
                   device=device)
    r = torch.arange(s_q, dtype=torch.int64, device=device)
    c = torch.arange(s_k, dtype=torch.int64, device=device)
    for t in (torch.arange(n_bh, dtype=torch.int64, device=device)[:, None,
                                                                   None],
              (r // bq)[None, :, None], (c // bk)[None, None, :]):
        x = x ^ ((t + 0x9E3779B9 + ((x << 6) & _M32) + (x >> 2)) & _M32)
    return _keep_of(x + _mul32(r % bq, 0x9E3779B1)[None, :, None]
                    + _mul32(c % bk, 0x85EBCA77)[None, None, :], dropout_p)


# ----------------------------------------------------------- plain versions
def _heads(qkv, n_heads):
    """Pair-major ``[B, S, 3HD]`` -> head-major float32 q, k, v
    ``[B, H, S, D]``."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    x = qkv.reshape(b, s, n_heads // 2, 3, 2, d)
    return [x[:, :, :, i].reshape(b, s, n_heads, d).permute(0, 2, 1, 3)
            .float() for i in range(3)]


def _scores(q, k, scale, causal, bias=None):
    """``q.k * scale`` over head-major ``[B, H, S, D]`` float32 tensors,
    plus the ``[Bm, Sqm, Sk]`` bias, then ``-1e30`` past the bottom-right
    causal diagonal."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        sc = sc + bias[:, None]
    if causal:
        s_q, s_k = sc.shape[-2], sc.shape[-1]
        tri = torch.ones((s_q, s_k), dtype=torch.bool,
                         device=sc.device).tril(s_k - s_q)
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


def _which_to_pair(qkv, n_heads):
    """Which-major ``[B, S, 3HD]`` (``[q|k|v]`` regions) -> pair-major
    (``[pair: q|k|v]``), a copy."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    return (qkv.reshape(b, s, 3, n_heads // 2, 2 * d).transpose(2, 3)
            .reshape(b, s, hd3))


def _pair_to_which(qkv, n_heads):
    """The inverse of `_which_to_pair`."""
    b, s, hd3 = qkv.shape
    d = hd3 // (3 * n_heads)
    return (qkv.reshape(b, s, n_heads // 2, 3, 2 * d).transpose(2, 3)
            .reshape(b, s, hd3))


def flash_qkv3_reference(qkv, n_heads, causal, dropout_p=0.0, seed=None):
    """The plain version of `flash_attention_qkv3_fwd`: B1's plain math on
    the repacked projection (the two kernels compute the same function
    with the same dropout ids). ``(o [B, S, H*D], lse [B, H, S]
    float32)``."""
    return flash_qkv_reference(_which_to_pair(qkv, n_heads), n_heads, causal,
                               dropout_p, seed)


def flash_qkv3_bwd_reference(qkv, do, o, lse, n_heads, causal, dropout_p=0.0,
                             seed=None):
    """The plain version of `flash_attention_qkv3_bwd`: ``dqkv [B, S,
    3*H*D]`` which-major (``[dq|dk|dv]``), in qkv's dtype."""
    dqkv = flash_qkv_bwd_reference(_which_to_pair(qkv, n_heads), do, o, lse,
                                   n_heads, causal, dropout_p, seed)
    return _pair_to_which(dqkv, n_heads)


# ---------------------------------------------------------- kernel wrappers
_ENTRIES = {_FWD: "ptt_flash_qkv_fwd", _FWD3: "ptt_flash_qkv3_fwd"}
_LAYOUTS = {_BWD: "pair", _BWD3: "which"}


def qkv_columns(layout, n_heads, d):
    """Where each head's q, k and v lie in the fused projection ``[B, S,
    3*H*D]`` (and in its gradient), as the backward kernel takes them:
    ``(group, stride, q, k, v)``, head ``h``'s columns starting at ``(h //
    group) * stride + (h % group) * d`` plus ``q``, ``k`` or ``v``.
    ``layout`` "pair" (B1, ``[pair: q|k|v]``: heads in pairs 6d apart, q,
    k and v 2d apart in a pair) or "which" (B5, ``[q|k|v]`` regions H*d
    wide, heads d apart)."""
    if layout == "pair":
        return 2, 6 * d, 0, 2 * d, 4 * d
    return 1, d, 0, n_heads * d, 2 * n_heads * d


def _kernel_fns():
    """``({kernel: C entry}, error_string)`` of the qkv forwards, the
    argument types declared (pointers and the stream as ``c_void_p``)."""
    global _fns
    if _fns is None:
        lib = _build.load(_SOURCE)
        shape = [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
        fns = {}
        for kernel, entry in _ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p] * 4 + shape + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[kernel] = fn
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fns = (fns, err_str)
    return _fns


def _check(cond, kernel, msg):
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def _check_qkv(kernel, qkv, n_heads, dropout_p, seed):
    """Shape, dtype and device checks shared by the qkv wrappers; returns
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


def _raise_on(err, kernel, err_str):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}"
                           f" ({err_str(err).decode()})")


def _launch_fwd(kernel, qkv, n_heads, causal, dropout_p, seed):
    """One forward launch of ``kernel`` (`_FWD` or `_FWD3`)."""
    b, s, d = _check_qkv(kernel, qkv, n_heads, dropout_p, seed)
    o = torch.empty((b, s, n_heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, n_heads, s), dtype=torch.float32,
                      device=qkv.device)
    fns, err_str = _kernel_fns()
    err = fns[kernel](
        qkv.data_ptr(), seed.data_ptr() if dropout_p else None, o.data_ptr(),
        lse.data_ptr(), b, s, n_heads, d, int(causal), int(dropout_p > 0),
        float(np.float32(1.0 - dropout_p)),
        float(np.float32(1.0 / math.sqrt(d))), _DTYPE_CODES[qkv.dtype],
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on(err, kernel, err_str)
    count_launch(kernel)
    return o, lse


def _launch_bwd(kernel, qkv, do, o, lse, n_heads, causal, dropout_p, seed):
    """One backward launch of ``kernel`` (`_BWD` or `_BWD3`): B2's
    backward (``ptt_flash_qkv_bwd``) over the projection as it lies, its
    columns from `qkv_columns`. bfloat16: the delta pre-pass (the
    float32 dq accumulator zeroed), the one-pass kernel and the dq
    post-pass; float32: delta, then dk/dv, then dq."""
    b, s, d = _check_qkv(kernel, qkv, n_heads, dropout_p, seed)
    for name, t, shape, dt in (("do", do, (b, s, n_heads * d), qkv.dtype),
                               ("o", o, (b, s, n_heads * d), qkv.dtype),
                               ("lse", lse, (b, n_heads, s), torch.float32)):
        _check(t.device == qkv.device and tuple(t.shape) == shape
               and t.dtype == dt and t.is_contiguous(), kernel,
               f"{name} must be contiguous {dt} {shape} on {qkv.device}, got "
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check(do.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0, kernel,
           "do and o must be 16-byte aligned")
    delta = torch.empty((b, n_heads, s), dtype=torch.float32,
                        device=qkv.device)
    dq_acc = (torch.empty((b, s, n_heads, d), dtype=torch.float32,
                          device=qkv.device)
              if qkv.dtype == torch.bfloat16 else None)
    dqkv = torch.empty_like(qkv)
    _, _, qkv_bwd, err_str = _gen_kernel_fns()
    err = qkv_bwd(
        qkv.data_ptr(), do.data_ptr(), o.data_ptr(), lse.data_ptr(),
        seed.data_ptr() if dropout_p else None, delta.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), dqkv.data_ptr(), b,
        s, n_heads, d, *qkv_columns(_LAYOUTS[kernel], n_heads, d),
        int(causal), int(dropout_p > 0), float(np.float32(1.0 - dropout_p)),
        float(np.float32(1.0 / math.sqrt(d))), _DTYPE_CODES[qkv.dtype],
        qkv.device.index, torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise_on(err, kernel, err_str)
    count_launch(kernel)
    return dqkv


def flash_attention_qkv_fwd(qkv, n_heads, causal, dropout_p=0.0, seed=None):
    """Launch the forward kernel on the pair-major ``qkv [B, S, 3*H*D]``
    (CUDA, contiguous, float32 or bfloat16; D 64 or 128, H even, S a
    multiple of 64). ``seed``: int32 ``[1]`` tensor on the same device,
    needed when ``dropout_p > 0``. Returns ``(o [B, S, H*D], lse [B, H,
    S])``."""
    return _launch_fwd(_FWD, qkv, n_heads, causal, dropout_p, seed)


def flash_attention_qkv_bwd(qkv, do, o, lse, n_heads, causal, dropout_p=0.0,
                            seed=None):
    """Launch the backward kernels: ``dqkv [B, S, 3*H*D]`` (pair-major,
    qkv's dtype) from the forward's ``qkv``, ``o``, ``lse`` and the
    cotangent ``do [B, S, H*D]`` (qkv's dtype). One call runs the
    general backward's passes (`_launch_bwd`) over the projection; it
    counts as one launch of the backward."""
    return _launch_bwd(_BWD, qkv, do, o, lse, n_heads, causal, dropout_p,
                       seed)


def flash_attention_qkv3_fwd(qkv, n_heads, causal, dropout_p=0.0, seed=None):
    """`flash_attention_qkv_fwd` on the WHICH-major ``qkv [B, S, 3*H*D]``
    (``[q|k|v]`` regions), read as it lies."""
    return _launch_fwd(_FWD3, qkv, n_heads, causal, dropout_p, seed)


def flash_attention_qkv3_bwd(qkv, do, o, lse, n_heads, causal, dropout_p=0.0,
                             seed=None):
    """`flash_attention_qkv_bwd` on the which-major ``qkv``: ``dqkv`` is
    which-major too (``[dq|dk|dv]``, written in place of the reference's
    concatenate)."""
    return _launch_bwd(_BWD3, qkv, do, o, lse, n_heads, causal, dropout_p,
                       seed)


# ----------------------------------------------------------------- autograd
#: per layout: (forward kernel, backward kernel, plain forward, plain
#: backward, kernel forward, kernel backward)
_VARIANTS = {
    "pair": (_FWD, _BWD, flash_qkv_reference, flash_qkv_bwd_reference,
             flash_attention_qkv_fwd, flash_attention_qkv_bwd),
    "which": (_FWD3, _BWD3, flash_qkv3_reference, flash_qkv3_bwd_reference,
              flash_attention_qkv3_fwd, flash_attention_qkv3_bwd),
}


def _qkv_forward(ctx, layout, qkv, seed, n_heads, causal, dropout_p):
    fwd_k, _, plain_fwd, _, kernel_fwd, _ = _VARIANTS[layout]
    run = plain_fwd if runs_plain(qkv, fwd_k) else kernel_fwd
    o, lse = run(qkv, n_heads, causal, dropout_p, seed)
    ctx.save_for_backward(qkv, o, lse, seed)
    ctx.cfg = (n_heads, causal, dropout_p)
    return o


def _qkv_backward(ctx, layout, do):
    _, bwd_k, _, plain_bwd, _, kernel_bwd = _VARIANTS[layout]
    qkv, o, lse, seed = ctx.saved_tensors
    n_heads, causal, dropout_p = ctx.cfg
    do = do.to(qkv.dtype).contiguous()
    run = plain_bwd if runs_plain(qkv, bwd_k) else kernel_bwd
    dqkv = run(qkv, do, o, lse, n_heads, causal, dropout_p, seed)
    return dqkv, None, None, None, None


class _FlashQKV(torch.autograd.Function):
    """``custom_vjp`` of ``_flash_qkv_p`` (:974-985): forward saves
    ``(qkv, o, lse, seed)``, backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, qkv, seed, n_heads, causal, dropout_p):
        return _qkv_forward(ctx, "pair", qkv, seed, n_heads, causal,
                            dropout_p)

    @staticmethod
    def backward(ctx, do):
        return _qkv_backward(ctx, "pair", do)


class _FlashQKV3(torch.autograd.Function):
    """``custom_vjp`` of ``_flash_qkv3_p`` (:1147-1158), the same contract
    on the which-major projection."""

    @staticmethod
    def forward(ctx, qkv, seed, n_heads, causal, dropout_p):
        return _qkv_forward(ctx, "which", qkv, seed, n_heads, causal,
                            dropout_p)

    @staticmethod
    def backward(ctx, do):
        return _qkv_backward(ctx, "which", do)


def _seed_tensor(seed, generator, device, dropout_p):
    """The int32 ``[1]`` dropout seed on ``device`` (None without
    dropout): ``seed`` (an int or a tensor) or, when None, a draw from
    ``generator`` (default: the current `core.random` generator)."""
    if dropout_p <= 0.0:
        return None
    if seed is None:
        return _random.flash_seed(generator
                                  or _random.current_generator(device))
    return torch.as_tensor(seed).reshape(-1)[:1].to(device=device,
                                                    dtype=torch.int32)


def _apply_qkv(fn, kernel, qkv, n_heads, is_causal, dropout_p, seed,
               generator):
    seed_t = _seed_tensor(seed, generator, qkv.device, dropout_p)
    if not runs_plain(qkv, kernel):
        qkv = qkv.contiguous()
    return fn.apply(qkv, seed_t, int(n_heads), bool(is_causal),
                    float(dropout_p))


def flash_attention_qkv(qkv, n_heads, is_causal=False, dropout_p=0.0,
                        seed=None, generator=None):
    """Flash attention straight off the pair-major fused projection
    ``[B, S, 3*H*D]`` -> ``[B, S, H*D]``, differentiable. A CPU tensor
    runs the plain version; a CUDA tensor launches the kernels (or the
    wrappers raise). ``dropout_p``: in-kernel attention dropout, seeded
    by ``seed`` (an int or an int32 tensor) or, when None, by a draw
    from ``generator`` (default: the current `core.random` generator)."""
    return _apply_qkv(_FlashQKV, _FWD, qkv, n_heads, is_causal, dropout_p,
                      seed, generator)


def flash_attention_qkv3(qkv, n_heads, is_causal=False, dropout_p=0.0,
                         seed=None, generator=None):
    """Flash attention on a WHICH-major fused projection ``[B, S, 3*H*D]``
    (``[q|k|v]`` regions, head ``h`` at columns ``hD`` of each) ->
    ``[B, S, H*D]``, differentiable (``flash_attention_qkv3`` :1167). A
    CUDA tensor launches the B5 kernels on the projection as it lies; a
    CPU tensor runs the plain version. Dropout as in
    `flash_attention_qkv`, with the same ids: a head drops the same
    elements in both layouts."""
    return _apply_qkv(_FlashQKV3, _FWD3, qkv, n_heads, is_causal, dropout_p,
                      seed, generator)


def packed_supported(s_q, s_k, n_heads, d):
    """``packed_supported`` (:1183-1191): the shapes the qkv kernels take
    (self-attention, ``S <= 2048``, D 64 or 128, an even head count)."""
    return s_q == s_k and s_q <= 2048 and d in (64, 128) and n_heads % 2 == 0


def flash_attention_packed(query, key, value, n_heads, is_causal=False):
    """Flash attention on the projection layout ``[B, S, H*D]`` (D 64 or
    128; :1194-1208): the three projections are concatenated into the
    which-major layout and run through `flash_attention_qkv3`. Where the
    projections come from one fused matmul, call that directly."""
    return flash_attention_qkv3(torch.cat([query, key, value], dim=-1),
                                n_heads, is_causal)


# =================================================== B2: [B, S, H, D]
_GEN_SOURCE = "flash_attention"
_GEN_FWD = "flash_attention_fwd"
_GEN_BWD = "flash_attention_bwd"
DEFAULT_BLOCK = 1024        # the reference's DEFAULT_BLOCK_Q/K (:39-40)
_gen_fns = None


def normalize_mask_bias(mask):
    """``_normalize_mask_bias`` (:173-200): a mask of shape ``[B|1, 1,
    Sq|1, Sk]``, ``[1, Sq|1, Sk]`` or ``[Sq|1, Sk]`` as the additive
    float32 bias ``[Bm, Sqm, Sk]``; a bool mask (True = attend) becomes
    0 / -1e9. A head-varying mask raises: the sdpa gate sends it to the
    composition, and a direct caller must not get head 0's mask applied
    to every head."""
    if mask.dim() == 4:
        if mask.shape[1] != 1:
            raise ValueError(
                "flash attention masks must broadcast over heads (4D shape "
                f"[B|1, 1, Sq|1, Sk]); got head dim {mask.shape[1]} in "
                f"{tuple(mask.shape)}. Per-head masks need the composition "
                "(scaled_dot_product_attention routes them there)")
        mask = mask[:, 0]
    elif mask.dim() == 2:
        mask = mask[None]
    elif mask.dim() != 3:
        raise ValueError(f"unsupported attention mask ndim {mask.dim()} "
                         "(expected 2, 3 or 4)")
    if mask.dtype == torch.bool:
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        return torch.where(mask, zero, zero - 1e9)
    return mask.float()


def pick_block(limit, seq):
    """``_pick_block`` (:1211-1216): the largest multiple of 128 that
    divides ``seq`` and is at most ``limit`` (128 at least)."""
    cand = min(limit, seq) // 128 * 128
    while cand > 128 and seq % cand:
        cand -= 128
    return max(cand, 128)


def kernel_head_dim(d):
    """The head dim B2's and B4's kernels run a head dim ``d`` at: 64 or
    128 at and below 128, else the next multiple of 64 (bfloat16 runs
    the wgmma kernels up to 256, the kernels sliced over D above; float32
    the sliced kernels above 128). The wrappers zero-pad q, k and v to
    it and cut the output back; zero columns change neither the scores
    nor the outputs (the reference pads to a multiple of 128,
    ``:1263-1267``)."""
    if d <= 64:
        return 64
    if d <= 128:
        return 128
    return -(-d // 64) * 64


def _pad_heads(tensors, dk):
    """``tensors`` zero-padded along the head dim to ``dk`` (contiguous
    as they are when already at it)."""
    return tuple(torch.nn.functional.pad(t, (0, dk - t.shape[-1]))
                 if t.shape[-1] != dk else t.contiguous() for t in tensors)


def _blocks(s_q, s_k, block_q=DEFAULT_BLOCK, block_k=DEFAULT_BLOCK):
    """The reference's block sizes for these lengths (:1250-1252): the
    tiling that places B2's dropout hash."""
    return (pick_block(block_q, -(-s_q // 128) * 128),
            pick_block(block_k, -(-s_k // 128) * 128))


def flash_reference(q, k, v, causal, bias=None, dropout_p=0.0, seed=None,
                    bq=None, bk=None, scale=None):
    """The plain version of `flash_attention_fwd`, in float32: ``(o [B,
    Sq, H, D] in q's dtype, lse [B, H, Sq] float32)``. ``bias``: float32
    ``[Bm, Sqm, Sk]``; ``bq``/``bk``: the reference's blocks (default:
    its default tiling); ``scale``: default ``1/sqrt(D)``."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))
    sc = _scores(qh, kh, scale, causal, bias)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    if dropout_p:
        dbq, dbk = _blocks(s_q, s_k)
        p = p * _block_keep(seed, b * h, s_q, s_k, bq or dbq, bk or dbk,
                            dropout_p, q.device).reshape(b, h, s_q, s_k)
    p = p.to(v.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh) / l
    lse = (m + torch.log(l))[..., 0]
    return o.transpose(1, 2).contiguous().to(q.dtype), lse


def flash_bwd_reference(q, k, v, o, lse, do, causal, bias=None,
                        dropout_p=0.0, seed=None, bq=None, bk=None,
                        scale=None, dlse=None):
    """The plain version of `flash_attention_bwd`, in float32: ``(dq, dk,
    dv)`` shaped and typed as ``q``, ``k``, ``v``. ``dlse``: the float32
    ``[B, H, Sq]`` cotangent of the forward's lse (B4), folded into delta
    as the kernels fold it."""
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    qh, kh, vh, dof, of = (t.float().transpose(1, 2)
                           for t in (q, k, v, do, o))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.float()[..., None]
    p = torch.exp(_scores(qh, kh, scale, causal, bias) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vh)
    pd = p
    if dropout_p:
        dbq, dbk = _blocks(s_q, s_k)
        keep = _block_keep(seed, b * h, s_q, s_k, bq or dbq, bk or dbk,
                           dropout_p, q.device).reshape(b, h, s_q, s_k)
        pd = p * keep
        dp = dp * keep
    dv = torch.einsum("bhqk,bhqd->bhkd", pd.to(do.dtype).float(), dof)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
    return tuple(t.transpose(1, 2).contiguous().to(ref.dtype)
                 for t, ref in ((dq, q), (dk, k), (dv, v)))


def _gen_kernel_fns():
    """``(fwd, bwd, qkv_bwd, error_string)`` of
    ``csrc/flash_attention.cu``."""
    global _gen_fns
    if _gen_fns is None:
        lib = _build.load(_GEN_SOURCE)
        # B, Sq, Sk, H, D, bias_b, bias_q, causal, use_drop; keep, scale;
        # bq, bk, dtype, device
        shape = [ctypes.c_int] * 9 + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
        fwd = lib.ptt_flash_fwd
        fwd.argtypes = [ctypes.c_void_p] * 7 + shape + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.ptt_flash_bwd
        bwd.argtypes = [ctypes.c_void_p] * 14 + shape + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        # B, S, H, D, group, stride, q, k, v, causal, use_drop; keep,
        # scale; dtype, device
        qkv_bwd = lib.ptt_flash_qkv_bwd
        qkv_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
                            + [ctypes.c_void_p])
        qkv_bwd.restype = ctypes.c_int
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _gen_fns = (fwd, bwd, qkv_bwd, err_str)
    return _gen_fns


def _check_general(kernel, q, k, v, bias, dropout_p, seed, bq, bk):
    """Device, dtype, shape and layout checks shared by both wrappers;
    returns ``(b, s_q, s_k, h, d)``."""
    _check(q.device.type == "cuda", kernel,
           f"needs CUDA tensors, got {q.device}")
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, kernel,
           "q, k and v must be [B, S, H, D]")
    b, s_q, h, d = q.shape
    s_k = k.shape[1]
    _check(tuple(k.shape) == (b, s_k, h, d) and v.shape == k.shape, kernel,
           f"k and v must be [{b}, S_k, {h}, {d}], got {tuple(k.shape)} "
           f"and {tuple(v.shape)}")
    _check(d in (64, 128) or (d > 128 and d % 64 == 0), kernel,
           f"head_dim must be 64, 128 or a multiple of 64 above 128, got {d}")
    _check(q.dtype in _DTYPE_CODES and k.dtype == q.dtype
           and v.dtype == q.dtype, kernel,
           f"q, k and v must share float32 or bfloat16, got {q.dtype}, "
           f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == q.device and t.is_contiguous()
               and t.data_ptr() % 16 == 0, kernel,
               f"{name} must be contiguous, 16-byte aligned, on {q.device}")
    if bias is not None:
        _check(bias.device == q.device and bias.dtype == torch.float32
               and bias.dim() == 3 and bias.is_contiguous()
               and bias.shape[0] in (1, b) and bias.shape[1] in (1, s_q)
               and bias.shape[2] == s_k, kernel,
               f"bias must be contiguous float32 [1|{b}, 1|{s_q}, {s_k}] "
               f"on {q.device}, got {bias.dtype} {tuple(bias.shape)}")
    _check(0.0 <= dropout_p < 1.0, kernel,
           f"dropout_p must lie in [0, 1), got {dropout_p}")
    if dropout_p:
        _check(seed is not None and seed.device == q.device
               and seed.dtype == torch.int32 and seed.numel() >= 1, kernel,
               "dropout needs an int32 seed tensor on q's device")
        _check(bq % 128 == 0 and bk % 128 == 0 and bq > 0 and bk > 0,
               kernel, f"bq and bk must be multiples of 128, got {bq}, {bk}")
    return b, s_q, s_k, h, d


def _shape_args(b, s_q, s_k, h, d, bias, causal, dropout_p, bq, bk, scale,
                dtype, device):
    return (b, s_q, s_k, h, d,
            1 if bias is None else bias.shape[0],
            1 if bias is None else bias.shape[1], int(causal),
            int(dropout_p > 0), float(np.float32(1.0 - dropout_p)),
            float(np.float32(scale)), bq, bk, _DTYPE_CODES[dtype],
            device.index, torch.cuda.current_stream(device).cuda_stream)


def _launch_general_fwd(kernel, q, k, v, causal, bias, dropout_p, seed, bq,
                        bk, scale):
    """One launch of B2's forward kernel, counted as ``kernel``."""
    dbq, dbk = _blocks(q.shape[1], k.shape[1])
    bq, bk = bq or dbq, bk or dbk
    b, s_q, s_k, h, d = _check_general(kernel, q, k, v, bias, dropout_p,
                                       seed, bq, bk)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    fwd, _, _, err_str = _gen_kernel_fns()
    err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if bias is None else bias.data_ptr(),
              seed.data_ptr() if dropout_p else None, o.data_ptr(),
              lse.data_ptr(),
              *_shape_args(b, s_q, s_k, h, d, bias, causal, dropout_p, bq,
                           bk, scale, q.dtype, q.device))
    _raise_on(err, kernel, err_str)
    count_launch(kernel)
    return o, lse


def _launch_general_bwd(kernel, q, k, v, o, lse, do, causal, bias, dropout_p,
                        seed, bq, bk, scale, dlse):
    """One call of B2's backward kernels, counted as one launch of
    ``kernel``."""
    dbq, dbk = _blocks(q.shape[1], k.shape[1])
    bq, bk = bq or dbq, bk or dbk
    b, s_q, s_k, h, d = _check_general(kernel, q, k, v, bias, dropout_p,
                                       seed, bq, bk)
    rows = [("do", do, q.shape, q.dtype), ("o", o, q.shape, q.dtype),
            ("lse", lse, (b, h, s_q), torch.float32)]
    if dlse is not None:
        rows.append(("dlse", dlse, (b, h, s_q), torch.float32))
    for name, t, shape, dt in rows:
        _check(t.device == q.device and tuple(t.shape) == tuple(shape)
               and t.dtype == dt and t.is_contiguous()
               and t.data_ptr() % 16 == 0, kernel,
               f"{name} must be contiguous 16-byte aligned {dt} "
               f"{tuple(shape)} on {q.device}, got {t.dtype} "
               f"{tuple(t.shape)} on {t.device}")
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if q.dtype == torch.bfloat16 and d <= 256 else None)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    _, bwd, _, err_str = _gen_kernel_fns()
    err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), lse.data_ptr(),
              None if dlse is None else dlse.data_ptr(),
              None if bias is None else bias.data_ptr(),
              seed.data_ptr() if dropout_p else None, delta.data_ptr(),
              None if dq_acc is None else dq_acc.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *_shape_args(b, s_q, s_k, h, d, bias, causal, dropout_p, bq,
                           bk, scale, q.dtype, q.device))
    _raise_on(err, kernel, err_str)
    count_launch(kernel)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal, bias=None, dropout_p=0.0, seed=None,
                        bq=None, bk=None, scale=None):
    """Launch the forward kernel: q ``[B, Sq, H, D]``, k and v ``[B, Sk,
    H, D]`` (CUDA, contiguous, float32 or bfloat16; D 64, 128 or a
    multiple of 64 above 128, any lengths). ``bias``: contiguous float32
    ``[1|B, 1|Sq, Sk]``;
    ``seed``: int32 ``[1]`` on the same device when ``dropout_p > 0``;
    ``bq``/``bk``: the reference's blocks (default: its default tiling);
    ``scale``: default ``1/sqrt(D)``. Returns ``(o [B, Sq, H, D], lse [B,
    H, Sq])``."""
    return _launch_general_fwd(_GEN_FWD, q, k, v, causal, bias, dropout_p,
                               seed, bq, bk, scale)


def flash_attention_bwd(q, k, v, o, lse, do, causal, bias=None,
                        dropout_p=0.0, seed=None, bq=None, bk=None,
                        scale=None, dlse=None):
    """Launch the backward kernels: ``(dq, dk, dv)`` from the forward's
    inputs, ``o``, ``lse`` and the cotangent ``do`` (q's shape and
    dtype). One call counts as one launch. bfloat16 at D 64, 128, 192
    or 256: a pre-pass (``delta = rowsum(dO*O)``, the float32 dq
    accumulator zeroed), the one-pass kernel over key blocks (dk, dv,
    and dq added into the accumulator) and a post-pass rounding dq;
    float32 above 128, and bfloat16 above 256: the delta pre-pass, a
    dk/dv pass and a dq pass sliced over D. ``dlse``: the lse cotangent
    (contiguous float32 ``[B, H, Sq]``, B4), which the pre-pass subtracts
    from delta; None runs B2's backward as it is."""
    return _launch_general_bwd(_GEN_BWD, q, k, v, o, lse, do, causal, bias,
                               dropout_p, seed, bq, bk, scale, dlse)


class _Flash(torch.autograd.Function):
    """``custom_vjp`` of ``_flash`` (:728-755): forward saves ``(q, k, v,
    bias, seed, o, lse)``, backward recomputes P from lse; the bias gets
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, dropout_p, bq, bk, scale):
        args = (causal, bias, dropout_p, seed, bq, bk, scale)
        if runs_plain(q, _GEN_FWD):
            o, lse = flash_reference(q, k, v, *args)
        else:
            o, lse = flash_attention_fwd(q, k, v, *args)
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.cfg = (causal, dropout_p, bq, bk, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        causal, dropout_p, bq, bk, scale = ctx.cfg
        do = do.to(q.dtype).contiguous()
        args = (causal, bias, dropout_p, seed, bq, bk, scale)
        if runs_plain(q, _GEN_BWD):
            grads = flash_bwd_reference(q, k, v, o, lse, do, *args)
        else:
            grads = flash_attention_bwd(q, k, v, o, lse, do, *args)
        return (*grads, None, None, None, None, None, None, None)


def flash_attention(query, key, value, is_causal=False, attn_mask=None,
                    dropout_p=0.0, seed=None, block_q=DEFAULT_BLOCK,
                    block_k=DEFAULT_BLOCK, generator=None):
    """Flash attention on ``[B, S, H, D]`` -> ``[B, Sq, H, D]``,
    differentiable in q, k and v (``flash_attention_fwd`` :1219). A CPU
    tensor runs the plain version; a CUDA tensor launches the kernels (or
    the wrappers raise). Any lengths; causal masking is bottom-right
    aligned. ``attn_mask``: bool (True = attend) or additive, of a shape
    `normalize_mask_bias` takes; it gets no gradient. ``dropout_p``:
    in-kernel attention dropout, seeded by ``seed`` (an int or an int32
    tensor) or, when None, by a draw from ``generator`` (default: the
    current `core.random` generator). ``block_q``/``block_k`` place the
    dropout hash as the reference's blocks do. The CPU's plain version
    takes any head_dim; on a card the kernels run at `kernel_head_dim`,
    q, k and v zero-padded to it."""
    b, s_q, h, d = query.shape
    bq, bk = _blocks(s_q, key.shape[1], block_q, block_k)
    bias = None
    if attn_mask is not None:
        bias = normalize_mask_bias(attn_mask.detach()).to(query.device)
    seed_t = _seed_tensor(seed, generator, query.device, dropout_p)
    scale = 1.0 / math.sqrt(d)
    cfg = (bool(is_causal), float(dropout_p), bq, bk, scale)
    if runs_plain(query, _GEN_FWD):
        return _Flash.apply(query, key, value, bias, seed_t, *cfg)
    q, k, v = _pad_heads((query, key, value), kernel_head_dim(d))
    out = _Flash.apply(q, k, v, None if bias is None else bias.contiguous(),
                       seed_t, *cfg)
    return out[..., :d] if out.shape[-1] != d else out


# ============================================ B4: (o, lse), both differentiable
_LSE_FWD = "flash_attention_lse_fwd"
_LSE_BWD = "flash_attention_lse_bwd"


def flash_attention_lse_fwd(q, k, v, causal, scale=None):
    """B4's forward: B2's forward kernel (its lse is an output already)
    on q, k, v ``[B, S, H, D]`` (as `flash_attention_fwd` takes them, no
    bias, no dropout), counted as B4. Returns ``(o, lse [B, H, S])``."""
    return _launch_general_fwd(_LSE_FWD, q, k, v, causal, None, 0.0, None,
                               None, None, scale)


def flash_attention_lse_bwd(q, k, v, o, lse, do, dlse, causal, scale=None):
    """B4's backward: B2's backward kernels with the lse cotangent
    ``dlse`` (contiguous float32 ``[B, H, S]``, or None for none) folded
    into delta, counted as B4. Returns ``(dq, dk, dv)``."""
    return _launch_general_bwd(_LSE_BWD, q, k, v, o, lse, do, causal, None,
                               0.0, None, None, None, scale, dlse)


class _FlashLse(torch.autograd.Function):
    """``custom_vjp`` of ``_flash_lse`` (:767-784): both outputs carry a
    cotangent; the backward recomputes P from lse and adds ``p * dlse``
    inside ds. A missing cotangent arrives as None (grads are not
    materialised): ``do`` then counts as zeros, and a missing ``dlse``
    runs B2's backward as it is."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.set_materialize_grads(False)
        if runs_plain(q, _LSE_FWD):
            o, lse = flash_reference(q, k, v, causal, scale=scale)
        else:
            o, lse = flash_attention_lse_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, scale)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale = ctx.cfg
        do = (torch.zeros_like(o) if do is None
              else do.to(q.dtype).contiguous())
        if dlse is not None:
            dlse = dlse.float().contiguous()
        if runs_plain(q, _LSE_BWD):
            grads = flash_bwd_reference(q, k, v, o, lse, do, causal,
                                        scale=scale, dlse=dlse)
        else:
            grads = flash_attention_lse_bwd(q, k, v, o, lse, do, dlse, causal,
                                            scale)
        return (*grads, None, None)


def flash_attention_with_lse(q, k, v, is_causal=False, scale=None):
    """Flash attention that also returns the logsumexp of each query's
    scores, both differentiable (``flash_attention_with_lse`` :787-815),
    for callers that merge partial attentions, as the sequence-parallel
    ring does: ``[B, S, H, D]`` in, ``(o [B, S, H, D], lse [B, H, S]
    float32)`` out. Needs ``s_q == s_k``. ``scale``: default
    ``1/sqrt(D)``. A CPU tensor runs the plain version at any head_dim; a
    CUDA tensor launches B4's kernels (or the wrappers raise) at
    `kernel_head_dim`, q, k and v zero-padded to it."""
    b, s, h, d = q.shape
    if k.shape[1] != s:
        raise ValueError("flash_attention_with_lse requires s_q == s_k "
                         f"(got {s} vs {k.shape[1]})")
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    if runs_plain(q, _LSE_FWD):
        return _FlashLse.apply(q, k, v, bool(is_causal), scale)
    qp, kp, vp = _pad_heads((q, k, v), kernel_head_dim(d))
    o, lse = _FlashLse.apply(qp, kp, vp, bool(is_causal), scale)
    return (o[..., :d] if o.shape[-1] != d else o), lse


__all__ = ["mix32", "hash_keep_scale", "keep_threshold", "qkv_drop_ids",
           "qkv_columns", "flash_qkv_reference",
           "flash_qkv_bwd_reference", "flash_attention_qkv_fwd",
           "flash_attention_qkv_bwd", "flash_attention_qkv",
           "flash_qkv3_reference", "flash_qkv3_bwd_reference",
           "flash_attention_qkv3_fwd", "flash_attention_qkv3_bwd",
           "flash_attention_qkv3", "packed_supported",
           "flash_attention_packed", "normalize_mask_bias", "pick_block",
           "kernel_head_dim",
           "flash_reference", "flash_bwd_reference", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention",
           "flash_attention_lse_fwd", "flash_attention_lse_bwd",
           "flash_attention_with_lse"]
