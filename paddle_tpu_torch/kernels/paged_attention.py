"""Paged attention for decode and verify: the Hopper kernel and its plain
version.

Counterpart: ``paddle_tpu/kernels/paged_attention.py``. The TPU kernel
there, ``_paged_attn_kernel`` (:120, launched by ``fused_paged_attention``
:179), is replaced by the hand-written CUDA kernel in
``csrc/paged_attention.cu``, in both of its forms: float pools, and
quantized pools of 1-byte pages (int8 or fp8 e4m3) with per-(page, head,
in-page column) f32 scales ``[P, H, ps]``, dequantized in the kernel. The
source's header note says how it works and what bounds it.

- `fused_paged_attention`: the kernel wrapper (CUDA tensors only).
- `paged_attention_reference`: the plain PyTorch version, computing the
  same ``(out, lse)``; the CPU path and the on-card comparison use it.
- `paged_decode_attention`: the dispatcher with the contract of
  ``paddle_tpu.kernels.paged_attention.paged_decode_attention``
  (:271-305): ``qh [N, H, W, D]`` -> context ``[N, W, H*D]``, W = 1 for
  a decode step and k + 1 for a speculative verify window.
- `paged_tail_segment`: the beam search's generated-tail read (:308-342),
  the same kernel at W = 1 with one cursor for every row, returning the
  normalized ``(out, lse)`` segment that `merge_attention_segments`
  (:358-369, plain torch: XLA in the reference too) combines with the
  shared prompt segment.

Semantics shared by the kernel and its plain version, the TPU kernel's:
query ``j`` of row ``n`` attends logical column ``c`` when
``c <= steps[n] + j`` and ``valid_cols[n, c] != 0``; a masked score is
``-1e30``, so a query with no readable column (a parked serving slot)
gets the uniform average over every column of its table — finite, and
never read by the engine. A quantized page dequantizes as
``page.float() * scale`` in f32 (the TPU kernel's :146-147). The kernel
reads only the pages up to the cursor that hold a readable column (the
rest add exactly nothing) unless a query found no readable column there;
the plain version is the masked softmax over the whole table.

The kernel takes any head dim up to 256 and any page size, with the
pools at the model's own D: `kernel_width`, `query_tile` and
`chunk_cols` are its plan (the padded width the kernel is instantiated
at, the queries a block takes and the columns a ring chunk holds), pure
functions of the shapes. A head dim above 256 raises (ROADMAP C.6).

The kernel splits each row's page walk across blocks (flash-decoding):
`plan_splits` picks the split count from the shapes and the card's SM
count alone, each split writes an f32 partial to a workspace, and the
last split of a (row, head, query tile) to finish merges them in the
same launch, found with an atomic ticket in a per-(device, stream)
int32 buffer that the kernel leaves at 0 (`_tickets`).

Launch counts: ``paged_attention`` for float pools,
``paged_attention_int8`` and ``paged_attention_fp8`` for quantized ones;
a launch through `paged_tail_segment` also counts ``paged_tail_segment``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, count_launch, hold, runs_plain
from .paged_kv import gather_pages, gather_scales

_KERNEL = "paged_attention"
_MASKED = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: quantized page dtype -> (the C entry's page code, launch-count name)
_QUANT_PAGES = {torch.int8: (1, "paged_attention_int8"),
                torch.float8_e4m3fn: (2, "paged_attention_fp8")}
#: queries a block of the kernel takes: 4, or 8 for a window of 5 to 8
#: at a padded width up to 128
_TILE_SMALL, _TILE_WIDE = 4, 8
#: the padded widths the kernel is instantiated at
_WIDTHS = (32, 64, 96, 128, 256)
#: the planner aims for this many blocks per SM ...
_BLOCKS_PER_SM = 4
#: ... and gives every split at least this many columns
_MIN_SPLIT_COLS = 64
_fn = None
_sm_counts: dict[int, int] = {}
_ticket_bufs: dict[tuple[int, int], torch.Tensor] = {}


def kernel_width(d: int) -> int:
    """The padded head dim the kernel runs a head dim ``d`` at (each of a
    warp's 32 lanes holds ``width / 32`` coordinates; those past ``d``
    are zeros, and the pools stay at ``d``): the least of 32, 64, 96,
    128 and 256 that holds ``d``. Above 256 it raises (ROADMAP C.6)."""
    for width in _WIDTHS:
        if d <= width:
            return width
    raise NotImplementedError(
        f"fused_paged_attention: head_dim {d} > 256 on a card: the kernel "
        "takes head dims up to 256 (ROADMAP C.6)")


def chunk_cols(width: int, page_itemsize: int) -> int:
    """Columns of one ring chunk: 16, or 8 where a padded row of the page
    type spans more than 512 bytes (f32 pages at width 256), so that a
    warp's two-stage ring fits the block's shared memory. A page of
    ``ps`` columns takes ``ceil(ps / chunk)`` chunks, its last one
    partial."""
    return 8 if width * page_itemsize > 512 else 16


def query_tile(w: int, d: int) -> int:
    """Queries one block of the kernel takes for a window of ``w`` at
    head dim ``d``: 8 for a window of 5 or more at a padded width up to
    128, else 4 (at width 256 eight queries' state would spill)."""
    if w > _TILE_SMALL and kernel_width(d) <= 128:
        return _TILE_WIDE
    return _TILE_SMALL


def plan_splits(n: int, h: int, w: int, pmax: int, ps: int,
                sm_count: int, d: int) -> tuple[int, int]:
    """``(splits, pages_per_split)`` of one kernel call, from the shapes
    and the card's SM count only (never from ``steps`` or
    ``valid_cols``: reading them would wait for the card). Split ``s``
    owns table pages ``[s * pps, min((s + 1) * pps, pmax))``; every page
    falls in exactly one split and no split is empty. The count aims for
    ``_BLOCKS_PER_SM`` blocks on every SM, with at least
    ``_MIN_SPLIT_COLS`` columns a split."""
    tiles = -(-w // query_tile(w, d))
    want = -(-_BLOCKS_PER_SM * sm_count // (n * h * tiles))
    most = max(1, pmax // -(-_MIN_SPLIT_COLS // ps))
    pps = -(-pmax // max(1, min(want, most)))
    return -(-pmax // pps), pps


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev.index]


def _tickets(dev: torch.device, stream, size: int) -> torch.Tensor:
    """The combine's int32 tickets for launches on ``stream``: zeroed
    when made, and every launch leaves them at 0. One buffer per
    (device, stream), so launches on two streams never share a ticket; a
    larger call takes a new, larger buffer (the caching allocator keeps
    the old one for the launches already queued on the stream). A graph
    captured on ``stream`` holds the buffer it read (`kernels.hold`), so
    a later, larger call cannot free it under the graph; its owner's
    warm-up on that stream makes the buffer before the capture."""
    key = (dev.index, stream.cuda_stream)
    buf = _ticket_bufs.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 1024), dtype=torch.int32, device=dev)
        _ticket_bufs[key] = buf
    return hold(buf)


def _kernel_fn():
    """``(launch, error_string)``: the C entry points, with their argument
    types declared (pointers and the stream as ``c_void_p``, so ctypes
    does not cut them to 32 bits)."""
    global _fn
    if _fn is None:
        lib = _build.load(_KERNEL)
        fn = lib.ptt_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 14 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = lib.ptt_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _fn = (fn, err_str)
    return _fn


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_paged_attention: {msg}")


def fused_paged_attention(qh, pool_k, pool_v, block_table, steps,
                          valid_cols, k_scale=None, v_scale=None):
    """Launch the Hopper kernel: qh ``[N, H, W, D]`` against pools
    ``[P, H, ps, D]`` through ``block_table [N, Pmax]`` (int32), with
    ``steps [N]`` and ``valid_cols [N, Pmax*ps]`` (int32). Returns
    ``(out [N, H, W, D] in qh's dtype, lse [N, H, W] f32)``.

    Takes CUDA tensors only, all contiguous and on one device; q is
    float32 or bfloat16; the pools either share q's dtype (no scales) or
    are both int8 or both float8_e4m3fn with ``k_scale``/``v_scale``
    ``[P, H, ps]`` float32; any ``D`` up to 256 (above it raises naming
    ROADMAP C.6) and any page size ``ps >= 1``. Anything else raises."""
    _check(qh.device.type == "cuda", f"needs CUDA tensors, got {qh.device}")
    dev = qh.device
    quant = pool_k.dtype in _QUANT_PAGES
    tensors = dict(qh=qh, pool_k=pool_k, pool_v=pool_v,
                   block_table=block_table, steps=steps,
                   valid_cols=valid_cols)
    if quant:
        _check(k_scale is not None and v_scale is not None,
               f"{pool_k.dtype} pools need k_scale and v_scale")
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    else:
        _check(k_scale is None and v_scale is None,
               f"scales were passed with {pool_k.dtype} pools")
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} is on {t.device}, qh on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(qh.dim() == 4, f"qh must be [N, H, W, D], got {tuple(qh.shape)}")
    n, h, w, d = qh.shape
    _check(pool_k.dim() == 4 and pool_k.shape == pool_v.shape,
           f"pools must share one [P, H, ps, D] shape, got "
           f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    _check(pool_k.shape[1] == h and pool_k.shape[3] == d,
           f"pool heads/head_dim {tuple(pool_k.shape[1::2])} != q's "
           f"{(h, d)}")
    ps = pool_k.shape[2]
    width = kernel_width(d)
    _check(ps >= 1, f"page_size must be at least 1, got {ps}")
    _check(qh.dtype in _DTYPE_CODES,
           f"q dtype must be float32 or bfloat16, got {qh.dtype}")
    _check(pool_v.dtype == pool_k.dtype,
           f"pools differ in dtype: {pool_k.dtype}/{pool_v.dtype}")
    if quant:
        page_code, counter = _QUANT_PAGES[pool_k.dtype]
        for name in ("k_scale", "v_scale"):
            sc = tensors[name]
            _check(sc.dtype == torch.float32
                   and tuple(sc.shape) == tuple(pool_k.shape[:3]),
                   f"{name} must be float32 [P, H, ps] = "
                   f"{tuple(pool_k.shape[:3])}, got {sc.dtype} "
                   f"{tuple(sc.shape)}")
    else:
        _check(pool_k.dtype == qh.dtype,
               f"pools must have q's dtype {qh.dtype} or be int8 / "
               f"float8_e4m3fn with scales, got {pool_k.dtype}")
        page_code, counter = 0, _KERNEL
    _check(block_table.dim() == 2 and block_table.shape[0] == n
           and block_table.dtype == torch.int32,
           "block_table must be int32 [N, Pmax]")
    pmax = block_table.shape[1]
    _check(steps.shape == (n,) and steps.dtype == torch.int32,
           "steps must be int32 [N]")
    _check(valid_cols.shape == (n, pmax * ps)
           and valid_cols.dtype == torch.int32,
           f"valid_cols must be int32 [N, Pmax*ps] = {(n, pmax * ps)}")
    # read in 16-byte pieces (cp.async, vector loads)
    for name in ("qh", "pool_k", "pool_v", "valid_cols", "k_scale",
                 "v_scale"):
        if name in tensors:
            _check(tensors[name].data_ptr() % 16 == 0,
                   f"{name} must be 16-byte aligned")
    out = torch.empty_like(qh)
    lse = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    splits, pps = plan_splits(n, h, w, pmax, ps, _sm_count(dev), d)
    tile = query_tile(w, d)
    part_o = torch.empty((n * h * w, splits, d), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((n * h * w, splits, 2), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev)
    tickets = _tickets(dev, stream, n * h * -(-w // tile))
    fn, err_str = _kernel_fn()
    err = fn(qh.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             block_table.data_ptr(), steps.data_ptr(), valid_cols.data_ptr(),
             out.data_ptr(), lse.data_ptr(), part_o.data_ptr(),
             part_ml.data_ptr(), tickets.data_ptr(), n, h, w, d, width, tile,
             chunk_cols(width, pool_k.element_size()), ps, pmax, splits, pps,
             _DTYPE_CODES[qh.dtype], page_code, dev.index,
             stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} ({err_str(err).decode()})")
    count_launch(counter)
    return out, lse


def paged_attention_reference(qh, pool_k, pool_v, block_table, steps,
                              valid_cols, k_scale=None, v_scale=None):
    """The plain PyTorch version of `fused_paged_attention`: the
    `gather_pages` view (dequantized as ``page.float() * scale`` when
    scales are given) plus the masked softmax, in f32, with the kernel's
    semantics (module docstring). Returns ``(out, lse)``."""
    n, h, w, d = qh.shape
    lp = pool_k.shape[2] * block_table.shape[1]
    dev = qh.device
    view_k = gather_pages(pool_k, block_table).float()   # [N, H, L, D]
    view_v = gather_pages(pool_v, block_table).float()
    if k_scale is not None:
        view_k = view_k * gather_scales(k_scale, block_table)[..., None]
        view_v = view_v * gather_scales(v_scale, block_table)[..., None]
    s = torch.einsum("nhwd,nhld->nhwl", qh.float(), view_k) / math.sqrt(d)
    cols = torch.arange(lp, device=dev)
    st = steps.to(dev).long()
    cur = st[:, None] + torch.arange(w, device=dev)[None, :]      # [N, W]
    valid = ((cols[None, None, :] <= cur[:, :, None])
             & (valid_cols.to(dev) != 0)[:, None, :])             # [N, W, L]
    s = s.masked_fill(~valid[:, None], _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("nhwl,nhld->nhwd", p, view_v) / l
    return out.to(qh.dtype), (m + torch.log(l))[..., 0]


def paged_decode_attention(qh, pool_k, pool_v, block_table, steps,
                           head_dim, valid_cols=None, k_scale=None,
                           v_scale=None):
    """The decode/verify dispatcher: ``qh [N, H, W, D]`` (W = 1 plain
    decode, W = k + 1 verify window) -> context ``[N, W, H*D]``;
    ``k_scale``/``v_scale`` ride with quantized pools. A CPU ``qh`` runs
    the plain version; a CUDA ``qh`` launches the kernel (or the wrapper
    raises)."""
    n, h, w, d = qh.shape
    if int(head_dim) != d:
        raise ValueError(f"head_dim {head_dim} != q's last dim {d}")
    if valid_cols is None:
        lp = block_table.shape[1] * pool_k.shape[2]
        valid_cols = torch.ones((n, lp), dtype=torch.int32,
                                device=qh.device)
    if runs_plain(qh, _KERNEL):
        out, _ = paged_attention_reference(qh, pool_k, pool_v, block_table,
                                           steps, valid_cols, k_scale,
                                           v_scale)
    else:
        out, _ = fused_paged_attention(
            qh.contiguous(), pool_k, pool_v,
            block_table.to(torch.int32).contiguous(),
            steps.to(torch.int32).contiguous(),
            valid_cols.to(torch.int32).contiguous(), k_scale, v_scale)
    return out.permute(0, 2, 1, 3).reshape(n, w, h * d)


def paged_tail_segment(qh, pool_k, pool_v, block_table, gen_col, head_dim,
                       k_scale=None, v_scale=None):
    """The beam's generated-tail read as a normalized segment
    (``paddle_tpu/kernels/paged_attention.py:308-342``): row ``n`` of
    ``qh [N, H, D]`` attends its own pages through ``block_table [N,
    Pg]`` at gen columns ``[0, gen_col]`` (every beam sits at the same
    cursor: an int, or a one-element int tensor on qh's device, which a
    captured step reads without the host). Returns ``(out [N, H, D] in
    qh's dtype, lse [N, H] f32)``. It is the paged kernel at W = 1 with
    ``steps = gen_col`` for every row and ``valid_cols`` all ones
    (:322-328); a CPU ``qh`` runs `paged_attention_reference` at the
    same arguments. ``k_scale`` / ``v_scale`` ride with 1-byte pools."""
    n, h, d = qh.shape
    if int(head_dim) != d:
        raise ValueError(f"head_dim {head_dim} != q's last dim {d}")
    lg = block_table.shape[1] * pool_k.shape[2]
    dev = qh.device
    if torch.is_tensor(gen_col):
        steps = gen_col.reshape(1).to(torch.int32).expand(n).contiguous()
    else:
        steps = torch.full((n,), int(gen_col), dtype=torch.int32,
                           device=dev)
    valid_cols = torch.ones((n, lg), dtype=torch.int32, device=dev)
    q4 = qh[:, :, None, :]
    if runs_plain(qh, _KERNEL):
        out, lse = paged_attention_reference(q4, pool_k, pool_v, block_table,
                                             steps, valid_cols, k_scale,
                                             v_scale)
    else:
        out, lse = fused_paged_attention(
            q4.contiguous(), pool_k, pool_v,
            block_table.to(torch.int32).contiguous(), steps, valid_cols,
            k_scale, v_scale)
        count_launch("paged_tail_segment")
    return out[:, :, 0], lse[:, :, 0]


def merge_attention_segments(o1, lse1, o2, lse2):
    """The two-way flash merge of normalized attention segments
    (``paddle_tpu/kernels/paged_attention.py:358-369``): each ``o_i
    [..., D]`` is softmax-normalized over its own columns and ``lse_i
    [...]`` is their logsumexp. In f32; the result in ``o1``'s dtype."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / (
        w1 + w2)[..., None]
    return o.to(o1.dtype)


__all__ = ["kernel_width", "chunk_cols", "query_tile", "plan_splits",
           "fused_paged_attention",
           "paged_attention_reference",
           "paged_decode_attention", "paged_tail_segment",
           "merge_attention_segments"]
