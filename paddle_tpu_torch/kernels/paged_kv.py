"""Paged KV-cache primitives: page arithmetic, the dense gather, the
page writers, the beam's page copy and its one-softmax oracle.

Counterpart: ``paddle_tpu/kernels/paged_kv.py:43-228``. There these are
XLA compositions (gather/scatter), not Pallas kernels, so here they stay
plain torch indexing. The JAX versions return new pools; the writers
here update the pool IN PLACE (``index_put_``), which saves a copy of a
pool that holds the whole serving KV cache.

Quantized pools (``kv_quant="int8"`` or ``"fp8"``) store 1-byte pages
(int8 or ``float8_e4m3fn``) beside f32 scale arrays ``[P, H, ps]``: one
scale per (page, head, in-page column), i.e. per written token and head,
fixed at write time, so a resident token is never requantized. Each
``_q`` writer puts the data and the scale rows at the same slots; the
paged-attention kernel dequantizes (``page.float() * scale``). fp8
pages are moved (gathered, scattered, padded) as their uint8 bits, so no
indexing kernel needs to know the fp8 type.

A pool is ``[P, H, ps, D]`` (one per layer and per K/V); a block table
``[N, Pmax]`` int maps row ``n``'s logical page ``i`` to physical page
``block_table[n, i]``, so logical column ``c`` lives at
``pool[block_table[n, c // ps], :, c % ps]``.
"""
from __future__ import annotations

import torch


def pages_for(n_cols: int, page_size: int) -> int:
    """ceil(n_cols / page_size): pages needed to hold ``n_cols`` tokens."""
    return -(-int(n_cols) // int(page_size))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its uint8 bits (a view); anything else as is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor):
    """The dense logical view of each row: pool ``[P, H, ps, D]``,
    block_table ``[N, Pmax]`` -> ``[N, H, Pmax*ps, D]``. Used by the
    plain version of the paged-attention kernel only."""
    v = _bits(pool)[block_table.long()].view(pool.dtype)  # [N,Pmax,H,ps,D]
    v = v.permute(0, 2, 1, 3, 4)                 # [N, H, Pmax, ps, D]
    n, h = v.shape[0], v.shape[1]
    return v.reshape(n, h, -1, pool.shape[-1])


def write_token_pages(pool: torch.Tensor, pages: torch.Tensor,
                      offsets: torch.Tensor, val: torch.Tensor):
    """Write tokens into their pages, in place: pages and offsets ``[N]``
    (the physical page and in-page column of each token: one per slot
    for a decode step, a flat `tail_page_targets` for a window), val
    ``[N, H, D]``. Returns ``pool``."""
    pool[pages.long(), :, offsets.long()] = val.to(pool.dtype)
    return pool


def scatter_prompt_pages(pool: torch.Tensor, page_rows: torch.Tensor,
                         local: torch.Tensor, page_size: int):
    """Write a prefilled local cache into its reserved pages, in place.

    local ``[n, H, bucket, D]``; page_rows ``[n, >=Pb]`` with
    ``Pb = pages_for(bucket, ps)`` (a whole block-table row works; only
    the first Pb entries are used). ``bucket`` need not be a multiple of
    ``page_size``: the tail of the last page is padded with zeros, and
    those columns are never read before a decode step overwrites them
    (every read is masked by the row's own cursor). Returns ``pool``.
    """
    n, h, bucket, d = local.shape
    pb = pages_for(bucket, page_size)
    pad = pb * page_size - bucket
    if pad:
        local = torch.cat([local, local.new_zeros((n, h, pad, d))], dim=2)
    tiles = local.reshape(n, h, pb, page_size, d).permute(0, 2, 1, 3, 4)
    flat = tiles.reshape(n * pb, h, page_size, d)
    pool[page_rows[:, :pb].reshape(-1).long()] = flat.to(pool.dtype)
    return pool


def scatter_tail_pages(pool: torch.Tensor, block_table: torch.Tensor,
                       col0: torch.Tensor, local: torch.Tensor):
    """Write ``local [n, H, s, D]`` token-wise through the block table, in
    place: token ``j`` of row ``r`` lands at logical column ``col0[r] +
    j`` (`tail_page_targets`: columns past the row's logical window go to
    the sentinel page). Returns ``pool``."""
    n, h, s, d = local.shape
    pages, offs = tail_page_targets(block_table, col0, s, pool.shape[2],
                                    pool.shape[0] - 1)
    return write_token_pages(pool, pages, offs,
                             local.permute(0, 2, 1, 3).reshape(n * s, h, d))


def tail_page_targets(block_table, col0, s: int, page_size: int,
                      sentinel: int):
    """Flat ``(pages, offsets)`` ``[n * s]`` of an ``[n, s]``-token tail at
    logical columns ``col0 + j``, row-major: the one copy of the window
    and sentinel arithmetic (``paged_kv.py:160-175``). Columns past the
    row's logical window go to page ``sentinel`` (the pool's last page),
    never to the row's own last page, where they would land on live K/V.
    The speculative verify window writes its lanes here, and a decode
    step its one token (``s = 1``); the float and the quantized writers
    take the same targets, so data and scale rows land together."""
    cols = (col0.to(torch.int64)[:, None]
            + torch.arange(s, device=col0.device)[None, :])
    in_window = cols < block_table.shape[1] * page_size
    pages = block_table.long().gather(
        1, torch.where(in_window, cols // page_size, 0))
    pages = torch.where(in_window, pages, sentinel)
    return pages.reshape(-1), (cols % page_size).reshape(-1)


#: e4m3fn's largest finite value
_FP8_E4M3FN_MAX = 448.0


def quantize_tokens(val: torch.Tensor, dtype=torch.int8):
    """Symmetric per-token quantization: ``val [..., D]`` -> ``(q [...,
    D] in dtype, scale [...] f32)``, one scale per leading index (per
    token and head). int8: ``scale = max|v| / 127``, round half to even,
    clip to +-127. ``float8_e4m3fn``: ``scale = max|v| / 448`` and a
    plain cast (round to nearest even; the scaled values lie within the
    format). An all-zero token keeps scale 0 and dequantizes to zeros."""
    a = val.float()
    if dtype == torch.float8_e4m3fn:
        s = a.abs().amax(dim=-1) / _FP8_E4M3FN_MAX
        safe = torch.where(s > 0, s, 1.0)
        return (a / safe[..., None]).to(dtype), s
    if dtype != torch.int8:
        raise ValueError(f"quantized pages are int8 or float8_e4m3fn, "
                         f"got {dtype}")
    s = a.abs().amax(dim=-1) / 127.0
    safe = torch.where(s > 0, s, 1.0)
    q = torch.clamp(torch.round(a / safe[..., None]), -127, 127)
    return q.to(torch.int8), s


def gather_scales(scale: torch.Tensor, block_table: torch.Tensor):
    """The logical scale view: scale ``[P, H, ps]``, block_table ``[N,
    Pmax]`` -> ``[N, H, Pmax*ps]``, the companion of `gather_pages` (the
    plain version of the kernel only)."""
    v = scale[block_table.long()].permute(0, 2, 1, 3)   # [N, H, Pmax, ps]
    return v.reshape(v.shape[0], v.shape[1], -1)


def write_token_pages_q(pool, scale, pages, offsets, val):
    """Quantized `write_token_pages`, in place: each token's data into
    ``pool`` and its per-head scales into ``scale`` at the same (page,
    column) slots. Returns ``(pool, scale)``."""
    q, s = quantize_tokens(val, pool.dtype)          # [N, H, D], [N, H]
    pages, offsets = pages.long(), offsets.long()
    _bits(pool)[pages, :, offsets] = _bits(q)
    scale[pages, :, offsets] = s
    return pool, scale


def scatter_prompt_pages_q(pool, scale, page_rows, local, page_size: int):
    """Quantized `scatter_prompt_pages`, in place: the zero-padded tail
    of the last page quantizes to (0, scale 0), which dequantizes to the
    float writer's zeros. Returns ``(pool, scale)``."""
    n, h, bucket, d = local.shape
    q, s = quantize_tokens(local, pool.dtype)        # [n,H,B,D], [n,H,B]
    q = _bits(q)
    pb = pages_for(bucket, page_size)
    pad = pb * page_size - bucket
    if pad:
        q = torch.cat([q, q.new_zeros((n, h, pad, d))], dim=2)
        s = torch.cat([s, s.new_zeros((n, h, pad))], dim=2)
    tiles = q.reshape(n, h, pb, page_size, d).permute(0, 2, 1, 3, 4)
    stiles = s.reshape(n, h, pb, page_size).permute(0, 2, 1, 3)
    rows = page_rows[:, :pb].reshape(-1).long()
    _bits(pool)[rows] = tiles.reshape(n * pb, h, page_size, d)
    scale[rows] = stiles.reshape(n * pb, h, page_size)
    return pool, scale


def scatter_tail_pages_q(pool, scale, block_table, col0, local):
    """Quantized `scatter_tail_pages`, in place, with the same targets
    for the data and the scales. Returns ``(pool, scale)``."""
    n, h, s, d = local.shape
    pages, offs = tail_page_targets(block_table, col0, s, pool.shape[2],
                                    pool.shape[0] - 1)
    return write_token_pages_q(pool, scale, pages, offs,
                               local.permute(0, 2, 1, 3).reshape(n * s, h, d))


def copy_pages(pool, dst, src, scale=None):
    """``pool[dst] = pool[src]`` in place, whole pages: every read is
    made against the pool before the copy (the indexed read copies
    first), so simultaneous copies permute consistently. A 1-byte pool's
    ``scale`` rows move in the same motion. The paged beam's copy-on-
    write of each beam's partial page (``paddle_tpu/models/
    generation.py:1054-1072``)."""
    bits = _bits(pool)
    bits[dst] = bits[src]
    if scale is not None:
        scale[dst] = scale[src]
    return pool


def beam_shared_attention(qh, ctx_k, ctx_v, gen_k, gen_v, head_dim,
                          ctx_valid=None, gen_valid=None):
    """Two-segment beam attention as ONE softmax over the concatenated
    columns (``paddle_tpu/kernels/paged_kv.py:255-312``): the shared
    prompt ``ctx_k/v [B, H, Sc, D]``, contracted once per batch row
    against all K beams, and each beam's dense tail view ``gen_k/v [B*K,
    H, Lg, D]``. ``qh [B*K, H, D]``; ``ctx_valid`` ``[B, Sc]`` masks left
    padding; ``gen_valid`` ``[Lg]`` or ``[B*K, Lg]`` the unwritten tail.
    Returns ``[B*K, 1, H*D]``. It is the reference's oracle of the paged
    beam: the port uses it in tests only, and on a card the beam's tail
    always goes through `paged_attention.paged_tail_segment`."""
    b, h, sc = ctx_k.shape[0], ctx_k.shape[1], ctx_k.shape[2]
    n = qh.shape[0]
    k_beams = n // b
    qb = qh.reshape(b, k_beams, h, qh.shape[-1])
    scale = torch.tensor(float(head_dim), dtype=qh.dtype,
                         device=qh.device).sqrt()
    s_ctx = torch.einsum("bkhd,bhld->bkhl", qb, ctx_k.to(qh.dtype)) / scale
    s_gen = torch.einsum("nhd,nhld->nhl", qh, gen_k.to(qh.dtype)) / scale
    lg = s_gen.shape[-1]
    s_gen = s_gen.reshape(b, k_beams, h, lg)
    s32 = torch.cat([s_ctx, s_gen], dim=-1).float()
    if ctx_valid is not None or gen_valid is not None:
        dev = qh.device
        cv = (torch.ones((b, sc), dtype=torch.bool, device=dev)
              if ctx_valid is None else ctx_valid != 0)
        cv = cv[:, None, None, :].expand(b, k_beams, 1, sc)
        gv = (torch.ones((n, lg), dtype=torch.bool, device=dev)
              if gen_valid is None
              else (gen_valid != 0).reshape(-1, lg).expand(n, lg))
        valid = torch.cat([cv, gv.reshape(b, k_beams, 1, lg)], dim=-1)
        s32 = s32.masked_fill(~valid, torch.finfo(torch.float32).min / 2)
    w = torch.softmax(s32, dim=-1).to(qh.dtype)
    o_ctx = torch.einsum("bkhl,bhld->bkhd", w[..., :sc], ctx_v.to(qh.dtype))
    o_gen = torch.einsum("nhl,nhld->nhd", w[..., sc:].reshape(n, h, lg),
                         gen_v.to(qh.dtype))
    o = o_ctx.reshape(n, h, -1) + o_gen
    return o.reshape(n, 1, h * o.shape[-1])


__all__ = ["pages_for", "gather_pages", "gather_scales", "quantize_tokens",
           "write_token_pages", "write_token_pages_q", "scatter_prompt_pages",
           "scatter_prompt_pages_q", "scatter_tail_pages",
           "scatter_tail_pages_q", "tail_page_targets", "copy_pages",
           "beam_shared_attention"]
