"""Sequence/context parallelism: ring attention and Ulysses.

Counterpart: ``paddle_tpu/distributed/sequence_parallel.py``, function
for function. The reference writes both for ``shard_map`` over the
``sp`` mesh axis of one controller; here each rank is a process
(`collective.init_parallel_env`) holding its own contiguous sequence
chunk ``[B, S/sp, H, D]``, and the axis is a process group.

- **Ring** (`ring_attention`): K and V travel around the ring, both in
  one batched P2P call a step (`collective.send_recv`, the reference's
  ``ppermute``); each (Q-chunk, KV-chunk) pair is one call of B4
  (`flash_chunk_attention`: o and a differentiable lse), merged by the
  online-softmax rule (`_merge`). Autograd runs the reverse ring: each
  shift's backward sends its cotangent the other way. A rank knows its
  index, so the reference's causal ``lax.switch`` is a plain branch:
  earlier chunks attend in full, the diagonal one causally, later ones
  are skipped (and still shifted on). The loop (`_ring_loop`) takes its
  transport as an argument, so one process can run every rank's loop.
- **Ulysses** (`ulysses_attention`): `collective.all_to_all` re-shards
  sequence to heads, full-sequence attention runs on a head slice (B2
  where its gate admits the shape), and a second all-to-all restores
  sequence sharding.
- `sp_attention` takes and returns DTensors sharded on the sequence dim
  over the mesh's ``sp`` axis; `shard_sequence` makes one.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from .. import kernels
from ..kernels.flash_attention import flash_attention
from .collective import all_to_all, get_rank, get_world_size, send_recv
from .topology import SP_AXIS, HybridMesh

_NEG_BIG = -1e30


def _block_attention(q, k, v, scale, mask):
    """Exact attention on one (Q-chunk, KV-chunk) pair: q ``[B, Sq, H,
    D]``, k/v ``[B, Sk, H, D]``, mask ``[Sq, Sk]`` bool or None. Returns
    ``(o [B, Sq, H, D] float32, lse [B, H, Sq] float32)``; scores in
    float32 whatever the inputs' dtype, p rounded to v's dtype before
    p.v, as the reference does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, _NEG_BIG)
    m = s.amax(dim=-1)                                   # [B, H, Sq]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    safe_l = l.clamp(min=1e-30)
    o = o / safe_l.transpose(1, 2)[..., None]
    return o, m + torch.log(safe_l)


def _merge(o1, lse1, o2, lse2):
    """Online-softmax merge of two partial attention results."""
    lse = torch.logaddexp(lse1, lse2)

    def weight(x):                        # [B, H, Sq] -> [B, Sq, H, 1]
        return torch.exp(x - lse).transpose(1, 2)[..., None]

    return o1 * weight(lse1) + o2 * weight(lse2), lse


def _causal_mask(s_q, s_k, device):
    return torch.ones((s_q, s_k), dtype=torch.bool, device=device).tril()


def _chunk_sdpa(q, k, v, causal, scale=None):
    """Composed chunk attention: exact attention on one (Q, KV) chunk
    pair, ``(o float32, lse float32)`` for the merge."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    return _block_attention(q, k, v, scale, mask)


def flash_chunk_attention(q, k, v, causal, scale=None):
    """The ring's chunk attention: B4 (`flash_attention_with_lse`) on one
    (Q-chunk, KV-chunk) pair, ``(o float32, lse)`` with a real lse
    cotangent. The reference's gate: equal lengths, ``s_loc`` a multiple
    of 128 and at most 2048; inside it a CUDA tensor launches the kernels
    (or they raise) and a CPU tensor runs their plain version. Outside it
    the pair is composed (`_chunk_sdpa`), as in the reference."""
    s_loc = q.shape[1]
    if k.shape[1] == s_loc and s_loc % 128 == 0 and s_loc <= 2048:
        o, lse = kernels.flash_attention_with_lse(q, k, v, is_causal=causal,
                                                  scale=scale)
        return o.float(), lse
    return _chunk_sdpa(q, k, v, causal, scale)


def _ring_loop(q, k, v, me, n, shift, causal, scale, impl):
    """Rank ``me``'s part of an ``n``-rank ring: ``n`` steps; at step t
    this rank holds the K/V chunk of rank ``(me - t) % n`` (stacked
    ``[2, B, S, H, D]``; ``shift(kv)`` hands it on and returns the next
    one) and merges ``impl(q, k_chunk, v_chunk, causal, scale)`` into its
    running ``(o, lse)``. Causal: chunks before ``me`` attend in full,
    ``me``'s own causally, later ones are skipped (their K/V still
    shifted on). Returns ``(o in q's dtype, the last kv)``."""
    b, s_loc, h, d = q.shape
    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, s_loc), _NEG_BIG, dtype=torch.float32,
                     device=q.device)
    kv = torch.stack((k, v))
    for t in range(n):
        if t:
            kv = shift(kv)
        src = (me - t) % n
        if causal and src > me:
            continue
        o_b, lse_b = impl(q, kv[0], kv[1], causal and src == me, scale)
        o, lse = _merge(o, lse, o_b, lse_b)
    return o.to(q.dtype), kv


class _KeepInGraph(torch.autograd.Function):
    """``o``, unchanged, with ``kv`` as an input of zero gradient: every
    shift of the ring then lies on the path from the loss, so every rank
    runs each shift's backward (a collective) whether or not it attended
    to the chunk that shift delivered."""

    @staticmethod
    def forward(ctx, o, kv):
        ctx.kv_like = (kv.shape, kv.dtype, kv.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        shape, dtype, device = ctx.kv_like
        return do, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: float | None = None, attn_impl: Callable = None):
    """Exact attention over a sequence split across the ranks of
    ``group`` (default: the world), rank i holding chunk i: q/k/v
    ``[B, S/sp, H, D]``; the output is this rank's chunk, like q.
    Differentiable; the backward runs the reverse ring. ``group`` is the
    reference's ``axis_name``: the process group of the ``sp`` axis
    (`HybridMesh.group`). ``attn_impl(q, kb, vb, causal, scale) -> (o
    float32, lse float32)`` computes one chunk pair; default
    `flash_chunk_attention` (B4)."""
    n = get_world_size(group)
    me = get_rank(group)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    shift = partial(send_recv, perm=[(i, (i + 1) % n) for i in range(n)],
                    group=group)
    o, kv = _ring_loop(q, k, v, me, n, shift, causal, scale,
                       attn_impl or flash_chunk_attention)
    return _KeepInGraph.apply(o, kv) if n > 1 else o


def _sdpa(q, k, v, causal):
    """Plain full-sequence attention (float32 accumulation), ``[B, S, H,
    D]``, in q's dtype."""
    mask = _causal_mask(q.shape[1], k.shape[1], q.device) if causal else None
    o, _ = _block_attention(q, k, v, 1.0 / (q.shape[-1] ** 0.5), mask)
    return o.to(q.dtype)


def _full_attn_default(q, k, v, causal):
    """Ulysses' default attention on the local head slice: B2
    (`flash_attention`) where its gate admits the shape, `_sdpa`
    otherwise."""
    if kernels.flash_attention_enabled(q, k, None, 0.0):
        return flash_attention(q, k, v, is_causal=causal)
    return _sdpa(q, k, v, causal)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      attn_impl: Callable | None = None):
    """DeepSpeed-Ulysses sequence parallelism: q/k/v are this rank's
    chunks ``[B, S/sp, H, D]`` with ``H % sp == 0``; an all-to-all
    re-shards them to ``[B, S, H/sp, D]``, ``attn_impl(q, k, v, causal)``
    attends over the whole sequence on that head slice (default
    `_full_attn_default`), and a second all-to-all brings the output back
    to ``[B, S/sp, H, D]``. ``group``: as in `ring_attention`."""
    n = get_world_size(group)
    b, s_loc, h, d = q.shape
    if h % n:
        raise ValueError(f"ulysses_attention: the head count ({h}) must be "
                         f"divisible by the sp degree ({n})")

    def gather(x):         # [B, S/n, H, D] -> [B, S, H/n, D]
        x = x.reshape(b, s_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = all_to_all(x, group)                # [n (seq chunk), ...]
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, h // n, d)

    def scatter(x):        # [B, S, H/n, D] -> [B, S/n, H, D]
        x = x.reshape(b, n, s_loc, h // n, d).permute(1, 0, 2, 3, 4)
        x = all_to_all(x, group)                # [n (head slice), ...]
        return x.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h, d)

    o = (attn_impl or _full_attn_default)(gather(q), gather(k), gather(v),
                                          causal)
    return scatter(o)


def _sp_dim(mesh: HybridMesh) -> int:
    return mesh.axis_names.index(SP_AXIS)


def sp_attention(mesh: HybridMesh, q, k, v, causal: bool = False,
                 mode: str = "ring"):
    """Context-parallel attention over the mesh's ``sp`` axis. q/k/v:
    DTensors ``[B, S, H, D]`` sharded on the sequence dim over ``sp``
    (`shard_sequence`); the result is one too, placed as q. ``mode``:
    "ring" (`ring_attention`, B4 on each chunk pair) or "ulysses"
    (`ulysses_attention`). A mesh without an ``sp`` axis composes plain
    attention (`_sdpa`), on tensors or on DTensors' local parts."""
    if not mesh.has_axis(SP_AXIS):
        if isinstance(q, DTensor):
            o = _sdpa(q.to_local(), k.to_local(), v.to_local(), causal)
            return DTensor.from_local(o, q.device_mesh, q.placements,
                                      run_check=False)
        return _sdpa(q, k, v, causal)
    fn = {"ring": ring_attention, "ulysses": ulysses_attention}[mode]
    dim = _sp_dim(mesh)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, DTensor) or t.placements[dim] != Shard(1):
            raise TypeError(f"sp_attention: {name} must be a DTensor sharded "
                            "on the sequence dim over sp (shard_sequence)")
    o = fn(q.to_local(), k.to_local(), v.to_local(), mesh.group(SP_AXIS),
           causal)
    return DTensor.from_local(o, q.device_mesh, q.placements,
                              run_check=False)


def shard_sequence(mesh: HybridMesh, x, seq_dim: int = 1):
    """``x`` as a DTensor over the mesh with dim ``seq_dim`` sharded over
    ``sp`` and replicated over every other axis (rank 0's data is
    scattered); without an ``sp`` axis, replicated."""
    placements = [Replicate()] * len(mesh.axis_names)
    if mesh.has_axis(SP_AXIS):
        placements[_sp_dim(mesh)] = Shard(seq_dim)
    return distribute_tensor(x, mesh.mesh, placements)


__all__ = ["flash_chunk_attention", "ring_attention", "ulysses_attention",
           "sp_attention", "shard_sequence"]
