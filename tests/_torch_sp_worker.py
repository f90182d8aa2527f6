"""The rank side of tests/test_torch_sequence_parallel.py.

`run` is what `paddle_tpu_torch.distributed.spawn` starts in each rank:
it joins a gloo world on the CPU, runs every case (`SP_CASES`,
`FLASH_CASES`, then the refusal, mesh and collective cases) and writes
this rank's results (numpy arrays) to ``<out>/<case>.<rank>.npz``.
Inputs come from numpy seeds (`inputs`), the same on every rank and in
the test, which hands them to the JAX package too. This module imports
neither jax nor paddle_tpu, so the ranks never load them.
"""
from __future__ import annotations

import os

import numpy as np
import torch

#: (mode, causal, shape [B, S, H, D]) of the cases every world runs through
#: `sp_attention`: chunks of S/world rows, composed per pair (not
#: kernel-shaped)
SP_CASES = {f"{mode}_{'causal' if c else 'full'}": (mode, c, (2, 32, 4, 16))
            for mode in ("ring", "ulysses") for c in (False, True)}
#: kernel-shaped ring cases, S/world = 128 rows a chunk: each pair takes
#: `flash_chunk_attention`'s B4 branch
FLASH_CASES = {f"ring_flash_{'causal' if c else 'full'}": c
               for c in (False, True)}
FLASH_SHAPE = (1, 128, 2, 64)          # S per rank


def inputs(name, shape, count=4):
    """``count`` float32 standard-normal arrays of ``shape``, seeded by
    the case's name: q, k, v and the loss's weights."""
    rng = np.random.default_rng(sum(map(ord, name)) * 7919 + len(shape))
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def flash_shape(world):
    b, s, h, d = FLASH_SHAPE
    return (b, s * world, h, d)


def _chunk(x, me, n, dim=1):
    return torch.from_numpy(x).chunk(n, dim)[me].contiguous()


def _leaves(arrays, me, n):
    return [_chunk(a, me, n).requires_grad_(True) for a in arrays]


def _save(out, name, rank, **arrays):
    np.savez(os.path.join(out, f"{name}.{rank}.npz"),
             **{k: (v.detach().numpy() if torch.is_tensor(v) else v)
                for k, v in arrays.items()})


def _grads_of(o_local, w_local, leaves):
    """``(sum(o * w))`` differentiated into the local q, k, v chunks."""
    (o_local * w_local).sum().backward()
    return {"dq": leaves[0].grad, "dk": leaves[1].grad,
            "dv": leaves[2].grad}


def run(world, out):
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, Shard

    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.distributed import (
        HybridMesh, all_to_all, init_parallel_env, ring_attention,
        send_recv, shard_sequence, sp_attention)
    from paddle_tpu_torch.distributed import sequence_parallel as sp

    init_parallel_env(device="cpu")
    me = torch.distributed.get_rank()
    mesh = HybridMesh(sp=world, device_type="cpu")
    group = mesh.group("sp")

    # sp_attention on sequence-sharded DTensors, ring and Ulysses
    for name, (mode, causal, shape) in SP_CASES.items():
        q, k, v, w = inputs(name, shape)
        leaves = _leaves((q, k, v), me, world)
        dts = [DTensor.from_local(t, mesh.mesh, [Shard(1)], run_check=False)
               for t in leaves]
        o = sp_attention(mesh, *dts, causal=causal, mode=mode)
        placed = o.placements == (Shard(1),)
        o_local = o.to_local()
        _save(out, name, me, o=o_local, placed=placed,
              **_grads_of(o_local, _chunk(w, me, world), leaves))

    # kernel-shaped ring: every pair through B4's entry, counted
    calls = {"n": 0}
    real = kernels.flash_attention_with_lse

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    kernels.flash_attention_with_lse = counted
    for name, causal in FLASH_CASES.items():
        calls["n"] = 0
        q, k, v, w = inputs(name, flash_shape(world))
        leaves = _leaves((q, k, v), me, world)
        o = ring_attention(*leaves, group=group, causal=causal)
        forward_calls = calls["n"]
        _save(out, name, me, o=o, b4_calls=forward_calls,
              **_grads_of(o, _chunk(w, me, world), leaves))
    kernels.flash_attention_with_lse = real

    # Ulysses refuses a head count the sp degree does not divide
    q = torch.zeros((1, 8, world + 1, 4))
    try:
        sp.ulysses_attention(q, q, q, group=group)
        refusal = ""
    except ValueError as exc:
        refusal = str(exc)
    _save(out, "ulysses_refusal", me, message=np.array(refusal))

    # a mesh without sp composes; shard_sequence places on sp
    q, k, v, _ = inputs("serial", (2, 16, 2, 8))
    flat = HybridMesh(dp=world, device_type="cpu")
    o = sp_attention(flat, *(torch.from_numpy(x) for x in (q, k, v)),
                     causal=True)
    sharded = shard_sequence(mesh, torch.from_numpy(q))
    _save(out, "serial", me, o=o, axes=np.array(flat.axis_names),
          shard=sharded.to_local(),
          shard_placed=sharded.placements == (Shard(1),))

    # send_recv: only rank 1 receives (from 0); the cotangent goes back
    x = torch.full((3,), float(me + 1), requires_grad=True)
    y = send_recv(x, [(0, 1)], group=group)
    (y * (me + 1)).sum().backward()
    # all_to_all: x[j] = 10 * me + j arrives as slot me of rank j
    a = (10.0 * me + torch.arange(world, dtype=torch.float32))[:, None]
    a = a.expand(world, 2).clone().requires_grad_(True)
    b = all_to_all(a, group=group)
    (b * torch.arange(1, world + 1, dtype=torch.float32)[:, None]).sum() \
        .backward()
    _save(out, "collectives", me, y=y, dx=x.grad, b=b, da=a.grad)

    if world == 4:
        # dp x sp: two rings of two, one batch row each
        q, k, v, w = inputs("dp_sp", (2, 64, 2, 16))
        mixed = HybridMesh(dp=2, sp=2, device_type="cpu")
        dp_i, sp_i = me // 2, me % 2
        leaves = [torch.from_numpy(x)[dp_i:dp_i + 1].chunk(2, 1)[sp_i]
                  .contiguous().requires_grad_(True) for x in (q, k, v)]
        dts = [DTensor.from_local(t, mixed.mesh, [Shard(0), Shard(1)],
                                  run_check=False) for t in leaves]
        o = sp_attention(mixed, *dts, causal=True).to_local()
        w_local = torch.from_numpy(w)[dp_i:dp_i + 1].chunk(2, 1)[sp_i]
        _save(out, "dp_sp", me, o=o, **_grads_of(o, w_local, leaves))

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
