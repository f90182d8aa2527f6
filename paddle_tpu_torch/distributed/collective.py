"""The collectives the sequence-parallel path uses, over `torch.distributed`.

Counterpart: ``paddle_tpu/distributed/collective.py``. The reference runs
one controller over every device, a group is a mesh axis, and each
collective is an XLA collective inside ``shard_map``. Here, as in
PyTorch, each rank is a process: `init_parallel_env` joins the world
(NCCL on ``cuda:LOCAL_RANK`` by default, gloo when the caller asks for
the CPU), a group is a `torch.distributed` process group, and a
collective takes and returns this rank's own tensor.

`send_recv` (``:269``, ``ppermute``) and `all_to_all` (``:240``) are
differentiable: the backward of a permutation sends the cotangent along
the inverse permutation, and the backward of the all-to-all is the same
all-to-all. Every rank of the group must call each collective in the
same order, and so must every backward: the ring keeps every shift on
the path from the loss (`sequence_parallel.ring_attention`).

The reference file's other collectives (all_reduce, all_gather,
reduce_scatter, broadcast, reduce, scatter, all_gather_object, split)
belong to the rest of ROADMAP A12.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def _env_int(*names, default):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def init_parallel_env(device=None):
    """Join the world of ranks and return its group.

    Reads the launch contract `spawn` sets (``RANK``/``PADDLE_TRAINER_ID``,
    ``WORLD_SIZE``/``PADDLE_TRAINERS_NUM``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``). The rendezvous store lives at
    ``MASTER_ADDR:MASTER_PORT``: `spawn`'s parent holds it
    (``PADDLE_MASTER`` set), otherwise rank 0 opens it. ``device``: None
    runs on ``cuda:LOCAL_RANK`` over NCCL (and raises without a GPU);
    ``"cpu"`` runs over gloo. Calling it again returns the same group."""
    if dist.is_initialized():
        return dist.group.WORLD
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0)
    world = _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)
    local = _env_int("LOCAL_RANK", "PADDLE_LOCAL_RANK", default=rank)
    if device is None:
        resolve_device(None)                  # raises without a GPU
        dev = torch.device("cuda", local)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_parallel_env: no backend for {dev}")
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        raise RuntimeError("init_parallel_env: MASTER_PORT is not set (run "
                           "the ranks through spawn, or set the launch "
                           "environment)")
    hosted = bool(os.environ.get("PADDLE_MASTER"))
    store = dist.TCPStore(addr, int(port), world,
                          is_master=(rank == 0 and not hosted),
                          wait_for_workers=False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return dist.group.WORLD


def get_group(group=None):
    """``group``, or the world's group when None."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_parallel_env() "
                           "first")
    return dist.group.WORLD


def get_rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a world)."""
    if group is None and not dist.is_initialized():
        return 0
    return dist.get_rank(get_group(group))


def get_world_size(group=None) -> int:
    """The number of ranks in ``group`` (1 without a world)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(get_group(group))


def new_group(ranks=None, backend=None):
    """A process group of the global ``ranks`` (default: all). Every
    rank of the world calls it, as `torch.distributed.new_group` needs."""
    return dist.new_group(ranks=ranks, backend=backend)


def barrier(group=None):
    """Wait until every rank of ``group`` reaches it."""
    if get_world_size(group) > 1:
        dist.barrier(group=get_group(group))


def _permute(x, perm, group):
    """One batched P2P round of ``perm`` (``[(src, dst), ...]`` group
    ranks): this rank sends ``x`` to its ``dst`` and receives from its
    ``src``; a rank that receives nothing gets zeros (``ppermute``)."""
    me = get_rank(group)
    g = get_group(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    x = x.contiguous()
    if dst == [me]:
        return x.clone()
    out = torch.zeros_like(x)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(g, dst[0]),
                              g))
    if src:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(g, src[0]), g))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _SendRecv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None


def send_recv(tensor, perm, group=None):
    """Point-to-point permutation, differentiable: ``perm`` is ``[(src,
    dst), ...]`` pairs of ranks in ``group`` (each rank at most once as a
    source and once as a destination); a rank that receives nothing gets
    zeros. Every rank of the group calls it with the same ``perm``; the
    backward sends the cotangent along the inverse permutation."""
    perm = [(int(s), int(d)) for s, d in perm]
    return _SendRecv.apply(tensor, perm, group)


def _all_to_all(x, group):
    if get_world_size(group) == 1:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=get_group(group))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(tensor, group=None):
    """Rank i's j-th chunk goes to rank j's i-th slot: ``tensor`` is
    ``[world, ...]`` on every rank, and so is the result (``ProcessGroup::
    AllToAll``). Differentiable: the backward is the same exchange."""
    n = get_world_size(group)
    if tensor.shape[0] != n:
        raise ValueError(f"all_to_all: the leading dim ({tensor.shape[0]}) "
                         f"must equal the group's size ({n})")
    return _AllToAll.apply(tensor, group)


__all__ = ["init_parallel_env", "get_group", "get_rank", "get_world_size",
           "new_group", "barrier", "send_recv", "all_to_all"]
