"""Distributed training pieces of the port: `SpmdTrainStep` and
`gpt_loss_fn` on one device (`spmd`); the process bootstrap (`spawn`),
the mesh (`topology`), the collectives of the sequence-parallel path
(`collective`) and ring / Ulysses attention (`sequence_parallel`) over
`torch.distributed`, one process a rank."""
from .collective import (
    all_to_all, barrier, get_group, get_rank, get_world_size,
    init_parallel_env, new_group, send_recv,
)
from .sequence_parallel import (
    ring_attention, shard_sequence, sp_attention, ulysses_attention,
)
from .spawn import ParallelEnv, ParallelMode, spawn
from .spmd import SpmdTrainStep, gpt_loss_fn
from .topology import (
    DP_AXIS, EP_AXIS, MP_AXIS, PP_AXIS, SHARD_AXIS, SP_AXIS, HybridMesh,
    HybridParallelConfig, auto_hybrid,
)

__all__ = ["SpmdTrainStep", "gpt_loss_fn",
           "DP_AXIS", "EP_AXIS", "MP_AXIS", "PP_AXIS", "SHARD_AXIS",
           "SP_AXIS", "HybridMesh", "HybridParallelConfig", "auto_hybrid",
           "ring_attention", "shard_sequence", "sp_attention",
           "ulysses_attention",
           "all_to_all", "barrier", "get_group", "get_rank",
           "get_world_size", "init_parallel_env", "new_group", "send_recv",
           "spawn", "ParallelEnv", "ParallelMode"]
