"""Hybrid-parallel topology over a `torch.distributed` device mesh.

Counterpart: ``paddle_tpu/distributed/topology.py:30-158``. The
reference's topology is a ``jax.sharding.Mesh`` whose named axes stand
for communicators; here it is a
`torch.distributed.device_mesh.DeviceMesh` over the processes of the
world (one process a rank, `collective.init_parallel_env`), with one
process group per axis (`HybridMesh.group`). The degree bookkeeping, the
axis names and their order are the reference's: ``pp`` and ``dp``
outermost, ``mp`` innermost; only axes of degree > 1 are in the mesh, and
a degree-1 axis still answers `HybridMesh.degree` and
`HybridMesh.has_axis`.

The reference's sharding constructors (``spec``, ``sharding``,
``replicated``, ``batch_sharding``) and its mesh context manager belong
to the rest of ROADMAP A12 (the DTensor train step); the sequence-
parallel path needs only the mesh and its ``sp`` group.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# canonical axis names, outermost -> innermost (the reference's)
DP_AXIS = "dp"            # data parallel (batch)
PP_AXIS = "pp"            # pipeline stages
SHARD_AXIS = "sharding"   # ZeRO-style optimizer/param sharding
MP_AXIS = "mp"            # tensor (model) parallel
SP_AXIS = "sp"            # sequence/context parallel
EP_AXIS = "ep"            # expert parallel


@dataclass
class HybridParallelConfig:
    """Degrees of each parallel axis (fleet ``hybrid_configs``)."""

    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sp_degree: int = 1
    ep_degree: int = 1

    def world_size(self) -> int:
        return (self.dp_degree * self.mp_degree * self.pp_degree *
                self.sharding_degree * self.sp_degree * self.ep_degree)


class HybridMesh:
    """The topology: a `DeviceMesh` with named axes plus the degrees.

    ``devices``: the global ranks the mesh spans, in mesh order (default:
    ranks ``0 .. world - 1`` of the initialised world; the first
    ``config.world_size()`` are taken, as the reference takes its first
    devices). ``device_type``: ``"cuda"`` (default; NCCL) or ``"cpu"``
    (gloo). Every rank of the world builds the mesh together, as
    `torch.distributed.new_group` requires. A serial config (no degree
    above 1) gets a one-rank ``dp`` mesh, as in the reference.
    """

    def __init__(self, config: HybridParallelConfig | None = None,
                 devices=None, device_type: str = "cuda", **degrees):
        if config is None:
            config = HybridParallelConfig(**{f"{k}_degree": v
                                             for k, v in degrees.items()})
        if not dist.is_initialized():
            raise RuntimeError(
                "HybridMesh needs torch.distributed initialised: call "
                "paddle_tpu_torch.distributed.init_parallel_env() in every "
                "rank first")
        self.config = config
        if devices is None:
            devices = list(range(dist.get_world_size()))
        world = config.world_size()
        if world > len(devices):
            raise ValueError(
                f"hybrid config needs {world} ranks, have {len(devices)}")
        order = [(PP_AXIS, config.pp_degree),
                 (DP_AXIS, config.dp_degree),
                 (SHARD_AXIS, config.sharding_degree),
                 (EP_AXIS, config.ep_degree),
                 (SP_AXIS, config.sp_degree),
                 (MP_AXIS, config.mp_degree)]
        self.degrees = dict(order)
        mesh_axes = [(n, d) for n, d in order if d > 1] or [(DP_AXIS, 1)]
        ranks = torch.tensor(list(devices)[:world], dtype=torch.int64)
        self.mesh = DeviceMesh(
            device_type, ranks.reshape([d for _, d in mesh_axes]),
            mesh_dim_names=tuple(n for n, _ in mesh_axes))

    # -- fleet-style queries ------------------------------------------------
    @property
    def axis_names(self):
        return tuple(self.mesh.mesh_dim_names)

    def degree(self, axis: str) -> int:
        return self.degrees.get(axis, 1)

    def has_axis(self, axis: str) -> bool:
        return axis in self.mesh.mesh_dim_names

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank: the
        communicator the reference names by the axis."""
        if not self.has_axis(axis):
            raise ValueError(f"axis {axis!r} is not in the mesh (degree "
                             f"{self.degree(axis)}; mesh axes "
                             f"{self.axis_names})")
        return self.mesh.get_group(axis)

    def get_data_parallel_world_size(self):
        return self.degree(DP_AXIS) * self.degree(SHARD_AXIS)

    def get_model_parallel_world_size(self):
        return self.degree(MP_AXIS)

    def get_pipe_parallel_world_size(self):
        return self.degree(PP_AXIS)

    def __repr__(self):
        deg = {k: v for k, v in self.degrees.items() if v > 1}
        return (f"HybridMesh({deg or '{serial}'}, "
                f"devices={self.mesh.mesh.numel()})")


def auto_hybrid(n_devices: int, mp_max: int = 8) -> HybridParallelConfig:
    """A dp x mp split of ``n_devices``: the largest mp <= ``mp_max``
    that divides the device count (tensor parallel innermost)."""
    mp = max(d for d in range(1, mp_max + 1) if n_devices % d == 0)
    return HybridParallelConfig(dp_degree=n_devices // mp, mp_degree=mp)


__all__ = ["DP_AXIS", "PP_AXIS", "SHARD_AXIS", "MP_AXIS", "SP_AXIS",
           "EP_AXIS", "HybridParallelConfig", "HybridMesh", "auto_hybrid"]
