"""`paddle.incubate` of the port: the fused transformer layers and
functionals (`incubate.nn`) and the MoE layer on one card
(`incubate.distributed.models.moe`).

Counterpart: ``paddle_tpu/incubate/``. The LookAhead/ModelAverage
optimizers and the graph and segment ops are later slices (ROADMAP
A14)."""
from . import distributed, nn

__all__ = ["distributed", "nn"]
