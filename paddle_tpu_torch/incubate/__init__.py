"""`paddle.incubate` of the port: the fused transformer layers and
functionals (`incubate.nn`).

Counterpart: ``paddle_tpu/incubate/``. Only ``incubate.nn``'s training
layers are ported; the MoE layers, the LookAhead/ModelAverage optimizers,
the graph and segment ops and ``FusedMultiTransformer`` (serving) are
later slices (ROADMAP A13, A14)."""
from . import nn

__all__ = ["nn"]
