"""`paddle.incubate.distributed` of the port: the MoE layer and its
gates (`models.moe`), on one card."""
from . import models

__all__ = ["models"]
