"""Models of `incubate.distributed`: the MoE layer (`moe`)."""
from . import moe

__all__ = ["moe"]
